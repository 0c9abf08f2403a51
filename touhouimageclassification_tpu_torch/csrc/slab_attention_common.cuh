// Helpers shared by the attention kernels (slab_attention_fwd.cu: K1, K3's
// forward and K4; slab_attention_bwd.cu: K2 and K3's backward): element pairs,
// warp reductions and the padded shared-memory row pitch of the f32 SIMT
// route (its kernels are templates on the element type, instantiated for
// float only); cp.async staging, ldmatrix, mma.sync and the fragment layouts
// of the bf16 tensor-core route (namespace tic::mma). The patch embedding
// (patch_embed.cu, K5) gathers its image tiles with the cp.async helpers, the
// slab null copy (slab_null_copy.cu, S6) its row tiles, the attention tiles
// of the studies S1, S3 and S4 (slab_attention_tile.cu) their K_h and V_h
// (stage_heads_async) and row statistics (cp_async4). Peel names the
// cumulative peels of the bf16 attention kernels that the roofline study
// (S5) times.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace tic {

constexpr int kBlockRows = 64;  // rows of N one block takes
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// How much of a bf16 attention kernel runs (a template argument of the
// tensor-core kernels; kFull, the shipped kernel, is the default). Each level
// keeps the grid, the staging and the stores of the one above and drops one
// part of the work:
// - kDma: the staging (cp.async) and the strip loads into A fragments, then
//   the stores; every output is one of the inputs, as it came;
// - kLayout: kDma plus every ldmatrix / ldmatrix.trans fragment load of the
//   staged operands that the sweeps make (the forward only);
// - kMatmul: kLayout plus every product; the softmax gives way to
//   P = S * scale / N (and dS = dP / N): no max, exp2, sum or rescale;
// - kFull: the kernel as the model runs it.
// Values no output reads (the fragments of kLayout, the products of a sweep
// that only fed the softmax) are folded into one word that the kernel stores
// under a runtime flag its entry point leaves off, so none of the work is dead
// code.
enum class Peel : int { kDma = 0, kLayout = 1, kMatmul = 2, kFull = 3 };

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }

template <typename T>
__device__ __forceinline__ typename Pair<T>::type from_floats(float a, float b);
template <>
__device__ __forceinline__ float2 from_floats<float>(float a, float b) {
  return make_float2(a, b);
}

// Rounds an f32 value to the input type and back (round to nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row pitch of a head row staged in shared memory. D + 2 makes the pitch an
// odd number of pairs, so 32 lanes reading pairs of 32 different rows hit 32
// different banks.
template <int D>
constexpr int kStride = D + 2;

// Stages columns `col` ... col + D of `rows` rows, `ld` elements apart, into
// shared memory at pitch kStride<D>, in element pairs, with every thread of
// the block.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows,
                                           size_t ld) {
  using T2 = typename Pair<T>::type;
  constexpr int kPairs = D / 2;
  for (int i = threadIdx.x; i < rows * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int p = i - r * kPairs;
    *reinterpret_cast<T2*>(dst + r * kStride<D> + 2 * p) =
        *reinterpret_cast<const T2*>(src + r * ld + 2 * p);
  }
}

// Loads one head row of D elements (pairs, broadcast to every lane) as f32.
template <typename T, int D>
__device__ __forceinline__ void load_row(float (&x)[D], const T* src) {
  using T2 = typename Pair<T>::type;
  const T2* row = reinterpret_cast<const T2*>(src);
#pragma unroll
  for (int p = 0; p < D / 2; ++p) {
    const float2 v = to_float2(row[p]);
    x[2 * p] = v.x;
    x[2 * p + 1] = v.y;
  }
}

// x . y for a register row x and a shared-memory row y, as one f32 FMA chain
// in element order (so a pass that holds y in registers and reads x from
// shared memory gets the same bits).
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float (&x)[D], const T* y) {
  using T2 = typename Pair<T>::type;
  const T2* row = reinterpret_cast<const T2*>(y);
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < D / 2; ++p) {
    const float2 v = to_float2(row[p]);
    s = fmaf(x[2 * p], v.x, s);
    s = fmaf(x[2 * p + 1], v.y, s);
  }
  return s;
}

// --- the bf16 route: mma.sync m16n8k16 on the tensor cores ------------------
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for
// lane = 4 * g + t (g = lane / 4 the group, t = lane % 4 its place in the quad):
// - A (16 x 16, row-major), four 32-bit registers of bf16 pairs: a0 = (row g,
//   cols 2t, 2t+1), a1 = (row g+8, same cols), a2 = (row g, cols 2t+8, 2t+9),
//   a3 = (row g+8, cols 2t+8, 2t+9);
// - B (16 x 8, "col": each of the 8 columns contiguous along k), two
//   registers: b0 = (k 2t, 2t+1 of column g), b1 = (k 2t+8, 2t+9 of column g);
// - C (16 x 8, f32), four floats: c0, c1 = (row g, cols 2t, 2t+1), c2, c3 =
//   (row g+8, cols 2t, 2t+1).
// Two C tiles side by side (cols 0-7 and 8-15) rounded to bf16 pairs are
// exactly an A fragment (a0 = C0[0..1], a1 = C0[2..3], a2 = C1[0..1], a3 =
// C1[2..3]), so P and dS go from one product to the next in registers.
// A row of a 16-row strip lives on the four lanes of a quad: a row reduction
// is two shfl_xor (1 and 2).
namespace mma {

constexpr int kRows = 16;  // rows of a warp's strip (the m of m16n8k16)

// Shared-memory row pitch, in elements, of a staged head row: D + 8 makes it
// an odd number of 16-byte chunks mod 8 (D 32, 64, 128: 5, 9, 17 chunks), so
// the eight row addresses of an ldmatrix 8x8 read fall on eight different
// groups of four banks, free of conflicts.
template <int D>
constexpr int kPitch = D + 8;

// Rows staged for N keys or queries: N rounded up to whole 16-row chunks (the
// rows past N are zero-filled), and at least 64, so that the block's output
// strips (up to 4 warps x 16 rows) can be staged in the same memory.
__host__ __device__ inline int staged_rows(int n) {
  const int r = (n + kRows - 1) / kRows * kRows;
  return r < 64 ? 64 : r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; fills zeros where !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4-byte asynchronous copy global -> shared (through L1); zero where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages D columns of `n` rows, `ld` elements apart, into `rows` shared rows at
// pitch kPitch<D> with 16-byte cp.async copies by the whole block (`threads`
// of them); rows at or past n are zeros. Commits nothing.
template <int D>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int n, int rows, size_t ld, int threads) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += threads) {
    const int r = i / kChunks;
    const int ch = i - r * kChunks;
    const bool valid = r < n;
    cp_async16(dst + r * kPitch<D> + 8 * ch, src + (valid ? r * ld + 8 * ch : 0), valid);
  }
}

// stage_async for `heads` adjacent heads at once: one pass over the row
// segment of heads * D elements (16-byte chunk c of a row to head c / (D / 8)),
// head j to the `rows` rows at dst + j * rows * kPitch<D>. With heads 1 it
// copies what stage_async copies, to the same places.
template <int D>
__device__ __forceinline__ void stage_heads_async(__nv_bfloat16* dst,
                                                  const __nv_bfloat16* src, int n, int rows,
                                                  size_t ld, int heads, int threads) {
  constexpr int kChunks = D / 8;
  const int chunks = heads * kChunks;
  for (int i = threadIdx.x; i < rows * chunks; i += threads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int head = c / kChunks;
    const bool valid = r < n;
    cp_async16(dst + (static_cast<size_t>(head) * rows + r) * kPitch<D> + 8 * (c - head * kChunks),
               src + (valid ? r * ld + 8 * c : 0), valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores, bf16 in, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A fragments of a warp's 16-row strip of a head operand, read straight from
// device memory: rows row0 ... row0 + 15 (`ld` elements apart, zeros at or
// past n), D columns as D / 16 k-steps.
template <int D>
__device__ __forceinline__ void load_a_strip(unsigned (&a)[D / 16][4],
                                             const __nv_bfloat16* src, int row0, int n,
                                             size_t ld, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = 16 * ks + 2 * t;
    a[ks][0] = r0 < n ? *reinterpret_cast<const unsigned*>(src + r0 * ld + c) : 0u;
    a[ks][1] = r1 < n ? *reinterpret_cast<const unsigned*>(src + r1 * ld + c) : 0u;
    a[ks][2] = r0 < n ? *reinterpret_cast<const unsigned*>(src + r0 * ld + c + 8) : 0u;
    a[ks][3] = r1 < n ? *reinterpret_cast<const unsigned*>(src + r1 * ld + c + 8) : 0u;
  }
}

// acc (16 x 16, two C tiles) = A (16 x D strip in registers) times the
// transpose of the 16 staged rows j0 ... j0 + 15 (D columns each): the rows are
// the B operand's columns (S = Q K^T with K rows, dP = g V^T with V rows).
template <int D>
__device__ __forceinline__ void strip_times_rows_t(float (&acc)[2][4],
                                                   const unsigned (&a)[D / 16][4],
                                                   const __nv_bfloat16* rows, int j0,
                                                   int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // matrices: (rows j0..+7, k 0..7), (j0..+7, k 8..15), (j0+8.., k 0..7),
  // (j0+8.., k 8..15) of the k-step
  const __nv_bfloat16* base =
      rows + (j0 + (lane & 7) + ((lane >> 4) << 3)) * kPitch<D> + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    unsigned b[4];
    ldmatrix_x4(b, base + 16 * ks);
    mma_bf16(acc[0], a[ks], b[0], b[1]);
    mma_bf16(acc[1], a[ks], b[2], b[3]);
  }
}

// out (16 x D, D / 8 C tiles) += A (16 x 16 in registers) times the 16 staged
// rows j0 ... j0 + 15 as they are (O += P V, dQ += dS K, dV += P^T g, ...).
template <int D>
__device__ __forceinline__ void accumulate_rows(float (&out)[D / 8][4],
                                                const unsigned (&a)[4],
                                                const __nv_bfloat16* rows, int j0,
                                                int lane) {
  // matrices, transposed: (rows j0..+7, cols c..c+7), (j0+8.., c..), (j0..,
  // c+8..), (j0+8.., c+8..) for each 16 columns c
  const __nv_bfloat16* base =
      rows + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch<D> + (lane >> 4) * 8;
#pragma unroll
  for (int cs = 0; cs < D / 16; ++cs) {
    unsigned b[4];
    ldmatrix_x4_trans(b, base + 16 * cs);
    mma_bf16(out[2 * cs], a, b[0], b[1]);
    mma_bf16(out[2 * cs + 1], a, b[2], b[3]);
  }
}

// Writes scale * acc, a warp's 16 x D strip, to rows row0 ... of dst (`ld`
// elements apart, only rows < n) through the warp's own 16 rows of shared
// memory at `stage` (pitch kPitch<D>), as 16-byte stores.
template <int D>
__device__ __forceinline__ void store_strip(__nv_bfloat16* dst, size_t ld, int row0, int n,
                                            const float (&acc)[D / 8][4], float scale,
                                            __nv_bfloat16* stage, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<unsigned*>(stage + g * kPitch<D> + 8 * j + 2 * t) =
        pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * kPitch<D> + 8 * j + 2 * t) =
        pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int i = lane; i < kRows * kChunks; i += 32) {
    const int r = i / kChunks;
    const int ch = i - r * kChunks;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ld + 8 * ch) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch<D> + 8 * ch);
  }
  __syncwarp();
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scales a 16 x 16 score tile (two C tiles, columns j0 ... j0 + 15) by
// `scale` (D^-1/2, times log2(e) for exp2), the multiply kept out of FMA contraction (both backward passes
// then round it alike), and sets columns at or past n to -inf.
__device__ __forceinline__ void scale_and_mask(float (&s)[2][4], float scale, int j0,
                                               int n, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j0 + 8 * j + 2 * (lane % 4) + (e & 1);
      s[j][e] = col < n ? __fmul_rn(s[j][e], scale) : -INFINITY;
    }
}

// exp2(x) (kExp2, scores scaled by log2(e) beforehand) or exp(x).
template <bool kExp2>
__device__ __forceinline__ float exp_base(float x) {
  return kExp2 ? exp2f(x) : expf(x);
}

// exp_base(x - m) with m a running max that may still be -inf (no finite
// value seen yet): then every x is -inf too and the result is 0, not NaN.
template <bool kExp2>
__device__ __forceinline__ float exp_below(float x, float m) {
  return exp_base<kExp2>(x - (m == -INFINITY ? 0.f : m));
}

// --- the peels (Peel) --------------------------------------------------------

// The ldmatrix loads of strip_times_rows_t<D>(.., rows, j0, ..) without the
// products, folded into one word. The address is a copy of that function's:
// taking both from one helper changed ptxas's register allocation of the
// backward kernels (K2's passes 118 -> 120 and 164 -> 165 registers).
template <int D>
__device__ __forceinline__ unsigned rows_t_fragments(const __nv_bfloat16* rows, int j0,
                                                     int lane) {
  const __nv_bfloat16* base =
      rows + (j0 + (lane & 7) + ((lane >> 4) << 3)) * kPitch<D> + ((lane >> 3) & 1) * 8;
  unsigned fold = 0;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    unsigned b[4];
    ldmatrix_x4(b, base + 16 * ks);
    fold ^= b[0] ^ b[1] ^ b[2] ^ b[3];
  }
  return fold;
}

// The ldmatrix.trans loads of accumulate_rows<D>(.., rows, j0, ..) without the
// products, folded into one word (the address copied likewise).
template <int D>
__device__ __forceinline__ unsigned rows_fragments(const __nv_bfloat16* rows, int j0,
                                                   int lane) {
  const __nv_bfloat16* base =
      rows + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch<D> + (lane >> 4) * 8;
  unsigned fold = 0;
#pragma unroll
  for (int cs = 0; cs < D / 16; ++cs) {
    unsigned b[4];
    ldmatrix_x4_trans(b, base + 16 * cs);
    fold ^= b[0] ^ b[1] ^ b[2] ^ b[3];
  }
  return fold;
}

// A 16 x 16 tile (two C tiles) folded into one word.
__device__ __forceinline__ unsigned fold_tile(const float (&s)[2][4]) {
  unsigned fold = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fold ^= __float_as_uint(s[j][e]);
  return fold;
}

// A warp's 16 x D strip of A fragments (as load_a_strip leaves it) folded into
// one word.
template <int D>
__device__ __forceinline__ unsigned fold_strip(const unsigned (&a)[D / 16][4]) {
  unsigned fold = 0;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) fold ^= a[ks][0] ^ a[ks][1] ^ a[ks][2] ^ a[ks][3];
  return fold;
}

// The A fragments of a 16 x D strip as f32 C tiles (D / 8 of them), each value
// exactly the bf16 it was: store_strip with scale 1 then writes the strip back
// bit for bit.
template <int D>
__device__ __forceinline__ void strip_as_tiles(float (&out)[D / 8][4],
                                               const unsigned (&a)[D / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns 16ks + 2t (a0, a1), + 8 (a2, a3)
      const unsigned top = a[ks][2 * h], bottom = a[ks][2 * h + 1];
      out[2 * ks + h][0] = __uint_as_float(top << 16);
      out[2 * ks + h][1] = __uint_as_float(top & 0xffff0000u);
      out[2 * ks + h][2] = __uint_as_float(bottom << 16);
      out[2 * ks + h][3] = __uint_as_float(bottom & 0xffff0000u);
    }
}

// A 16 x 16 tile of f32 values times `scale`, then times `inv_n`, rounded to
// bf16 pairs as an A fragment (the peels' stand-in for the softmax: P = S *
// scale / N, dS = dP / N with scale 1).
__device__ __forceinline__ void scaled_fragment(unsigned (&a)[4], const float (&s)[2][4],
                                                float scale, float inv_n) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a[2 * j + r] = pack_bf16(__fmul_rn(__fmul_rn(s[j][2 * r], scale), inv_n),
                               __fmul_rn(__fmul_rn(s[j][2 * r + 1], scale), inv_n));
}

}  // namespace mma

}  // namespace tic
