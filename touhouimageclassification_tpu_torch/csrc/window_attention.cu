// SwinV2's window attention, forward and backward (W1), for Hopper (sm_90a),
// bound to Python with ctypes (ops/window_attention.py).
//
// It replaces no Pallas kernel: the JAX package has no SwinV2. It replaces
// the port's first form of the op, torch passes that normalised q and k and
// then SDPA's memory-efficient kernel (sm80 CUTLASS, 64 x 64 tiles at D 32),
// whose backward wrote the bias gradient once per image before a sum over
// the images.
//
// What it computes, per window row r of the (B nW, N, 3C) slab (q | k | v,
// head h at columns h D of each third), head h, query i and key j:
//   z_ij = s_h <q_i / |q_i|, k_j / |k_j|> + bias[r % nW', h, i, j],
//   s_h = exp(min(tau_h, ln 100)),   out_i = sum_j softmax_j(z_ij) v_j,
// with nW' the bias's windows (1, or nW for a shifted block); and in the
// backward the slab's gradient (dq, dk, dv in the slab's own columns), the
// bias's gradient summed over the rows that share it, and dtau_h.
//
// What bounds it: at N 576 and D 32 each score takes 4 D = 128 FLOPs in the
// forward and 10 D in the backward against a few bytes of bias, so the
// products bound it (benchmark/roofline_swin.py: 7.28 ms a SwinV2-L b64
// step). At D 32 the exponentials come close behind: one ex2 a score in the
// forward and one in each backward pass that recomputes the scores, at 16 a
// clock an SM (about 4.2 T/s on 132 SMs), against 4 D / 16 = 8 FLOPs of
// tensor-core work an ex2 would need to keep pace at full rate.
//
// What it reaches (H100, SwinV2-L b64, forward + backward): 9% of that
// bound at stage 1's and stage 3's shapes, 2.6-2.7x faster than the
// normalisation and SDPA it replaces (PERF.md, W1). Each pass runs about as
// many scores a second as FlashAttention-2's mma.sync kernels; at D 32 its
// time goes to the elementwise softmax and logit work (some eight
// operations a score), not to the products.
//
// The design:
// - bf16 mma.sync m16n8k16 with f32 sums; a block is 4 warps and a tile of
//   64 rows (16 a warp), K and V (or Q and dO) tiles of 64 rows and the
//   matching 64 x 64 bias tile staged with cp.async into shared memory at
//   pitches that keep ldmatrix free of bank conflicts (the bias fragments
//   too are read with ldmatrix), the next tiles' copies in flight while the
//   current ones are used, one barrier a tile; each thread's copy offsets
//   and ldmatrix row addresses are fixed shared byte offsets and 32-bit
//   element offsets, so a tile's staging and fragment reads take few
//   address instructions;
// - q, k and v are read from the slab in place (strided rows, no head
//   copies) and multiplied as they are, bf16 products summed in f32; the
//   cosine normalisation is applied to the f32 scores: a first small kernel
//   writes each q and k head row's 1 / max(|x|, eps) in f32 (rows, 2, H, N),
//   and z_ij = S_ij (s_h inv_q_i) inv_k_j + bias_ij, the softmax taking
//   exp2(z log2(e) - m); masked pairs carry -inf in the staged bias tile. No
//   normalised vector is rounded to 16 bits: at the clamp's scale of 100 a
//   bf16 q^ and k^ moved the output by 4.7% of its largest entry;
// - the forward saves the inverse norms and each row's log-sum-exp (log2
//   domain) for the backward;
// - blocks that share a (window index, head) bias tile are adjacent in the
//   grid (the image, or the row of a one-window bias, is the fastest grid
//   dimension), so a bias tile comes from HBM about once a call and from L2
//   after that;
// - the backward is three passes and two small sums, all in a fixed order
//   with no float atomics, so a call gives the same bits every time:
//   (1) dq: a block owns 64 queries of one row and head and walks the key
//   tiles; it also sums D_i = sum_j P_ij dP_ij in f32 for the other passes
//   (its own dS takes D~ = <dO_i, O_i> from the bf16 output); (2) dk, dv: a
//   block owns 64 keys and walks the query tiles (scores transposed,
//   FlashAttention-2's layout); (3) dbias: a block owns one 64 x 64 tile of
//   a (window index, head) and walks the rows (images) of a group that
//   share that bias, summing dS and dS s_h cos (dtau's share) in registers;
//   with few such tiles (an unshifted block's one bias), the rows split
//   into groups whose f32 partials (4) a second kernel sums in group order
//   into the bias's dtype; (5) one block a head sums dtau's partials. dtau
//   needs the f32 D: at a scale near 100 P is peaked, and its sum of dS cos
//   is a small covariance that O's bf16 rounding in D~ moved by 7%;
// - dQ^ = sum_j dS_ij k_j inv_k_j and dK^ = sum_i dS_ij q_i inv_q_i take the
//   inverse norm into dS before its rounding to bf16, and the
//   normalisation's backward runs in the epilogues of (1) and (2): dx = m
//   (G - x^ <x^, G>), m = s_h inv_x, x^ = x inv_x in f32 from the slab,
//   written into the slab's gradient with dv;
// - D 16 and 32, any N up to 576 (the ragged last tile masked), a bias of
//   one window or one per window index; bf16 slab and bias, f32 tau.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows of a query or key tile
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = 32 * kWarps;
// Blocks an SM the backward passes are compiled for: four (128 registers a
// thread) ran them 14-16% faster than the 2-3 their free allocation allowed
// (at most 8 bytes a thread spilled).
constexpr int kBwdBlocks = 4;
constexpr int kMaxTokens = 576;
constexpr int kSumThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLogScaleMax = 4.605170185988092f;  // ln 100
constexpr float kNormEps2 = 1e-24f;                 // (1e-12)^2, F.normalize's eps

// Shared-memory row pitch of a staged head tile, in elements: D + 8 makes it
// an odd number of 16-byte chunks (3 at D 16, 5 at D 32), so the eight rows
// of an ldmatrix 8x8 read fall on different bank groups.
template <int D>
constexpr int kPitch = D + 8;
template <int D>
constexpr int kTileBytes = kTile * kPitch<D> * 2;
// A 64 x 64 bias tile's pitch: 72 elements, 144 bytes, likewise.
constexpr int kBiasPitch = kTile + 8;
constexpr int kBiasBytes = kTile * kBiasPitch * 2;
constexpr int kVecBytes = kTile * 4;  // 64 f32 values of a tile's rows

struct Dims {
  int n;        // tokens a window
  int heads;
  int windows;  // windows of the bias: 1 or nW
  int images;   // rows / windows: the rows that share one bias window
  int tiles;    // ceil(n / 64)
  int c;        // heads * D
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies global -> shared; zeros where !valid
// (the source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t dst, unsigned v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared2(uint32_t dst, unsigned short v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: m16n8k16, bf16 operands, f32 sums. Fragments, lane = 4 g + t:
// A a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols 2t+8, 2t+9),
// a3 (row g+8, cols 2t+8, 2t+9); B b0 (k 2t, 2t+1 of column g), b1 (k 2t+8,
// 2t+9); C c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float lo_of(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_of(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s_h = exp(min(tau_h, ln 100)).
__device__ __forceinline__ float head_scale(const float* tau, int h) {
  return expf(fminf(__ldg(tau + h), kLogScaleMax));
}

// A thread's share of staging 64-row tiles of one operand (D columns of rows
// `ld` elements apart) with 16-byte cp.async copies: chunk ch of rows rb + m
// kStep, at fixed shared offsets; a tile's offsets in the window fit 32
// bits (N 576 rows of 3 x 1536 elements).
template <int D>
struct TileCopy {
  static constexpr int kChunks = D / 8, kStep = kThreads / kChunks, kPer = kTile / kStep;
  uint32_t dst, off, step;
  int rb;
  __device__ __forceinline__ explicit TileCopy(int ld) {
    rb = threadIdx.x / kChunks;
    const int ch = threadIdx.x % kChunks;
    dst = (rb * kPitch<D> + 8 * ch) * 2;
    off = rb * ld + 8 * ch;
    step = kStep * ld;
  }
  // Rows t0 ... t0 + 63 of src (zeros at or past n) into the tile at
  // shared address `tile`. Commits nothing.
  __device__ __forceinline__ void operator()(uint32_t tile, const bf16* src, int t0, int n,
                                             int ld) const {
    const uint32_t o = t0 * ld + off;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const bool valid = t0 + rb + m * kStep < n;
      cp_async16(tile + dst + m * kStep * kPitch<D> * 2, src + (valid ? o + m * step : 0u),
                 valid);
    }
  }
};

// A thread's share of staging 64 x 64 tiles of an (n, n) bias: chunk ch of
// rows rb + 16 m, -inf wherever the query or the key is at or past n, so
// that the logits mask themselves; element by element where n is not a
// multiple of 8 (small windows only).
struct BiasCopy {
  static constexpr int kStep = kThreads / 8;
  uint32_t dst;
  int rb, ch;
  __device__ __forceinline__ BiasCopy() {
    rb = threadIdx.x / 8;
    ch = threadIdx.x % 8;
    dst = (rb * kBiasPitch + 8 * ch) * 2;
  }
  // The tile at queries q0 ... and keys k0 ... into shared address `tile`.
  __device__ __forceinline__ void operator()(uint32_t tile, const bf16* bias, int q0, int k0,
                                             int n) const {
    constexpr unsigned kMasked2 = 0xff80ff80u;  // two bf16 -inf
    if ((n & 7) == 0) {
      const uint32_t o = (q0 + rb) * n + k0 + 8 * ch;
      const bool col = k0 + 8 * ch < n;
#pragma unroll
      for (int m = 0; m < kTile / kStep; ++m) {
        const uint32_t d = tile + dst + m * kStep * kBiasPitch * 2;
        if (col && q0 + rb + m * kStep < n)
          cp_async16(d, bias + o + m * kStep * n, true);
        else
          st_shared16(d, kMasked2);
      }
    } else {
      for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
        const int r = i >> 6, cc = i & 63;
        const bool valid = q0 + r < n && k0 + cc < n;
        st_shared2(tile + (r * kBiasPitch + cc) * 2,
                   valid ? __bfloat16_as_ushort(bias[(q0 + r) * n + k0 + cc])
                         : static_cast<unsigned short>(kMasked2 & 0xffff));
      }
    }
  }
};

// Stages 64 f32 values src[t0 ...] (zeros at or past n) with the block's
// first 64 threads. Commits nothing.
__device__ __forceinline__ void stage_vec(uint32_t dst, const float* src, int t0, int n) {
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    cp_async4(dst + threadIdx.x * 4, src + (t < n ? t : 0), t < n);
  }
}

// Shared byte offsets of a lane's ldmatrix row addresses within a tile of
// `pitch` elements a row: the A strip of rows 0-15 (a_lane), the 64 rows
// read transposed as B columns (bt_lane: S = Q K^T), the 64 rows read as
// they are (b_lane: O += P V, by ldmatrix.trans).
__device__ __forceinline__ uint32_t a_lane(int lane, int pitch) {
  return ((lane & 15) * pitch + (lane >> 4) * 8) * 2;
}
__device__ __forceinline__ uint32_t bt_lane(int lane, int pitch) {
  return (((lane & 7) + ((lane >> 4) << 3)) * pitch + ((lane >> 3) & 1) * 8) * 2;
}
__device__ __forceinline__ uint32_t b_lane(int lane, int pitch) {
  return (((lane & 7) + ((lane >> 3) & 1) * 8) * pitch + (lane >> 4) * 8) * 2;
}

// A fragments of a warp's 16-row strip (D / 16 k-steps); addr: the strip's
// first row plus a_lane.
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[D / 16][4], uint32_t addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(a[ks], addr + 32 * ks);
}

// s (16 x 64: eight C tiles) = A (a warp's 16 x D strip) times the
// transpose of a tile's 64 rows: S = Q K^T, dP = dO V^T, S^T = K Q^T, ...;
// addr: the tile plus bt_lane.
template <int D>
__device__ __forceinline__ void times_rows_t(float (&s)[8][4], const unsigned (&a)[D / 16][4],
                                             uint32_t addr) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kp = 0; kp < 4; ++kp)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      unsigned b[4];
      ldsm_x4(b, addr + (16 * kp * kPitch<D> + 16 * ks) * 2);
      mma(s[2 * kp], a[ks], b[0], b[1]);
      mma(s[2 * kp + 1], a[ks], b[2], b[3]);
    }
}

// out (16 x D) += A (16 x 64, four k-steps in registers) times a tile's 64
// rows as they are: O += P V, dQ^ += dS' K, dV += P^T dO, dK^ += dS'^T Q;
// addr: the tile plus b_lane.
template <int D>
__device__ __forceinline__ void times_rows(float (&out)[D / 8][4], const unsigned (&a)[4][4],
                                           uint32_t addr) {
#pragma unroll
  for (int kp = 0; kp < 4; ++kp)
#pragma unroll
    for (int cs = 0; cs < D / 16; ++cs) {
      unsigned b[4];
      ldsm_x4_t(b, addr + (16 * kp * kPitch<D> + 16 * cs) * 2);
      mma(out[2 * cs], a[kp], b[0], b[1]);
      mma(out[2 * cs + 1], a[kp], b[2], b[3]);
    }
}

// Two C tiles side by side rounded to bf16 pairs are one A fragment.
__device__ __forceinline__ void to_a(unsigned (&a)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    a[kp][0] = pack(s[2 * kp][0], s[2 * kp][1]);
    a[kp][1] = pack(s[2 * kp][2], s[2 * kp][3]);
    a[kp][2] = pack(s[2 * kp + 1][0], s[2 * kp + 1][1]);
    a[kp][3] = pack(s[2 * kp + 1][2], s[2 * kp + 1][3]);
  }
}

// One logit from a raw score S = q . k: S (s_h inv_q) inv_k + bias, with sq
// = s_h inv_q rounded once; -inf where the staged bias is (masked). The same
// operations in every pass, so a backward pass recomputes the forward's
// bits; the softmax then takes exp2(z log2(e) - m).
__device__ __forceinline__ float logit(float s, float sq, float ik, float b) {
  return __fmaf_rn(__fmul_rn(s, sq), ik, b);
}

// The logits, in place, of a warp's 16 x 64 tile of raw scores (queries by
// rows): sq, s_h inv_q of the thread's rows g, g + 8; inv_k, the key tile's
// 64 inverse norms; the bias from the staged bias tile by ldmatrix, four 8 x
// 8 blocks at a time in C-tile order (addr: the warp's first row plus
// a_lane).
__device__ __forceinline__ void logits(float (&s)[8][4], const float (&sq)[2],
                                       const float* inv_k, uint32_t addr, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    unsigned b[4];
    ldsm_x4(b, addr + 32 * kp);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int nt = 2 * kp + h2;
      const float2 ik = *reinterpret_cast<const float2*>(inv_k + 8 * nt + 2 * t);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const unsigned u = b[2 * h2 + hf];
        s[nt][2 * hf] = logit(s[nt][2 * hf], sq[hf], ik.x, lo_of(u));
        s[nt][2 * hf + 1] = logit(s[nt][2 * hf + 1], sq[hf], ik.y, hi_of(u));
      }
    }
  }
}

// The logits, in place, of the transposed tile S^T = k . q (keys by rows,
// queries by columns): ik, inv_k of the thread's key rows g, g + 8; iq, the
// query tile's 64 inverse norms; the bias from the staged (queries, keys)
// bias tile by ldmatrix.trans (addr: the tile plus bt_lane plus the warp's
// first key column).
__device__ __forceinline__ void logits_t(float (&s)[8][4], const float (&ik)[2],
                                         const float* iq, float scale, uint32_t addr,
                                         int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    unsigned b[4];
    ldsm_x4_t(b, addr + 16 * kp * kBiasPitch * 2);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int nt = 2 * kp + h2;
      const float2 i2 = *reinterpret_cast<const float2*>(iq + 8 * nt + 2 * t);
      const float sq[2] = {__fmul_rn(scale, i2.x), __fmul_rn(scale, i2.y)};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const unsigned u = b[2 * h2 + hf];
        s[nt][2 * hf] = logit(s[nt][2 * hf], sq[0], ik[hf], lo_of(u));
        s[nt][2 * hf + 1] = logit(s[nt][2 * hf + 1], sq[1], ik[hf], hi_of(u));
      }
    }
  }
}

// P = exp2(z log2(e) - lse) with lse in the log2 domain.
__device__ __forceinline__ float prob(float z, float lse) {
  return ex2(__fmaf_rn(z, kLog2e, -lse));
}

// --- the inverse norms --------------------------------------------------------

// inv (rows, 2, heads, n) f32: 1 / max(|x|, eps) of each q (0) and k (1) head
// row of the slab, its squares summed in f32 in element order.
template <int D>
__global__ void __launch_bounds__(kSumThreads)
    wattn_norms_kernel(const bf16* __restrict__ qkv, float* __restrict__ inv, Dims dims,
                       long long total) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int tok = static_cast<int>(i % dims.n);
    long long rest = i / dims.n;
    const int h = static_cast<int>(rest % dims.heads);
    rest /= dims.heads;
    const int part = static_cast<int>(rest % 2);
    const long long row = rest / 2;
    const bf16* p = qkv + (row * dims.n + tok) * 3 * dims.c + part * dims.c + h * D;
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < D; e += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + e);
      for (const unsigned u : {v.x, v.y, v.z, v.w}) {
        ss = fmaf(lo_of(u), lo_of(u), ss);
        ss = fmaf(hi_of(u), hi_of(u), ss);
      }
    }
    inv[i] = rsqrtf(fmaxf(ss, kNormEps2));
  }
}

// --- forward ----------------------------------------------------------------

template <int D>
constexpr size_t kFwdSmem = 5 * kTileBytes<D> + 2 * kBiasBytes + 2 * kVecBytes;

// Grid (images, query tiles, windows x heads). Writes out (rows, n, C) and
// lse (rows, heads, n), the log2-domain log-sum-exp of each query's logits.
template <int D>
__global__ void __launch_bounds__(kThreads)
    wattn_fwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ tau,
                     const bf16* __restrict__ bias, const float* __restrict__ inv,
                     bf16* __restrict__ out, float* __restrict__ lse, Dims dims) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TB = kTileBytes<D>;
  const uint32_t qs = smem_addr(smem);
  const uint32_t ks = qs + TB;      // 2 tiles
  const uint32_t vs = ks + 2 * TB;  // 2 tiles
  const uint32_t bs = vs + 2 * TB;  // 2 bias tiles
  const uint32_t iks_s = bs + 2 * kBiasBytes;
  const float* iks = reinterpret_cast<const float*>(smem + (iks_s - qs));  // 2 x 64
  const int n = dims.n, c = dims.c, ld = 3 * c;
  const int w = blockIdx.z / dims.heads, h = blockIdx.z % dims.heads;
  const size_t row = static_cast<size_t>(blockIdx.x) * dims.windows + w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kTile;
  const int q0 = r0 + 16 * warp;  // the warp's first query
  const bool active = q0 < n;
  const bf16* src = qkv + row * n * ld + h * D;
  const bf16* bias_wh = bias + static_cast<size_t>(blockIdx.z) * n * n;
  const float* inv_q = inv + (row * 2 * dims.heads + h) * n;
  const float* inv_k = inv_q + static_cast<size_t>(dims.heads) * n;
  const TileCopy<D> copy(ld);
  const BiasCopy copy_bias;

  copy(qs, src, r0, n, ld);
  copy(ks, src + c, 0, n, ld);
  copy(vs, src + 2 * c, 0, n, ld);
  copy_bias(bs, bias_wh, r0, 0, n);
  stage_vec(iks_s, inv_k, 0, n);
  cp_async_commit();
  const float scale = head_scale(tau, h);
  float sq[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + g + 8 * hf;
    sq[hf] = q < n ? __fmul_rn(scale, __ldg(inv_q + q)) : 0.f;
  }
  const uint32_t lane_bt = bt_lane(lane, kPitch<D>), lane_b = b_lane(lane, kPitch<D>);
  const uint32_t lane_bias = a_lane(lane, kBiasPitch) + 16 * warp * kBiasPitch * 2;
  unsigned qa[D / 16][4];
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < dims.tiles; ++j) {
    const int b = j & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < dims.tiles) {
      const int k1 = (j + 1) * kTile;
      copy(ks + (b ^ 1) * TB, src + c, k1, n, ld);
      copy(vs + (b ^ 1) * TB, src + 2 * c, k1, n, ld);
      copy_bias(bs + (b ^ 1) * kBiasBytes, bias_wh, r0, k1, n);
      stage_vec(iks_s + (b ^ 1) * kVecBytes, inv_k, k1, n);
      cp_async_commit();
    }
    if (!active) continue;
    if (j == 0) load_a<D>(qa, qs + a_lane(lane, kPitch<D>) + 16 * warp * kPitch<D> * 2);
    float s[8][4];
    times_rows_t<D>(s, qa, ks + b * TB + lane_bt);
    logits(s, sq, iks + b * kTile, bs + b * kBiasBytes + lane_bias, lane);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
      const float mn = fmaxf(m[hf], quad_max(mx));
      // a row whose keys are all masked so far keeps exp2 at 0, not NaN
      const float base = mn == -INFINITY ? 0.f : mn * kLog2e;
      const float corr = ex2(__fmaf_rn(m[hf], kLog2e, -base));
      m[hf] = mn;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * hf] = prob(s[nt][2 * hf], base);
        s[nt][2 * hf + 1] = prob(s[nt][2 * hf + 1], base);
        rs += s[nt][2 * hf] + s[nt][2 * hf + 1];
      }
      l[hf] = l[hf] * corr + rs;
#pragma unroll
      for (int j2 = 0; j2 < D / 8; ++j2) {
        o[j2][2 * hf] *= corr;
        o[j2][2 * hf + 1] *= corr;
      }
    }
    unsigned p[4][4];
    to_a(p, s);
    times_rows<D>(o, p, vs + b * TB + lane_b);
  }
  if (!active) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float sum = quad_sum(l[hf]);
    const float rcp = 1.f / sum;
    const int q = q0 + g + 8 * hf;
    if (q >= n) continue;
    bf16* dst = out + (row * n + q) * c + h * D + 2 * t;
#pragma unroll
    for (int j2 = 0; j2 < D / 8; ++j2)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j2) =
          __floats2bfloat162_rn(o[j2][2 * hf] * rcp, o[j2][2 * hf + 1] * rcp);
    if (t == 0) lse[(row * dims.heads + h) * n + q] = __fmaf_rn(m[hf], kLog2e, log2f(sum));
  }
}

// --- backward ---------------------------------------------------------------

// The normalisation's backward of a warp's 16 x D strip of G = sum dS x'^
// (the other side's unit rows) in C tiles: x the raw rows at src (rows q0 +
// g (+ 8), `ld` apart, only those < n), inv2 their 1 / |x|, dx = s_h inv (G
// - x^ <x^, G>) stored as bf16 at dst (same layout as src).
template <int D>
__device__ __forceinline__ void normalise_backward(const float (&gacc)[D / 8][4],
                                                   const bf16* src, bf16* dst, int ld,
                                                   const float (&inv2)[2], int q0, int n,
                                                   float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + g + 8 * hf;
    const bool valid = q < n;
    float xh[D / 8][2];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = valid ? load_pair(src + static_cast<size_t>(q) * ld + 8 * j + 2 * t)
                             : make_float2(0.f, 0.f);
      xh[j][0] = x.x * inv2[hf];
      xh[j][1] = x.y * inv2[hf];
      dot = fmaf(xh[j][0], gacc[j][2 * hf], dot);
      dot = fmaf(xh[j][1], gacc[j][2 * hf + 1], dot);
    }
    dot = quad_sum(dot);
    if (!valid) continue;
    const float m = scale * inv2[hf];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(q) * ld + 8 * j + 2 * t) =
          __floats2bfloat162_rn(m * (gacc[j][2 * hf] - xh[j][0] * dot),
                                m * (gacc[j][2 * hf + 1] - xh[j][1] * dot));
  }
}

template <int D>
constexpr size_t kDqSmem = 6 * kTileBytes<D> + 2 * kBiasBytes + 2 * kVecBytes;

// Pass 1. Grid as the forward's. dq into the slab's gradient and D = sum_j
// P_ij dP_ij of each query, in f32, to dsum (rows, heads, n) for the other
// passes. dS here takes D~ = <dO, O> from the bf16 output, as it must
// before the loop ends.
template <int D>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
    wattn_dq_kernel(const bf16* __restrict__ qkv, const float* __restrict__ tau,
                    const bf16* __restrict__ bias, const float* __restrict__ inv,
                    const bf16* __restrict__ out, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    bf16* __restrict__ dqkv, Dims dims) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TB = kTileBytes<D>;
  const uint32_t qs = smem_addr(smem);
  const uint32_t gs = qs + TB;
  const uint32_t ks = gs + TB;      // 2 tiles
  const uint32_t vs = ks + 2 * TB;  // 2 tiles
  const uint32_t bs = vs + 2 * TB;  // 2 bias tiles
  const uint32_t iks_s = bs + 2 * kBiasBytes;
  const float* iks = reinterpret_cast<const float*>(smem + (iks_s - qs));  // 2 x 64
  const int n = dims.n, c = dims.c, ld = 3 * c;
  const int w = blockIdx.z / dims.heads, h = blockIdx.z % dims.heads;
  const size_t row = static_cast<size_t>(blockIdx.x) * dims.windows + w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kTile;
  const int q0 = r0 + 16 * warp;
  const bool active = q0 < n;
  const bf16* src = qkv + row * n * ld + h * D;
  const bf16* osrc = out + row * n * c + h * D;
  const bf16* gsrc = dout + row * n * c + h * D;
  const bf16* bias_wh = bias + static_cast<size_t>(blockIdx.z) * n * n;
  const float* inv_q = inv + (row * 2 * dims.heads + h) * n;
  const float* inv_k = inv_q + static_cast<size_t>(dims.heads) * n;
  const size_t stats = (row * dims.heads + h) * n;
  const TileCopy<D> copy(ld), copy_g(c);
  const BiasCopy copy_bias;

  copy(qs, src, r0, n, ld);
  copy_g(gs, gsrc, r0, n, c);
  copy(ks, src + c, 0, n, ld);
  copy(vs, src + 2 * c, 0, n, ld);
  copy_bias(bs, bias_wh, r0, 0, n);
  stage_vec(iks_s, inv_k, 0, n);
  cp_async_commit();
  const float scale = head_scale(tau, h);
  // per row (g, g + 8): inv_q, s_h inv_q, lse, D~ and the sum of P dP
  float iq[2], sq[2], lse2[2], dt[2], pdp[2] = {};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + g + 8 * hf;
    iq[hf] = q < n ? __ldg(inv_q + q) : 0.f;
    sq[hf] = __fmul_rn(scale, iq[hf]);
    lse2[hf] = q < n ? __ldg(lse + stats + q) : INFINITY;
  }
  const uint32_t lane_a = a_lane(lane, kPitch<D>) + 16 * warp * kPitch<D> * 2;
  const uint32_t lane_bt = bt_lane(lane, kPitch<D>), lane_b = b_lane(lane, kPitch<D>);
  const uint32_t lane_bias = a_lane(lane, kBiasPitch) + 16 * warp * kBiasPitch * 2;
  unsigned qa[D / 16][4], ga[D / 16][4];
  float gacc[D / 8][4] = {};
  for (int j = 0; j < dims.tiles; ++j) {
    const int b = j & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < dims.tiles) {
      const int k1 = (j + 1) * kTile;
      copy(ks + (b ^ 1) * TB, src + c, k1, n, ld);
      copy(vs + (b ^ 1) * TB, src + 2 * c, k1, n, ld);
      copy_bias(bs + (b ^ 1) * kBiasBytes, bias_wh, r0, k1, n);
      stage_vec(iks_s + (b ^ 1) * kVecBytes, inv_k, k1, n);
      cp_async_commit();
    }
    if (!active) continue;
    if (j == 0) {
      load_a<D>(qa, qs + lane_a);
      load_a<D>(ga, gs + lane_a);
      // D~ = <dO, O> of the thread's two rows, from dO's fragments
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = q0 + g + 8 * hf;
        float acc = 0.f;
        if (q < n) {
          const bf16* orow = osrc + static_cast<size_t>(q) * c;
#pragma unroll
          for (int ks2 = 0; ks2 < D / 16; ++ks2)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const unsigned u = ga[ks2][2 * half + hf];
              const float2 ov = load_pair(orow + 16 * ks2 + 8 * half + 2 * t);
              acc = fmaf(lo_of(u), ov.x, acc);
              acc = fmaf(hi_of(u), ov.y, acc);
            }
        }
        dt[hf] = quad_sum(acc);
      }
    }
    const float* ik = iks + b * kTile;
    float s[8][4], dp[8][4];
    times_rows_t<D>(s, qa, ks + b * TB + lane_bt);
    logits(s, sq, ik, bs + b * kBiasBytes + lane_bias, lane);
    times_rows_t<D>(dp, ga, vs + b * TB + lane_bt);
    // dS = P (dP - D~), P = exp2(z log2(e) - lse); dS inv_k for dQ^ = sum
    // dS k^
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 i2 = *reinterpret_cast<const float2*>(ik + 8 * nt + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = prob(s[nt][e], lse2[e >> 1]);
        pdp[e >> 1] = fmaf(p, dp[nt][e], pdp[e >> 1]);
        dp[nt][e] = p * (dp[nt][e] - dt[e >> 1]) * (e & 1 ? i2.y : i2.x);
      }
    }
    unsigned f[4][4];
    to_a(f, dp);
    times_rows<D>(gacc, f, ks + b * TB + lane_b);
  }
  if (!active) return;
  normalise_backward<D>(gacc, src, dqkv + row * n * ld + h * D, ld, iq, q0, n, scale, lane);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + g + 8 * hf;
    const float d = quad_sum(pdp[hf]);
    if (q < n && t == 0) dsum[stats + q] = d;
  }
}

template <int D>
constexpr size_t kDkdvSmem = 6 * kTileBytes<D> + 2 * kBiasBytes + 6 * kVecBytes;

// Pass 2. Grid (images, key tiles, windows x heads): a warp owns 16 keys and
// walks the query tiles with the scores transposed; dk and dv into the
// slab's gradient.
template <int D>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
    wattn_dkdv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ tau,
                      const bf16* __restrict__ bias, const float* __restrict__ inv,
                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dsum, bf16* __restrict__ dqkv, Dims dims) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TB = kTileBytes<D>;
  const uint32_t ks = smem_addr(smem);
  const uint32_t vs = ks + TB;
  const uint32_t qs = vs + TB;      // 2 tiles
  const uint32_t gs = qs + 2 * TB;  // 2 tiles
  const uint32_t bs = gs + 2 * TB;  // 2 bias tiles
  const uint32_t vec_s = bs + 2 * kBiasBytes;  // lse, dsum, inv_q: 2 x 64 each
  const float* lse_s = reinterpret_cast<const float*>(smem + (vec_s - ks));
  const float* dsum_s = lse_s + 2 * kTile;
  const float* iq_s = dsum_s + 2 * kTile;
  const int n = dims.n, c = dims.c, ld = 3 * c;
  const int w = blockIdx.z / dims.heads, h = blockIdx.z % dims.heads;
  const size_t row = static_cast<size_t>(blockIdx.x) * dims.windows + w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kTile;
  const int k0 = r0 + 16 * warp;  // the warp's first key
  const bool active = k0 < n;
  const bf16* src = qkv + row * n * ld + h * D;
  const bf16* gsrc = dout + row * n * c + h * D;
  const bf16* bias_wh = bias + static_cast<size_t>(blockIdx.z) * n * n;
  const float* inv_q = inv + (row * 2 * dims.heads + h) * n;
  const float* inv_k = inv_q + static_cast<size_t>(dims.heads) * n;
  const size_t stats = (row * dims.heads + h) * n;
  const TileCopy<D> copy(ld), copy_g(c);
  const BiasCopy copy_bias;

  auto stage_queries = [&](int buf, int i0) {
    copy(qs + buf * TB, src, i0, n, ld);
    copy_g(gs + buf * TB, gsrc, i0, n, c);
    copy_bias(bs + buf * kBiasBytes, bias_wh, i0, r0, n);
    stage_vec(vec_s + buf * kVecBytes, lse + stats, i0, n);
    stage_vec(vec_s + (2 + buf) * kVecBytes, dsum + stats, i0, n);
    stage_vec(vec_s + (4 + buf) * kVecBytes, inv_q, i0, n);
  };
  copy(ks, src + c, r0, n, ld);
  copy(vs, src + 2 * c, r0, n, ld);
  stage_queries(0, 0);
  cp_async_commit();
  const float scale = head_scale(tau, h);
  float ik[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int k = k0 + g + 8 * hf;
    ik[hf] = k < n ? __ldg(inv_k + k) : 0.f;
  }
  const uint32_t lane_a = a_lane(lane, kPitch<D>) + 16 * warp * kPitch<D> * 2;
  const uint32_t lane_bt = bt_lane(lane, kPitch<D>), lane_b = b_lane(lane, kPitch<D>);
  const uint32_t lane_bias = bt_lane(lane, kBiasPitch) + 16 * warp * 2;
  unsigned ka[D / 16][4], va[D / 16][4];
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int i = 0; i < dims.tiles; ++i) {
    const int b = i & 1;
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < dims.tiles) {
      stage_queries(b ^ 1, (i + 1) * kTile);
      cp_async_commit();
    }
    if (!active) continue;
    if (i == 0) {
      load_a<D>(ka, ks + lane_a);
      load_a<D>(va, vs + lane_a);
    }
    const float* lse_b = lse_s + b * kTile;
    const float* dsum_b = dsum_s + b * kTile;
    const float* iq_b = iq_s + b * kTile;
    float s[8][4], dp[8][4];
    times_rows_t<D>(s, ka, qs + b * TB + lane_bt);
    logits_t(s, ik, iq_b, scale, bs + b * kBiasBytes + lane_bias, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_b + 8 * nt + 2 * t);
      s[nt][0] = prob(s[nt][0], l2.x);
      s[nt][1] = prob(s[nt][1], l2.y);
      s[nt][2] = prob(s[nt][2], l2.x);
      s[nt][3] = prob(s[nt][3], l2.y);
    }
    unsigned f[4][4];
    to_a(f, s);
    times_rows<D>(dv, f, gs + b * TB + lane_b);
    times_rows_t<D>(dp, va, gs + b * TB + lane_bt);
    // dS^T inv_q for dK^ = sum dS q^
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(dsum_b + 8 * nt + 2 * t);
      const float2 i2 = *reinterpret_cast<const float2*>(iq_b + 8 * nt + 2 * t);
      dp[nt][0] = s[nt][0] * (dp[nt][0] - d2.x) * i2.x;
      dp[nt][1] = s[nt][1] * (dp[nt][1] - d2.y) * i2.y;
      dp[nt][2] = s[nt][2] * (dp[nt][2] - d2.x) * i2.x;
      dp[nt][3] = s[nt][3] * (dp[nt][3] - d2.y) * i2.y;
    }
    to_a(f, dp);
    times_rows<D>(dk, f, qs + b * TB + lane_b);
  }
  if (!active) return;
  bf16* dst = dqkv + row * n * ld + h * D;
  normalise_backward<D>(dk, src + c, dst + c, ld, ik, k0, n, scale, lane);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int k = k0 + g + 8 * hf;
    if (k >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 2 * c + static_cast<size_t>(k) * ld + 8 * j +
                                         2 * t) =
          __floats2bfloat162_rn(dv[j][2 * hf], dv[j][2 * hf + 1]);
  }
}

template <int D>
constexpr size_t kDbiasSmem =
    8 * kTileBytes<D> + kBiasBytes + 2 * kVecBytes + kWarps * sizeof(float);

// Pass 3. Grid (groups, query tiles x key tiles, windows x heads): the block
// walks the images of its group, the rows that share its bias window, and
// sums dS of its 64 x 64 tile in registers; f32 partials to part (groups,
// windows, heads, n, n); and the block's sum of dS s_h cos to tau_part
// (heads, windows, groups, tiles^2). Both take the f32 D of pass 1.
template <int D>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
    wattn_dbias_kernel(const bf16* __restrict__ qkv, const float* __restrict__ tau,
                       const bf16* __restrict__ bias, const float* __restrict__ inv,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dsum, float* __restrict__ part,
                       float* __restrict__ tau_part, Dims dims, int per_group) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TB = kTileBytes<D>;
  const uint32_t qs = smem_addr(smem);  // 2 tiles each
  const uint32_t gs = qs + 2 * TB;
  const uint32_t ks = gs + 2 * TB;
  const uint32_t vs = ks + 2 * TB;
  const uint32_t bs = vs + 2 * TB;  // 1 bias tile
  const uint32_t iks_s = bs + kBiasBytes;
  const float* iks = reinterpret_cast<const float*>(smem + (iks_s - qs));  // 2 x 64
  float* warp_sums = reinterpret_cast<float*>(smem + (iks_s - qs) + 2 * kVecBytes);
  const int n = dims.n, c = dims.c, ld = 3 * c;
  const int w = blockIdx.z / dims.heads, h = blockIdx.z % dims.heads;
  const int ti = blockIdx.y / dims.tiles, tj = blockIdx.y % dims.tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = ti * kTile + 16 * warp, k0 = tj * kTile;
  const bool active = q0 < n;
  const int x0 = blockIdx.x * per_group;
  const int x1 = min(dims.images, x0 + per_group);
  const TileCopy<D> copy(ld), copy_g(c);

  auto stage_image = [&](int buf, int x) {
    const size_t row = static_cast<size_t>(x) * dims.windows + w;
    const bf16* src = qkv + row * n * ld + h * D;
    copy(qs + buf * TB, src, ti * kTile, n, ld);
    copy_g(gs + buf * TB, dout + row * n * c + h * D, ti * kTile, n, c);
    copy(ks + buf * TB, src + c, k0, n, ld);
    copy(vs + buf * TB, src + 2 * c, k0, n, ld);
    stage_vec(iks_s + buf * kVecBytes, inv + ((row * 2 + 1) * dims.heads + h) * n, k0, n);
  };
  float acc[8][4] = {};
  float tacc = 0.f;
  BiasCopy()(bs, bias + static_cast<size_t>(blockIdx.z) * n * n, ti * kTile, k0, n);
  stage_image(0, x0);
  cp_async_commit();
  const float scale = head_scale(tau, h);
  const uint32_t lane_a = a_lane(lane, kPitch<D>) + 16 * warp * kPitch<D> * 2;
  const uint32_t lane_bt = bt_lane(lane, kPitch<D>);
  const uint32_t lane_bias = a_lane(lane, kBiasPitch) + 16 * warp * kBiasPitch * 2;
  for (int x = x0; x < x1; ++x) {
    const int b = (x - x0) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (x + 1 < x1) {
      stage_image(b ^ 1, x + 1);
      cp_async_commit();
    }
    if (!active) continue;
    const size_t row = static_cast<size_t>(x) * dims.windows + w;
    const size_t stats = (row * dims.heads + h) * n;
    const float* inv_q = inv + (row * 2 * dims.heads + h) * n;
    float sq[2], lse2[2], dsum2[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = q0 + g + 8 * hf;
      sq[hf] = q < n ? __fmul_rn(scale, __ldg(inv_q + q)) : 0.f;
      lse2[hf] = q < n ? __ldg(lse + stats + q) : INFINITY;
      dsum2[hf] = q < n ? __ldg(dsum + stats + q) : 0.f;
    }
    unsigned qa[D / 16][4], ga[D / 16][4];
    load_a<D>(qa, qs + b * TB + lane_a);
    load_a<D>(ga, gs + b * TB + lane_a);
    float s[8][4], dp[8][4];
    times_rows_t<D>(s, qa, ks + b * TB + lane_bt);
    times_rows_t<D>(dp, ga, vs + b * TB + lane_bt);
    // s_h cos = S sq inv_k, before the logits overwrite S
    const float* ik = iks + b * kTile;
    float cs[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 i2 = *reinterpret_cast<const float2*>(ik + 8 * nt + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cs[nt][e] = __fmul_rn(__fmul_rn(s[nt][e], sq[e >> 1]), e & 1 ? i2.y : i2.x);
    }
    logits(s, sq, ik, bs + lane_bias, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ds = prob(s[nt][e], lse2[e >> 1]) * (dp[nt][e] - dsum2[e >> 1]);
        acc[nt][e] += ds;
        tacc = fmaf(ds, cs[nt][e], tacc);
      }
  }
  tacc = warp_sum(tacc);
  if (lane == 0) warp_sums[warp] = tacc;
  __syncthreads();
  if (threadIdx.x == 0)
    tau_part[((static_cast<size_t>(h) * dims.windows + w) * gridDim.x + blockIdx.x) *
                 gridDim.y +
             blockIdx.y] = warp_sums[0] + warp_sums[1] + warp_sums[2] + warp_sums[3];
  if (!active) return;
  float* dst = part + (static_cast<size_t>(blockIdx.x) * gridDim.z + blockIdx.z) * n * n;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = q0 + g + 8 * hf;
    if (q >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + 8 * nt + 2 * t + e;
        if (k < n) dst[static_cast<size_t>(q) * n + k] = acc[nt][2 * hf + e];
      }
  }
}

// (4) dbias = the sum over groups, in group order, of part (groups, count),
// rounded to bf16.
__global__ void __launch_bounds__(kSumThreads)
    wattn_bias_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dbias,
                          long long count, int groups) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi) s += part[gi * count + i];
    dbias[i] = __float2bfloat16_rn(s);
  }
}

// (5) One block a head: dtau_h = the sum of the head's `count` partials of
// dS s_h cos, in a fixed order; 0 where tau is above ln 100.
__global__ void __launch_bounds__(kSumThreads)
    wattn_tau_kernel(const float* __restrict__ part, const float* __restrict__ tau,
                     float* __restrict__ dtau, int count) {
  __shared__ float red[kSumThreads];
  const int h = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += kSumThreads)
    s += part[static_cast<size_t>(h) * count + i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int o = kSumThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) dtau[h] = tau[h] <= kLogScaleMax ? red[0] : 0.f;
}

bool valid(int rows, int n, int heads, int d, int windows) {
  return rows > 0 && n > 0 && n <= kMaxTokens && heads > 0 && (d == 16 || d == 32) &&
         windows > 0 && rows % windows == 0 && static_cast<long long>(windows) * heads <= 65535;
}

Dims dims_of(int rows, int n, int heads, int d, int windows) {
  return Dims{n, heads, windows, rows / windows, (n + kTile - 1) / kTile, heads * d};
}

// Lets `kernel` take `bytes` of dynamic shared memory (past the default 48
// KB); a host call, safe while a stream is being captured.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int sum_blocks(long long count) {
  const long long blocks = (count + kSumThreads - 1) / kSumThreads;
  return static_cast<int>(blocks < 4096 ? blocks : 4096);
}

template <int D>
int fwd(const void* qkv, const void* tau, const void* bias, void* out, void* lse, void* inv,
        Dims dm, cudaStream_t s) {
  const cudaError_t err = allow_smem(wattn_fwd_kernel<D>, kFwdSmem<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* q = static_cast<const bf16*>(qkv);
  const long long total = static_cast<long long>(dm.images) * dm.windows * 2 * dm.heads * dm.n;
  wattn_norms_kernel<D><<<sum_blocks(total), kSumThreads, 0, s>>>(q, static_cast<float*>(inv),
                                                                  dm, total);
  const dim3 grid(dm.images, dm.tiles, dm.windows * dm.heads);
  wattn_fwd_kernel<D><<<grid, kThreads, kFwdSmem<D>, s>>>(
      q, static_cast<const float*>(tau), static_cast<const bf16*>(bias),
      static_cast<const float*>(inv), static_cast<bf16*>(out), static_cast<float*>(lse), dm);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd(const void* qkv, const void* tau, const void* bias, const void* inv, const void* out,
        const void* dout, const void* lse, void* dsum, void* dqkv, void* dbias, void* dtau,
        void* bias_part, void* tau_part, int groups, Dims dm, cudaStream_t s) {
  cudaError_t err = allow_smem(wattn_dq_kernel<D>, kDqSmem<D>);
  if (err == cudaSuccess) err = allow_smem(wattn_dkdv_kernel<D>, kDkdvSmem<D>);
  if (err == cudaSuccess) err = allow_smem(wattn_dbias_kernel<D>, kDbiasSmem<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* ta = static_cast<const float*>(tau);
  const auto* bi = static_cast<const bf16*>(bias);
  const auto* in = static_cast<const float*>(inv);
  const auto* go = static_cast<const bf16*>(dout);
  const auto* ls = static_cast<const float*>(lse);
  const auto* ds = static_cast<const float*>(dsum);
  const dim3 grid(dm.images, dm.tiles, dm.windows * dm.heads);
  wattn_dq_kernel<D><<<grid, kThreads, kDqSmem<D>, s>>>(
      q, ta, bi, in, static_cast<const bf16*>(out), go, ls, static_cast<float*>(dsum),
      static_cast<bf16*>(dqkv), dm);
  wattn_dkdv_kernel<D><<<grid, kThreads, kDkdvSmem<D>, s>>>(q, ta, bi, in, go, ls, ds,
                                                            static_cast<bf16*>(dqkv), dm);
  const int per_group = (dm.images + groups - 1) / groups;
  const dim3 bgrid(groups, dm.tiles * dm.tiles, dm.windows * dm.heads);
  wattn_dbias_kernel<D><<<bgrid, kThreads, kDbiasSmem<D>, s>>>(
      q, ta, bi, in, go, ls, ds, static_cast<float*>(bias_part), static_cast<float*>(tau_part),
      dm, per_group);
  const long long count = static_cast<long long>(dm.windows) * dm.heads * dm.n * dm.n;
  wattn_bias_sum_kernel<<<sum_blocks(count), kSumThreads, 0, s>>>(
      static_cast<const float*>(bias_part), static_cast<bf16*>(dbias), count, groups);
  wattn_tau_kernel<<<dm.heads, kSumThreads, 0, s>>>(
      static_cast<const float*>(tau_part), ta, static_cast<float*>(dtau),
      dm.windows * groups * dm.tiles * dm.tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Groups of images the bias-gradient pass splits the rows into: enough
// blocks for four on each SM of the current device, every group non-empty.
// The first dimension of tic_window_attention_bwd's bias_part; minus a CUDA
// error.
extern "C" int tic_window_attention_groups(int rows, int n, int heads, int d, int windows) {
  if (!valid(rows, n, heads, d, windows)) return -static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const Dims dm = dims_of(rows, n, heads, d, windows);
  const long long blocks = static_cast<long long>(dm.tiles) * dm.tiles * windows * heads;
  long long want = (4LL * sms + blocks - 1) / blocks;
  want = want < 1 ? 1 : (want > dm.images ? dm.images : want);
  const long long per = (dm.images + want - 1) / want;
  return static_cast<int>((dm.images + per - 1) / per);
}

// out (rows, n, C) bf16, lse (rows, heads, n) f32 and inv (rows, 2, heads, n)
// f32, the inverse norms of q and k, from the (rows, n, 3C) bf16 slab, tau
// (heads) f32 and the (windows, heads, n, n) bf16 bias. Launches on `stream`
// without synchronising; returns cudaGetLastError().
extern "C" int tic_window_attention_fwd(const void* qkv, const void* tau, const void* bias,
                                        void* out, void* lse, void* inv, int rows, int n,
                                        int heads, int d, int windows, void* stream) {
  if (!valid(rows, n, heads, d, windows)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm = dims_of(rows, n, heads, d, windows);
  auto s = static_cast<cudaStream_t>(stream);
  return d == 16 ? fwd<16>(qkv, tau, bias, out, lse, inv, dm, s)
                 : fwd<32>(qkv, tau, bias, out, lse, inv, dm, s);
}

// dqkv (rows, n, 3C) bf16, dtau (heads) f32 and dbias (windows, heads, n, n)
// bf16 from the forward's operands, its out, lse and inv and dout (rows, n,
// C) bf16, through the f32 scratches dsum (rows, heads, n), bias_part
// (groups, windows, heads, n, n) and tau_part (heads, windows, groups,
// tiles^2), groups from tic_window_attention_groups and tiles ceil(n / 64).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int tic_window_attention_bwd(const void* qkv, const void* tau, const void* bias,
                                        const void* inv, const void* out, const void* dout,
                                        const void* lse, void* dsum, void* dqkv, void* dbias,
                                        void* dtau, void* bias_part, void* tau_part, int groups,
                                        int rows, int n, int heads, int d, int windows,
                                        void* stream) {
  if (!valid(rows, n, heads, d, windows) || groups < 1 || groups > rows / windows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm = dims_of(rows, n, heads, d, windows);
  auto s = static_cast<cudaStream_t>(stream);
  return d == 16 ? bwd<16>(qkv, tau, bias, inv, out, dout, lse, dsum, dqkv, dbias, dtau,
                           bias_part, tau_part, groups, dm, s)
                 : bwd<32>(qkv, tau, bias, inv, out, dout, lse, dsum, dqkv, dbias, dtau,
                           bias_part, tau_part, groups, dm, s);
}
