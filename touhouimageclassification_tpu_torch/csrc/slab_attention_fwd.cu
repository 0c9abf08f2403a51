// Attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces three Pallas TPU kernels of
// touhouimageclassification_tpu/ops/attention.py, which compute the same
// function on three layouts of the same operands:
// - _slab_fwd_kernel (K1): the fused-QKV (B, N, 3C) slab, q | k | v along the
//   last dim; every ViT encoder layer runs it with attention_impl='fused';
// - _packed_fwd_kernel (K3): three (B, N, C) operands (packed_attention);
// - _attention_kernel (K4): (B, N, H, D) q, k, v (attention_impl='flash';
//   the TPU kernel pads N to 256 with -inf keys and takes heads in groups of
//   4, both TPU layout matters: here N stays 197 and the grid is K1's).
// All three are one device kernel per dtype over three base pointers q, k, v
// that share a batch stride and a row stride, head h at elements h*D ...
// (h+1)*D of a row: the slab is (slab, slab + C, slab + 2C) with row stride
// 3C, K3's operands and K4's dense (B, N, H, D) tensors are (q, k, v) with row
// stride C (H*D = C), and the model's K4 views of the slab are the slab's
// pointers. Per image b and head h:
//   S   = Q_h K_h^T * D^-1/2      in f32
//   P   = softmax(S)               f32, max-subtracted, normalised
//   P   is rounded to the input type, as the TPU kernel casts P before PV
//   O_h = P V_h                    f32 accumulation, written to out[b, :, h*D:(h+1)*D]
// of a contiguous (B, N, C) output. P never reaches device memory.
//
// Two routes, one per dtype, both written here; the C entry points pick by
// the dtype code and a launch the route cannot take fails, nothing falls back.
// The model's bf16 shapes (head dim 64, N <= 256: every preset) do not come
// here: ops/attention.py::kernel_route sends them to the Hopper kernel of
// slab_attention_fwd_sm90.cu (route 'wgmma'). The bf16 kernel below serves
// the other bf16 shapes (head dims 32 and 128, N > 256) and the kernel
// studies, which dissect it (tic_attention_fwd_variant, _peel, _softmax).
//
// bf16: attention_fwd_mma_kernel, on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulation). Grid (ceil(N / 64), H, B), 4 warps, each owning
// a 16-row query strip. (32 or 16 rows a block, for more blocks on a small
// launch, measured no faster at ViT-L bucket 1 and 1.5x / 2.9x slower at
// batch 64: tools/attn_fwd_study.py, PERF.md.) The block stages K_h and V_h of
// all N keys in shared memory with 16-byte cp.async copies read by row stride
// (rows past N zero-filled, pitch D + 8 for conflict-free ldmatrix); V's copy
// is a second group that lands while the first sweep runs. The warp's Q strip
// goes straight from device memory into A fragments and stays in registers.
// Sweep 1 over 16-key chunks: S = Q K^T (K rows as the B operand's columns,
// ldmatrix), scaled by D^-1/2 log2(e) so that exp2 serves, keys >= N set to
// -inf, a running max and rescaled sum per lane, combined over the quad at
// the end. Sweep 2 recomputes S, forms P = exp2(S - m) * (1 / l) in f32,
// rounds it to bf16 and re-packs the C fragments as A fragments in registers,
// and accumulates O += P V (V by ldmatrix.trans). O leaves through shared
// memory as 16-byte stores. The ragged N edge is masked in the kernel;
// nothing is padded in device memory. Three products where the bound counts
// two (S is recomputed rather than held: 16 x N f32 a warp would not fit in
// registers at D 128).
//
// The bf16 kernel also takes a Peel (slab_attention_common.cuh) for the
// roofline study of tools/roofline_attn.py (S5), whose forward peels
// (fwd_body :64-88, pallas_call :95) it replaces: tic_attention_fwd_peel runs
// the same grid and staging cut to dma, layout or matmul; the model's
// launches take kFull, the kernel as described above. kPostMul runs the
// softmax variant of tools/bench_attn6.py (S2) that scales O by 1 / l after
// PV (tic_attention_fwd_softmax); the model's launches leave it off. The
// other studies' tiles (S1, S3, S4) are slab_attention_tile.cu.
//
// f32: attention_fwd_kernel, SIMT (tensor cores take f32 only as TF32, about
// three decimal digits, too coarse for the f32 bound). Each warp takes one
// query row at a time: q in registers, lanes over keys for the scores, warp
// shuffles for the max and the sum, lanes over D for PV; K and V staged at a
// D + 2 pitch and read in float2 pairs, free of bank conflicts.
//
// What bounds it on this card. At ViT-L shapes (N 197, D 64) the bound is
// device-memory bytes (each q, k, v, o row once: 0.031 ms at batch 64 bf16).
// The roofline peels (tic_attention_fwd_peel, tools/roofline_attn.py)
// attribute the bf16 kernel's 0.12 ms of device time at batch 64 (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md), the losses the wgmma route was designed
// against: the staging 44% (each of a head's
// ceil(N / 64) row blocks stages all of K_h and V_h, 2.5x the unique bytes,
// and waits for K before its first product); the softmax between the
// products (an exp2 per score, twice) 31%; the ldmatrix fragment loads 9%;
// the three products 16%, of which the recomputed S is a third. Not the MMA
// issue rate. The f32 kernel is bound by SIMT FMAs and the shared-memory
// loads that feed them.
#include "slab_attention_common.cuh"

namespace {

using namespace tic;

constexpr int kBlockQ = kBlockRows;

// Shared memory, in this order: K_h and V_h as N rows of kStride elements,
// then one f32 row of N scores per warp.
template <typename T, int D>
size_t smem_bytes(int n) {
  return 2 * static_cast<size_t>(n) * kStride<D> * sizeof(T) +
         static_cast<size_t>(kWarps) * n * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q_in, const T* __restrict__ k_in,
                         const T* __restrict__ v_in, long long batch_stride,
                         int row_stride, T* __restrict__ out, int n, int num_heads,
                         float scale) {
  using T2 = typename Pair<T>::type;
  constexpr int S = kStride<D>;
  constexpr int kPairs = D / 2;                  // element pairs in a head row
  constexpr int kPairsPerLane = (kPairs + 31) / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + static_cast<size_t>(n) * S;
  float* scores = reinterpret_cast<float*>(vs + static_cast<size_t>(n) * S);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const size_t head = static_cast<size_t>(b) * batch_stride + h * D;
  const T* qb = q_in + head;
  const T* kb = k_in + head;
  const T* vb = v_in + head;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Stage K_h and V_h: elements h*D ... (h+1)*D of every key row.
  for (int i = tid; i < n * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int p = i - r * kPairs;
    const size_t src = static_cast<size_t>(r) * row_stride + 2 * p;
    *reinterpret_cast<T2*>(ks + r * S + 2 * p) = *reinterpret_cast<const T2*>(kb + src);
    *reinterpret_cast<T2*>(vs + r * S + 2 * p) = *reinterpret_cast<const T2*>(vb + src);
  }
  __syncthreads();

  float* prow = scores + warp * n;
  const int row_end = min(n, static_cast<int>(blockIdx.x + 1) * kBlockQ);
  for (int row = blockIdx.x * kBlockQ + warp; row < row_end; row += kWarps) {
    // Every lane holds the whole q row (one broadcast load per pair).
    const T2* qrow = reinterpret_cast<const T2*>(qb + static_cast<size_t>(row) * row_stride);
    float q[D];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const float2 v = to_float2(qrow[p]);
      q[2 * p] = v.x;
      q[2 * p + 1] = v.y;
    }

    // Scores: lane j takes keys j, j + 32, ...
    float m = -INFINITY;
    for (int k = lane; k < n; k += 32) {
      const T2* krow = reinterpret_cast<const T2*>(ks + k * S);
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const float2 kv = to_float2(krow[p]);
        s = fmaf(q[2 * p], kv.x, s);
        s = fmaf(q[2 * p + 1], kv.y, s);
      }
      s *= scale;
      prow[k] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float e = expf(prow[k] - m);
      prow[k] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int k = lane; k < n; k += 32) prow[k] = round_to<T>(prow[k] / l);
    __syncwarp();

    // PV: lane j owns the column pairs j, j + 32, ...
    float2 acc[kPairsPerLane];
#pragma unroll
    for (int j = 0; j < kPairsPerLane; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int k = 0; k < n; ++k) {
      const float p = prow[k];
      const T2* vrow = reinterpret_cast<const T2*>(vs + k * S);
#pragma unroll
      for (int j = 0; j < kPairsPerLane; ++j) {
        const int pi = lane + 32 * j;
        if (pi < kPairs) {
          const float2 v = to_float2(vrow[pi]);
          acc[j].x = fmaf(p, v.x, acc[j].x);
          acc[j].y = fmaf(p, v.y, acc[j].y);
        }
      }
    }
    T2* orow = reinterpret_cast<T2*>(out + (static_cast<size_t>(b) * n + row) * c + h * D);
#pragma unroll
    for (int j = 0; j < kPairsPerLane; ++j) {
      const int pi = lane + 32 * j;
      if (pi < kPairs) orow[pi] = from_floats<T>(acc[j].x, acc[j].y);
    }
    __syncwarp();  // the next row overwrites prow
  }
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, long long batch_stride, int row_stride,
           void* out, int b, int n, int num_heads, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(n);
  auto kernel = attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, num_heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, batch_stride, row_stride,
                                           static_cast<T*>(out), n, num_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// --- bf16: the tensor-core route ---------------------------------------------

using bf16 = __nv_bfloat16;

// Shared memory: K_h and V_h as staged_rows(N) rows of kPitch<D> elements.
template <int D>
size_t mma_smem_bytes(int n) {
  return 2 * static_cast<size_t>(mma::staged_rows(n)) * mma::kPitch<D> * sizeof(bf16);
}

// kExp2: exp2 of scores scaled by D^-1/2 log2(e) (the model's route), or exp
// of scores scaled by D^-1/2 (a measurement variant, tic_attention_fwd_variant).
// kPeel: how much of the kernel runs (Peel, slab_attention_common.cuh; the
// roofline study's levels, tic_attention_fwd_peel): kDma writes the Q strip
// back as it came, kLayout too after every fragment load of K and V of both
// sweeps, kMatmul writes P V with P = S D^-1/2 / N (score_scale then D^-1/2),
// kFull is the kernel. keep_folds stores the peels' folded fragments and
// products over the output; every launch passes 0. kPostMul (S2's post_mul,
// tic_attention_fwd_softmax; kFull only): sweep 2 rounds the unnormalised
// e = exp2(S - m) to bf16 for PV and O's f32 fragments are scaled by their
// rows' 1 / l (rows g and g + 8 each their own) before the store.
template <int D, int kBlockWarps, bool kExp2, Peel kPeel = Peel::kFull, bool kPostMul = false>
__global__ void __launch_bounds__(kBlockWarps * 32)
    attention_fwd_mma_kernel(const bf16* __restrict__ q_in, const bf16* __restrict__ k_in,
                             const bf16* __restrict__ v_in, long long batch_stride,
                             int row_stride, bf16* __restrict__ out, int n, int num_heads,
                             float score_scale, int keep_folds) {
  using namespace mma;
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = staged_rows(n);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + static_cast<size_t>(rows) * P;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * batch_stride + h * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kBlockWarps + warp) * kRows;
  const bool active = row0 < n;  // a strip wholly past N only helps stage

  stage_async<D>(ks, k_in + head, n, rows, row_stride, kBlockWarps * 32);
  cp_async_commit();
  stage_async<D>(vs, v_in + head, n, rows, row_stride, kBlockWarps * 32);
  cp_async_commit();
  unsigned qa[D / 16][4];
  if (active) load_a_strip<D>(qa, q_in + head, row0, n, row_stride, lane);
  cp_async_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // Sweep 1: the row max m and sum l, per lane over its columns, rows g and
  // g + 8 of the strip, then over the quad.
  const int chunks = (n + kRows - 1) / kRows;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  unsigned fold = 0;  // the peels' values that no output reads
  if (active) {
    for (int kc = 0; kc < chunks; ++kc) {
      if constexpr (kPeel == Peel::kLayout) {
        fold ^= rows_t_fragments<D>(ks, kRows * kc, lane);
      } else if constexpr (kPeel == Peel::kMatmul) {
        float s[2][4];
        strip_times_rows_t<D>(s, qa, ks, kRows * kc, lane);
        fold ^= fold_tile(s);
      } else if constexpr (kPeel == Peel::kFull) {
        float s[2][4];
        strip_times_rows_t<D>(s, qa, ks, kRows * kc, lane);
        scale_and_mask(s, score_scale, kRows * kc, n, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                             fmaxf(s[1][2 * r], s[1][2 * r + 1])));
          l[r] = l[r] * exp_below<kExp2>(m[r], mn) + exp_below<kExp2>(s[0][2 * r], mn) +
                 exp_below<kExp2>(s[0][2 * r + 1], mn) + exp_below<kExp2>(s[1][2 * r], mn) +
                 exp_below<kExp2>(s[1][2 * r + 1], mn);
          m[r] = mn;
        }
      }
    }
  }
  float inv_l[2];
  if constexpr (kPeel == Peel::kFull) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float row_max = quad_max(m[r]);
      inv_l[r] = 1.f / quad_sum(l[r] * exp_below<kExp2>(m[r], row_max));
      m[r] = row_max;
    }
  }

  // Sweep 2: P = exp2(S - m) / l in f32, rounded to bf16 as an A fragment,
  // then O += P V.
  cp_async_wait<0>();
  __syncthreads();
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  if (active) {
    for (int kc = 0; kc < chunks; ++kc) {
      if constexpr (kPeel == Peel::kLayout) {
        fold ^= rows_t_fragments<D>(ks, kRows * kc, lane);
        fold ^= rows_fragments<D>(vs, kRows * kc, lane);
      } else if constexpr (kPeel == Peel::kMatmul) {
        float s[2][4];
        strip_times_rows_t<D>(s, qa, ks, kRows * kc, lane);
        unsigned pa[4];
        scaled_fragment(pa, s, score_scale, 1.f / n);
        accumulate_rows<D>(o, pa, vs, kRows * kc, lane);
      } else if constexpr (kPeel == Peel::kFull) {
        float s[2][4];
        strip_times_rows_t<D>(s, qa, ks, kRows * kc, lane);
        scale_and_mask(s, score_scale, kRows * kc, n, lane);
        unsigned pa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if constexpr (kPostMul) {
              pa[2 * j + r] = pack_bf16(exp_base<kExp2>(s[j][2 * r] - m[r]),
                                        exp_base<kExp2>(s[j][2 * r + 1] - m[r]));
            } else {
              pa[2 * j + r] = pack_bf16(exp_base<kExp2>(s[j][2 * r] - m[r]) * inv_l[r],
                                        exp_base<kExp2>(s[j][2 * r + 1] - m[r]) * inv_l[r]);
            }
          }
        accumulate_rows<D>(o, pa, vs, kRows * kc, lane);
      }
    }
  }
  if constexpr (kPostMul) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= inv_l[0];
      o[j][1] *= inv_l[0];
      o[j][2] *= inv_l[1];
      o[j][3] *= inv_l[1];
    }
  }
  if constexpr (kPeel == Peel::kDma || kPeel == Peel::kLayout) {
    if (active) strip_as_tiles<D>(o, qa);
  }
  __syncthreads();  // every warp is done with K and V: stage O over them
  if (active)
    store_strip<D>(out + (static_cast<size_t>(b) * n) * num_heads * D + h * D,
                   static_cast<size_t>(num_heads) * D, row0, n, o, 1.f,
                   ks + warp * kRows * P, lane);
  if constexpr (kPeel != Peel::kFull) {
    if (keep_folds) reinterpret_cast<unsigned*>(out)[threadIdx.x] = fold;
  }
}

template <int D, int kBlockWarps, bool kExp2 = true, Peel kPeel = Peel::kFull,
          bool kPostMul = false>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, long long batch_stride,
               int row_stride, void* out, int b, int n, int num_heads, float scale,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>(n);
  auto kernel = attention_fwd_mma_kernel<D, kBlockWarps, kExp2, kPeel, kPostMul>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kRowsPerBlock = kBlockWarps * mma::kRows;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, num_heads, b);
  constexpr bool kLog2 = kExp2 && kPeel == Peel::kFull;  // the peels take D^-1/2
  kernel<<<grid, kBlockWarps * 32, smem, stream>>>(q, k, v, batch_stride, row_stride,
                                                   static_cast<bf16*>(out), n, num_heads,
                                                   kLog2 ? scale * 1.4426950408889634f : scale,
                                                   0);
  return static_cast<int>(cudaGetLastError());
}

// --- dispatch by dtype (route) and head dim ----------------------------------

int dispatch_d(const void* q, const void* k, const void* v, long long batch_stride,
               int row_stride, void* out, int b, int n, int num_heads, int d, int dtype,
               float scale, cudaStream_t stream) {
  if (dtype == 0) {
    const float* qt = static_cast<const float*>(q);
    const float* kt = static_cast<const float*>(k);
    const float* vt = static_cast<const float*>(v);
    switch (d) {
      case 32: return launch<float, 32>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, stream);
      case 64: return launch<float, 64>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, stream);
      case 128: return launch<float, 128>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    const bf16* qt = static_cast<const bf16*>(q);
    const bf16* kt = static_cast<const bf16*>(k);
    const bf16* vt = static_cast<const bf16*>(v);
    switch (d) {
      case 32: return launch_mma<32, 4>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, stream);
      case 64: return launch_mma<64, 4>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, stream);
      case 128: return launch_mma<128, 4>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

size_t smem_for_d(int n, int d, int dtype) {
  if (dtype == 0) {
    switch (d) {
      case 32: return smem_bytes<float, 32>(n);
      case 64: return smem_bytes<float, 64>(n);
      case 128: return smem_bytes<float, 128>(n);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 32: return mma_smem_bytes<32>(n);
      case 64: return mma_smem_bytes<64>(n);
      case 128: return mma_smem_bytes<128>(n);
    }
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32 (SIMT route), 1 = bfloat16 (tensor-core route).
extern "C" size_t tic_slab_attention_fwd_smem_bytes(int n, int d, int dtype) {
  return smem_for_d(n, d, dtype);
}

// The most dynamic shared memory one block may opt in to on `device`, or -1.
extern "C" int tic_max_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// The slab form (K1): q | k | v of a contiguous (B, N, 3C) slab. Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int tic_slab_attention_fwd(const void* qkv, void* out, int b, int n,
                                      int num_heads, int d, int dtype, float scale,
                                      void* stream) {
  const size_t size = dtype == 0 ? sizeof(float) : sizeof(bf16);
  const char* slab = static_cast<const char*>(qkv);
  const size_t c = static_cast<size_t>(num_heads) * d;
  return dispatch_d(slab, slab + c * size, slab + 2 * c * size, 3LL * n * c,
                    static_cast<int>(3 * c), out, b, n, num_heads, d, dtype, scale,
                    static_cast<cudaStream_t>(stream));
}

// The three-operand form (K3, K4): q, k, v with a shared batch stride and row
// stride in elements, each row holding H heads of D contiguous elements.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int tic_attention_fwd(const void* q, const void* k, const void* v,
                                 long long batch_stride, int row_stride, void* out,
                                 int b, int n, int num_heads, int d, int dtype,
                                 float scale, void* stream) {
  return dispatch_d(q, k, v, batch_stride, row_stride, out, b, n, num_heads, d, dtype,
                    scale, static_cast<cudaStream_t>(stream));
}

// A measurement entry point, on no path of the model: the bf16 forward at
// D 64 with its block shape and exponential chosen by the caller, `warps`
// 4, 2 or 1 (64, 32 or 16 query rows a block) and `use_exp2` 1 (exp2 of scores
// scaled by log2(e), the model's route) or 0 (exp). Arguments as
// tic_attention_fwd.
extern "C" int tic_attention_fwd_variant(const void* q, const void* k, const void* v,
                                         long long batch_stride, int row_stride,
                                         void* out, int b, int n, int num_heads, int d,
                                         float scale, int warps, int use_exp2,
                                         void* stream) {
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = 2 * warps + (use_exp2 ? 1 : 0);
  switch (key) {
    case 9: return launch_mma<64, 4, true>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, s);
    case 8: return launch_mma<64, 4, false>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, s);
    case 5: return launch_mma<64, 2, true>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, s);
    case 4: return launch_mma<64, 2, false>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, s);
    case 3: return launch_mma<64, 1, true>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, s);
    case 2: return launch_mma<64, 1, false>(qt, kt, vt, batch_stride, row_stride, out, b, n, num_heads, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A measurement entry point, on no path of the model: the bf16 forward of the
// slab form (K1) at D 64 cut to the roofline study's `level` (Peel: 0 dma, 1
// layout, 2 matmul, 3 full = K1 itself). Arguments as tic_slab_attention_fwd
// without the dtype.
extern "C" int tic_attention_fwd_peel(const void* qkv, void* out, int b, int n,
                                      int num_heads, int d, float scale, int level,
                                      void* stream) {
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* q = static_cast<const bf16*>(qkv);
  const int c = num_heads * d;
  const bf16* k = q + c;
  const bf16* v = q + 2 * c;
  const long long batch = 3LL * n * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (level) {
    case 0: return launch_mma<64, 4, true, Peel::kDma>(q, k, v, batch, 3 * c, out, b, n, num_heads, scale, s);
    case 1: return launch_mma<64, 4, true, Peel::kLayout>(q, k, v, batch, 3 * c, out, b, n, num_heads, scale, s);
    case 2: return launch_mma<64, 4, true, Peel::kMatmul>(q, k, v, batch, 3 * c, out, b, n, num_heads, scale, s);
    case 3: return launch_mma<64, 4, true, Peel::kFull>(q, k, v, batch, 3 * c, out, b, n, num_heads, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A measurement entry point, on no path of the model: S2's softmax variants
// (tools/bench_attn6.py::make_fwd, pallas_call :55) on K1's kernel and grid,
// the slab form at D 64: `exp2` 1 (scores scaled by log2(e), K1's route) or
// 0 (exp), `post_mul` 0 (P = e / l rounded before PV: with exp2, K1 itself)
// or 1 (e rounded, O scaled by 1 / l after PV). Arguments as
// tic_slab_attention_fwd without the dtype.
extern "C" int tic_attention_fwd_softmax(const void* qkv, void* out, int b, int n,
                                         int num_heads, int d, float scale, int exp2,
                                         int post_mul, void* stream) {
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* q = static_cast<const bf16*>(qkv);
  const int c = num_heads * d;
  const bf16* k = q + c;
  const bf16* v = q + 2 * c;
  const long long batch = 3LL * n * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * (exp2 ? 1 : 0) + (post_mul ? 1 : 0)) {
    case 3: return launch_mma<64, 4, true, Peel::kFull, true>(q, k, v, batch, 3 * c, out, b, n, num_heads, scale, s);
    case 2: return launch_mma<64, 4, true>(q, k, v, batch, 3 * c, out, b, n, num_heads, scale, s);
    case 1: return launch_mma<64, 4, false, Peel::kFull, true>(q, k, v, batch, 3 * c, out, b, n, num_heads, scale, s);
    default: return launch_mma<64, 4, false>(q, k, v, batch, 3 * c, out, b, n, num_heads, scale, s);
  }
}
