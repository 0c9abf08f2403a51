// Slab attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
// touhouimageclassification_tpu/ops/attention.py::_slab_bwd_kernel (through
// _packed_bwd_kernel_body), which every ViT encoder layer runs in the train
// step with attention_impl='fused'.
//
// What it computes. From the (B, N, 3C) slab (q | k | v, head h at columns
// h*D ... (h+1)*D of each third) and the upstream gradient g (B, N, C), per
// image b and head h:
//   S  = Q_h K_h^T * D^-1/2           f32
//   P  = softmax(S)                    f32, max-subtracted, exact divide
//   dP = g_h V_h^T                     f32 accumulation
//   dS = P o (dP - rowsum(dP o P))     f32
//   dS and P are rounded to the input type, as the TPU kernel casts them, then
//   dQ = dS K_h * scale,  dK = dS^T Q_h * scale,  dV = P^T g_h
// with f32 accumulation, written as one (B, N, 3C) gradient [dQ | dK | dV].
// Neither P nor dS reaches device memory.
//
// Design: two passes, one C entry point (FlashAttention-2's split).
// - Pass 1, grid (ceil(N / 64) query rows, H, B), 128 threads. The block
//   stages K_h and V_h of all N keys in shared memory. Each warp takes one
//   query row i at a time: q_i in registers, lanes over keys for S_i and its
//   max and sum, then g_i in the same registers for dP_i and D_i =
//   sum_j P_ij dP_ij, then dS_i; lanes over D for dQ_i. It saves the row's
//   max m_i, sum l_i and D_i to a (3, B, H, N) f32 scratch.
// - Pass 2, grid (ceil(N / 64) key rows, H, B). The block stages Q_h and g_h
//   of all N queries and the saved statistics. Each warp takes one key row j:
//   k_j, then v_j, in registers, lanes over queries rebuild P_ij =
//   exp(S_ij - m_i) / l_i and dS_ij, lanes over D accumulate dK_j and dV_j in
//   f32 registers. No atomics, so results are the same from run to run.
// Both passes compute S_ij and dP_ij as the same f32 FMA chain in element
// order (fma is symmetric in its factors) and keep the multiplies out of FMA
// contraction (__fmul_rn), so pass 2 rebuilds exactly pass 1's P and dS: dQ,
// dK and dV come from one set of probabilities.
//
// What bounds it on this card. At ViT-L train shapes (N 197, D 64, bf16) it is
// compute-bound on SIMT FMAs fed from shared memory, like K1, with about 3.5x
// K1's FMAs (S and dP are computed in both passes) and no tensor cores yet.
// Device-memory traffic is small: each block reads two head operands once
// (about 50 KB in bf16) and each row once. What the design does about it: the
// register row is the operand reused across all N partners, so the inner loops
// load one operand from shared memory per FMA pair; loads are element pairs
// (bf16x2 or float2) at a D + 2 row pitch, free of bank conflicts; one staging
// serves 64 rows; the dQ, dK and dV sums stay in registers with no atomics.
// Tensor-core MMA (mma.sync, then wgmma fed by TMA) is later work.
#include "slab_attention_common.cuh"

namespace {

using namespace tic;

// Pass 1 shared memory: K_h, V_h (N rows of kStride each), then per warp an
// f32 row of P and one of dP / dS.
template <typename T, int D>
size_t smem_dq(int n) {
  return 2 * static_cast<size_t>(n) * kStride<D> * sizeof(T) +
         static_cast<size_t>(kWarps) * 2 * n * sizeof(float);
}

// Pass 2 shared memory: Q_h, g_h, the saved m, l and D of every query row,
// then per warp an f32 row of P and one of dS.
template <typename T, int D>
size_t smem_dkv(int n) {
  return 2 * static_cast<size_t>(n) * kStride<D> * sizeof(T) +
         3 * static_cast<size_t>(n) * sizeof(float) +
         static_cast<size_t>(kWarps) * 2 * n * sizeof(float);
}

// Accumulates x += w * row for the column pairs lane owns (lane, lane + 32, ...).
template <typename T, int D>
__device__ __forceinline__ void axpy_pairs(float2 (&acc)[(D / 2 + 31) / 32],
                                           float w, const T* row, int lane) {
  using T2 = typename Pair<T>::type;
  const T2* r = reinterpret_cast<const T2*>(row);
#pragma unroll
  for (int j = 0; j < (D / 2 + 31) / 32; ++j) {
    const int pi = lane + 32 * j;
    if (pi < D / 2) {
      const float2 v = to_float2(r[pi]);
      acc[j].x = fmaf(w, v.x, acc[j].x);
      acc[j].y = fmaf(w, v.y, acc[j].y);
    }
  }
}

// Writes scale * acc to the column pairs lane owns of a head row.
template <typename T, int D>
__device__ __forceinline__ void store_pairs(T* row, const float2 (&acc)[(D / 2 + 31) / 32],
                                            float scale, int lane) {
  using T2 = typename Pair<T>::type;
  T2* r = reinterpret_cast<T2*>(row);
#pragma unroll
  for (int j = 0; j < (D / 2 + 31) / 32; ++j) {
    const int pi = lane + 32 * j;
    if (pi < D / 2) r[pi] = from_floats<T>(acc[j].x * scale, acc[j].y * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    slab_attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                                 T* __restrict__ dqkv, float* __restrict__ stats,
                                 int n, int num_heads, float scale) {
  constexpr int S = kStride<D>;
  constexpr int kAcc = (D / 2 + 31) / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + static_cast<size_t>(n) * S;
  float* rows = reinterpret_cast<float*>(vs + static_cast<size_t>(n) * S);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const T* slab = qkv + static_cast<size_t>(b) * n * row_stride;
  const T* gb = g + static_cast<size_t>(b) * n * c;
  T* db = dqkv + static_cast<size_t>(b) * n * row_stride;
  const size_t plane = static_cast<size_t>(gridDim.z) * num_heads * n;
  float* stat = stats + (static_cast<size_t>(b) * num_heads + h) * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  stage_rows<T, D>(ks, slab + c + h * D, n, row_stride);
  stage_rows<T, D>(vs, slab + 2 * c + h * D, n, row_stride);
  __syncthreads();

  float* prow = rows + warp * 2 * n;
  float* dsrow = prow + n;
  const int row_end = min(n, static_cast<int>(blockIdx.x + 1) * kBlockRows);
  for (int row = blockIdx.x * kBlockRows + warp; row < row_end; row += kWarps) {
    float x[D];
    load_row<T, D>(x, slab + row * row_stride + h * D);  // q_i
    float m = -INFINITY;
    for (int k = lane; k < n; k += 32) {
      const float s = __fmul_rn(dot_row<T, D>(x, ks + k * S), scale);
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

    load_row<T, D>(x, gb + row * c + h * D);  // g_i
    float di = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float p = prow[k] / l;
      const float dp = dot_row<T, D>(x, vs + k * S);
      prow[k] = p;
      dsrow[k] = dp;
      di = fmaf(p, dp, di);
    }
    di = warp_sum(di);
    for (int k = lane; k < n; k += 32)
      dsrow[k] = round_to<T>(__fmul_rn(prow[k], dsrow[k] - di));
    __syncwarp();

    float2 acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int k = 0; k < n; ++k) axpy_pairs<T, D>(acc, dsrow[k], ks + k * S, lane);
    store_pairs<T, D>(db + row * row_stride + h * D, acc, scale, lane);
    if (lane == 0) {
      stat[row] = m;
      stat[plane + row] = l;
      stat[2 * plane + row] = di;
    }
    __syncwarp();  // the next row overwrites prow and dsrow
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    slab_attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                                  T* __restrict__ dqkv, const float* __restrict__ stats,
                                  int n, int num_heads, float scale) {
  constexpr int S = kStride<D>;
  constexpr int kAcc = (D / 2 + 31) / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + static_cast<size_t>(n) * S;
  float* sm = reinterpret_cast<float*>(gs + static_cast<size_t>(n) * S);
  float* sl = sm + n;
  float* sd = sl + n;
  float* rows = sd + n;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const T* slab = qkv + static_cast<size_t>(b) * n * row_stride;
  const T* gb = g + static_cast<size_t>(b) * n * c;
  T* db = dqkv + static_cast<size_t>(b) * n * row_stride;
  const size_t plane = static_cast<size_t>(gridDim.z) * num_heads * n;
  const float* stat = stats + (static_cast<size_t>(b) * num_heads + h) * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  stage_rows<T, D>(qs, slab + h * D, n, row_stride);
  stage_rows<T, D>(gs, gb + h * D, n, c);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sm[i] = stat[i];
    sl[i] = stat[plane + i];
    sd[i] = stat[2 * plane + i];
  }
  __syncthreads();

  float* prow = rows + warp * 2 * n;
  float* dsrow = prow + n;
  const int row_end = min(n, static_cast<int>(blockIdx.x + 1) * kBlockRows);
  for (int row = blockIdx.x * kBlockRows + warp; row < row_end; row += kWarps) {
    float x[D];
    load_row<T, D>(x, slab + row * row_stride + c + h * D);  // k_j
    for (int i = lane; i < n; i += 32) {
      const float s = __fmul_rn(dot_row<T, D>(x, qs + i * S), scale);
      prow[i] = expf(s - sm[i]) / sl[i];
    }
    load_row<T, D>(x, slab + row * row_stride + 2 * c + h * D);  // v_j
    for (int i = lane; i < n; i += 32) {
      const float p = prow[i];
      const float dp = dot_row<T, D>(x, gs + i * S);
      dsrow[i] = round_to<T>(__fmul_rn(p, dp - sd[i]));
      prow[i] = round_to<T>(p);
    }
    __syncwarp();

    float2 acck[kAcc], accv[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      acck[j] = make_float2(0.f, 0.f);
      accv[j] = make_float2(0.f, 0.f);
    }
    for (int i = 0; i < n; ++i) {
      axpy_pairs<T, D>(acck, dsrow[i], qs + i * S, lane);
      axpy_pairs<T, D>(accv, prow[i], gs + i * S, lane);
    }
    store_pairs<T, D>(db + row * row_stride + c + h * D, acck, scale, lane);
    store_pairs<T, D>(db + row * row_stride + 2 * c + h * D, accv, 1.f, lane);
    __syncwarp();  // the next row overwrites prow and dsrow
  }
}

template <typename T, int D>
int launch(const void* qkv, const void* g, void* dqkv, void* stats, int b, int n,
           int num_heads, float scale, cudaStream_t stream) {
  const size_t smem1 = smem_dq<T, D>(n);
  const size_t smem2 = smem_dkv<T, D>(n);
  auto dq = slab_attention_bwd_dq_kernel<T, D>;
  auto dkv = slab_attention_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, num_heads, b);
  const T* q = static_cast<const T*>(qkv);
  const T* gg = static_cast<const T*>(g);
  T* out = static_cast<T*>(dqkv);
  float* st = static_cast<float*>(stats);
  dq<<<grid, kThreads, smem1, stream>>>(q, gg, out, st, n, num_heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv<<<grid, kThreads, smem2, stream>>>(q, gg, out, st, n, num_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* qkv, const void* g, void* dqkv, void* stats, int b, int n,
               int num_heads, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(qkv, g, dqkv, stats, b, n, num_heads, scale, stream);
    case 64: return launch<T, 64>(qkv, g, dqkv, stats, b, n, num_heads, scale, stream);
    case 128: return launch<T, 128>(qkv, g, dqkv, stats, b, n, num_heads, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
size_t smem_max(int n) {
  const size_t a = smem_dq<T, D>(n);
  const size_t c = smem_dkv<T, D>(n);
  return a > c ? a : c;
}

template <typename T>
size_t smem_for_d(int n, int d) {
  switch (d) {
    case 32: return smem_max<T, 32>(n);
    case 64: return smem_max<T, 64>(n);
    case 128: return smem_max<T, 128>(n);
    default: return 0;
  }
}

}  // namespace

// The larger of the two passes' dynamic shared memory. dtype: 0 = float32,
// 1 = bfloat16.
extern "C" size_t tic_slab_attention_bwd_smem_bytes(int n, int d, int dtype) {
  return dtype == 0 ? smem_for_d<float>(n, d) : smem_for_d<__nv_bfloat16>(n, d);
}

// Launches both passes on `stream` without synchronising; returns the first
// nonzero cudaGetLastError(). `stats` is (3, B, H, N) f32 scratch.
extern "C" int tic_slab_attention_bwd(const void* qkv, const void* g, void* dqkv,
                                      void* stats, int b, int n, int num_heads, int d,
                                      int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(qkv, g, dqkv, stats, b, n, num_heads, d, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(qkv, g, dqkv, stats, b, n, num_heads, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
