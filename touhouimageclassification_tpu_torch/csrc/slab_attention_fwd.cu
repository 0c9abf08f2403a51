// Slab attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
// touhouimageclassification_tpu/ops/attention.py::_slab_fwd_kernel, which every
// ViT encoder layer runs with attention_impl='fused'.
//
// What it computes. The fused-QKV projection emits one (B, N, 3C) slab:
// q | k | v along the last dim, head h at columns h*D ... (h+1)*D of each third.
// Per image b and head h:
//   S   = Q_h K_h^T * D^-1/2      in f32
//   P   = softmax(S)               f32, max-subtracted, exact divide
//   P   is rounded to the input type, as the TPU kernel casts P before PV
//   O_h = P V_h                    f32 accumulation, written to out[b, :, h*D:(h+1)*D]
// P never reaches device memory.
//
// Design. Grid (ceil(N / kBlockQ), H, B), kBlockQ = 64 query rows, 128 threads.
// The block stages K_h and V_h for all N keys in dynamic shared memory, read
// from the slab by stride (no split copies). Each warp then takes one query
// row at a time: q in registers, lanes over keys for the scores, warp
// shuffles for the max and the sum, lanes over D for PV. The ragged N edge is
// handled by loop bounds; nothing is padded in device memory.
//
// What bounds it on this card. At ViT-L serve shapes (N 197, D 64, bf16) the
// kernel is compute-bound on SIMT FMAs and the shared-memory loads that feed
// them: there is no tensor-core MMA yet, and every FMA of QK^T and PV takes
// one operand from shared memory. Device-memory traffic is small: a block
// reads K_h and V_h once (about 50 KB in bf16) and each q and o row once.
// What the design does about it: q stays in registers so the score loop
// loads only K; K and V are read in pairs (bf16x2 or float2), which halves
// the shared-memory instructions; rows are padded by two elements so that
// those pair loads are free of bank conflicts; one K/V staging serves 64
// query rows. Tensor-core MMA (mma.sync, then wgmma fed by TMA) is later work.
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
    slab_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                              int n, int num_heads, float scale) {
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
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const T* slab = qkv + static_cast<size_t>(b) * n * row_stride;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Stage K_h and V_h: columns c + h*D and 2c + h*D of every slab row.
  for (int i = tid; i < n * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int p = i - r * kPairs;
    const T* src = slab + r * row_stride + h * D + 2 * p;
    *reinterpret_cast<T2*>(ks + r * S + 2 * p) = *reinterpret_cast<const T2*>(src + c);
    *reinterpret_cast<T2*>(vs + r * S + 2 * p) = *reinterpret_cast<const T2*>(src + 2 * c);
  }
  __syncthreads();

  float* prow = scores + warp * n;
  const int row_end = min(n, static_cast<int>(blockIdx.x + 1) * kBlockQ);
  for (int row = blockIdx.x * kBlockQ + warp; row < row_end; row += kWarps) {
    // Every lane holds the whole q row (one broadcast load per pair).
    const T2* qrow = reinterpret_cast<const T2*>(slab + row * row_stride + h * D);
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
int launch(const void* qkv, void* out, int b, int n, int num_heads, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(n);
  auto kernel = slab_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, num_heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                           static_cast<T*>(out), n, num_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* qkv, void* out, int b, int n, int num_heads, int d,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(qkv, out, b, n, num_heads, scale, stream);
    case 64: return launch<T, 64>(qkv, out, b, n, num_heads, scale, stream);
    case 128: return launch<T, 128>(qkv, out, b, n, num_heads, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
size_t smem_for_d(int n, int d) {
  switch (d) {
    case 32: return smem_bytes<T, 32>(n);
    case 64: return smem_bytes<T, 64>(n);
    case 128: return smem_bytes<T, 128>(n);
    default: return 0;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t tic_slab_attention_fwd_smem_bytes(int n, int d, int dtype) {
  return dtype == 0 ? smem_for_d<float>(n, d) : smem_for_d<__nv_bfloat16>(n, d);
}

// The most dynamic shared memory one block may opt in to on `device`, or -1.
extern "C" int tic_max_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int tic_slab_attention_fwd(const void* qkv, void* out, int b, int n,
                                      int num_heads, int d, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(qkv, out, b, n, num_heads, d, scale, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(qkv, out, b, n, num_heads, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
