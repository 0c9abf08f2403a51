// AdamW's update over every parameter of a group in one launch (U1), for
// Hopper (sm_90a), bound to Python with ctypes (ops/adamw.py).
//
// It replaces no Pallas kernel: the JAX package's update is optax's adamw,
// which XLA fuses into the train step. The port's update was
// torch.optim.AdamW on its foreach route: about seven passes over the
// parameters (the decay, lerp, mul, addcmul, sqrt, div, add, addcdiv), each
// a multi_tensor_apply launch per ~20 M elements, and a full f32 copy of
// the parameters for the square root.
//
// What it computes, per element, in f32 and in the order of torch's foreach
// route (each step rounded as that route rounds it; the fused multiply-adds
// are the ones nvcc forms in torch's own kernels):
//   p = p * decay                                   decay = 1 - lr wd
//   m = lerp(m, g, w)                               w = 1 - b1 (at::native::lerp)
//   v = v * b2 + (1 - b2) * (g * g)
//   p = p + neg_step * (m / (sqrt(v) / bc2_sqrt + eps))
// with neg_step = -lr / (1 - b1^t) and bc2_sqrt = sqrt(1 - b2^t) from the host
// (ops/adamw.py), IEEE square root and division.
//
// What bounds it: nothing is reused, so it is bound by bytes. f32 p, g, m and
// v are read and p, m and v written: 28 bytes an element, 8.5 GB for ViT-L's
// 304.5 M parameters (2.55 ms at 3.35 TB/s) and 50.8 GB for one card's
// V-MoE-L/16 (1.815 B, 15.2 ms). The design, for the bandwidth:
// - the tensors are one range of elements: a device table holds each one's
//   p, g, m and v pointers, its element count and its offset in the range,
//   each offset rounded up to a whole chunk of kChunk elements, so that a
//   chunk lies in one tensor and starts on a 16-byte boundary when the tensor
//   does;
// - a persistent grid of kBlocksPerSm blocks an SM (fewer for a small range)
//   walks the chunks grid-stride; a block's chunks only grow, so it finds each
//   chunk's tensor by walking the table forward;
// - a full chunk is read as 16-byte vectors, kUnroll of each operand in
//   flight a thread before any is used, with streaming cache hints (ld.cs,
//   st.cs: every byte is touched once);
// - a tensor's ragged last chunk takes vectors as far as they go and a scalar
//   tail; a tensor whose four pointers are not 16-byte aligned (a view at an
//   odd offset) runs scalar. There is no other path.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int kVec = 4;
constexpr long long kChunk = static_cast<long long>(kThreads) * kUnroll * kVec;
constexpr int kBlocksPerSm = 4;

// One row of the table; ops/adamw.py writes it as six int64 values.
struct Entry {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long numel;
  long long offset;
};
static_assert(sizeof(Entry) == 48, "the table's rows are six 8-byte values");

struct Hyper {
  float decay, w, one_minus_w, beta2, one_minus_beta2, bc2_sqrt, eps, neg_step;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h) {
  p = __fmul_rn(p, h.decay);
  const float diff = __fsub_rn(g, m);
  m = h.w < 0.5f ? __fmaf_rn(h.w, diff, m) : __fmaf_rn(-diff, h.one_minus_w, g);
  v = __fmaf_rn(h.one_minus_beta2, __fmul_rn(g, g), __fmul_rn(v, h.beta2));
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), h.bc2_sqrt), h.eps);
  p = __fmaf_rn(h.neg_step, __fdiv_rn(m, denom), p);
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m,
                                        float4& v, const Hyper& h) {
  update(p.x, g.x, m.x, v.x, h);
  update(p.y, g.y, m.y, v.y, h);
  update(p.z, g.z, m.z, v.z, h);
  update(p.w, g.w, m.w, v.w, h);
}

__device__ __forceinline__ void update_at(float* p, const float* g, float* m,
                                          float* v, long long i, const Hyper& h) {
  float rp = __ldcs(p + i), rm = __ldcs(m + i), rv = __ldcs(v + i);
  update(rp, __ldcs(g + i), rm, rv, h);
  __stcs(p + i, rp);
  __stcs(m + i, rm);
  __stcs(v + i, rv);
}

__device__ __forceinline__ void update4_at(float* p, const float* g, float* m,
                                           float* v, long long i, const Hyper& h) {
  float4* p4 = reinterpret_cast<float4*>(p) + i;
  float4* m4 = reinterpret_cast<float4*>(m) + i;
  float4* v4 = reinterpret_cast<float4*>(v) + i;
  float4 rp = __ldcs(p4), rm = __ldcs(m4), rv = __ldcs(v4);
  update4(rp, __ldcs(reinterpret_cast<const float4*>(g) + i), rm, rv, h);
  __stcs(p4, rp);
  __stcs(m4, rm);
  __stcs(v4, rv);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    adamw_kernel(const Entry* __restrict__ table, int ntensors, long long nchunks,
                 Hyper h) {
  int t = 0;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const long long start = c * kChunk;
    while (t + 1 < ntensors && table[t + 1].offset <= start) ++t;
    const Entry e = table[t];
    const long long local = start - e.offset;
    const long long count = min(kChunk, e.numel - local);
    float* p = e.p + local;
    const float* g = e.g + local;
    float* m = e.m + local;
    float* v = e.v + local;
    const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) &
                          15) == 0;
    if (aligned && count == kChunk) {
      float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = u * kThreads + threadIdx.x;
        rp[u] = __ldcs(reinterpret_cast<const float4*>(p) + i);
        rg[u] = __ldcs(reinterpret_cast<const float4*>(g) + i);
        rm[u] = __ldcs(reinterpret_cast<const float4*>(m) + i);
        rv[u] = __ldcs(reinterpret_cast<const float4*>(v) + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) update4(rp[u], rg[u], rm[u], rv[u], h);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = u * kThreads + threadIdx.x;
        __stcs(reinterpret_cast<float4*>(p) + i, rp[u]);
        __stcs(reinterpret_cast<float4*>(m) + i, rm[u]);
        __stcs(reinterpret_cast<float4*>(v) + i, rv[u]);
      }
    } else {
      const long long vectors = aligned ? count / kVec : 0;
      for (long long i = threadIdx.x; i < vectors; i += kThreads)
        update4_at(p, g, m, v, i, h);
      for (long long i = vectors * kVec + threadIdx.x; i < count; i += kThreads)
        update_at(p, g, m, v, i, h);
    }
  }
}

}  // namespace

// Elements a chunk: each tensor's offset in the table is a multiple of it.
extern "C" long long tic_adamw_chunk_elements() { return kChunk; }

// One update of `ntensors` tensors whose table (device memory, `ntensors`
// rows, offsets rounded up to whole chunks) spans `nchunks` chunks. Launches
// on `stream` without synchronising; returns cudaGetLastError().
extern "C" int tic_adamw(const void* table, int ntensors, long long nchunks, float decay,
                         float w, float beta2, float one_minus_beta2, float bc2_sqrt,
                         float eps, float neg_step, void* stream) {
  if (nchunks <= 0 || ntensors <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = nchunks < static_cast<long long>(kBlocksPerSm) * sms
                               ? nchunks
                               : static_cast<long long>(kBlocksPerSm) * sms;
  const Hyper h{decay, w, 1.0f - w, beta2, one_minus_beta2, bc2_sqrt, eps, neg_step};
  adamw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Entry*>(table), ntensors, nchunks, h);
  return static_cast<int>(cudaGetLastError());
}
