// LayerNorm over the last dimension, forward and backward (N1), for Hopper
// (sm_90a), bound to Python with ctypes (ops/layernorm.py).
//
// It replaces no Pallas kernel: the JAX model's LayerNorm is flax's
// LayerNorm(dtype=compute, param_dtype=float32), which XLA fuses with the
// casts around it. The port computed it as F.layer_norm(x.float(), ...)
// .to(x.dtype): an f32 copy of the activation, aten's f32 kernels, a copy
// back, and in the backward an f32 copy of the gradient, aten's two
// backward kernels and a copy of dx back to the compute dtype.
//
// What it computes, each row of `width` elements, in f32 registers with one
// rounding of each output:
//   mean = sum(x) / width,  var = sum((x - mean)^2) / width,
//   rstd = 1 / sqrt(var + eps),  y = (x - mean) rstd gamma + beta;
//   backward, with xh = (x - mean) rstd and g = dy gamma:
//   dx = rstd (g - mean(g) - xh mean(g xh)),
//   dgamma = sum over rows of dy xh,  dbeta = sum over rows of dy.
// x and dx are bf16 or f32; y and dy bf16 or f32 independently (V-MoE's
// router reads an f32 y of a bf16 x); gamma, beta and their gradients f32.
//
// What bounds it: nothing is reused within a call, so bytes. In bf16 the
// forward reads x and writes y (4 B an element) and the backward reads x
// and dy and writes dx (6 B), plus 8 B a row of statistics. The design,
// for the bandwidth:
// - the row is held in registers: a warp's lane l holds the vectors
//   l, l + 32, ... of kVec elements (16 bytes of x), so each of the warp's
//   loads is 512 contiguous bytes; the mean, then the variance of
//   (x - mean), are two reductions over those registers, with no second
//   read of x;
// - one warp a row up to 1024 elements (8 or 32 a lane); a wider row, up to
//   4096, is split over the block's four warps (kParts), which add their
//   sums through shared memory;
// - a persistent grid (as many blocks as fit on the SMs, fewer for few
//   rows) whose warps walk the rows;
// - the backward sums dgamma and dbeta of its rows in registers, reduces
//   a block's row groups through shared memory in a fixed order and writes
//   one (2, width) row a block to a scratch that a second small kernel sums
//   in a fixed order: no atomic adds, so a call gives the same bits every time;
// - a width that is not a multiple of kVec, or a pointer that is not
//   16-byte aligned, takes the same kernels with one element a vector.
// Lanes past the width are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWidth = 4096;
constexpr int kReduceWarps = 8;
constexpr int kDevices = 64;  // devices whose grid sizes are kept

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N elements of T as whole aligned packs of at most 16 bytes.
template <typename T, int N>
struct Packs {
  static constexpr int kPack = (N * sizeof(T) > 16) ? 16 / sizeof(T) : N;
  static constexpr int kCount = N / kPack;
  struct alignas(kPack * sizeof(T)) Pack {
    T v[kPack];
  };
};

template <int N, typename T>
__device__ __forceinline__ void load(const T* __restrict__ p, float* out) {
  using P = Packs<T, N>;
#pragma unroll
  for (int i = 0; i < P::kCount; ++i) {
    const typename P::Pack r = reinterpret_cast<const typename P::Pack*>(p)[i];
#pragma unroll
    for (int k = 0; k < P::kPack; ++k) out[i * P::kPack + k] = to_float(r.v[k]);
  }
}

template <int N, typename T>
__device__ __forceinline__ void store(T* __restrict__ p, const float* in) {
  using P = Packs<T, N>;
#pragma unroll
  for (int i = 0; i < P::kCount; ++i) {
    typename P::Pack r;
#pragma unroll
    for (int k = 0; k < P::kPack; ++k) r.v[k] = from_float<T>(in[i * P::kPack + k]);
    reinterpret_cast<typename P::Pack*>(p)[i] = r;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where a row lives: kPer elements a lane in vectors of kVec, kParts warps
// a row (1, or the whole block). Part p's lane l holds vector j of the row
// at element ((p * kVecs + j) * 32 + l) * kVec.
template <int kVec, int kPer, int kParts>
struct Layout {
  static_assert(kParts == 1 || kParts == kWarps, "a row is one warp or the block");
  static constexpr int kVecs = kPer / kVec;
  static constexpr int kRowsPerBlock = kWarps / kParts;
  static constexpr int kSpan = 32 * kPer * kParts;  // elements a row can hold
  int lane, part, group;
  __device__ Layout()
      : lane(threadIdx.x & 31),
        part((threadIdx.x / 32) % kParts),
        group((threadIdx.x / 32) / kParts) {}
  __device__ int column(int j) const { return ((part * kVecs + j) * 32 + lane) * kVec; }
};

// Each of the kN sums over a row's parts (every part gets them); `red`
// holds kN floats a part. With the block on one row, every thread calls it.
template <int kParts, int kN>
__device__ __forceinline__ void row_sums(float (&v)[kN], float* red, int part, int lane) {
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = warp_sum(v[i]);
  if constexpr (kParts > 1) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kN; ++i) red[kN * part + i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      v[i] = 0.0f;
#pragma unroll
      for (int p = 0; p < kParts; ++p) v[i] += red[kN * p + i];
    }
    __syncthreads();
  }
}

template <typename TIn, typename TOut, int kVec, int kPer, int kParts>
__global__ void __launch_bounds__(kThreads)
    tic_layernorm_fwd_kernel(const TIn* __restrict__ x, const float* __restrict__ gamma,
                             const float* __restrict__ beta, TOut* __restrict__ y,
                             float* __restrict__ mean_out, float* __restrict__ rstd_out,
                             long long rows, int width, float eps) {
  using L = Layout<kVec, kPer, kParts>;
  __shared__ float red[kParts];
  const L at;
  const long long stride = static_cast<long long>(gridDim.x) * L::kRowsPerBlock;
  const float n = static_cast<float>(width);
  for (long long row = static_cast<long long>(blockIdx.x) * L::kRowsPerBlock + at.group;
       row < rows; row += stride) {
    const TIn* xr = x + row * width;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < L::kVecs; ++j) {
      const int c = at.column(j);
      if (c < width) {
        load<kVec>(xr + c, v + j * kVec);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[j * kVec + k] = 0.0f;
      }
    }
    float s[1] = {0.0f};
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[0] += v[i];
    row_sums<kParts>(s, red, at.part, at.lane);
    const float mean = __fdiv_rn(s[0], n);
    float q[1] = {0.0f};
#pragma unroll
    for (int j = 0; j < L::kVecs; ++j) {
      if (at.column(j) < width) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float d = v[j * kVec + k] - mean;
          q[0] = __fmaf_rn(d, d, q[0]);
        }
      }
    }
    row_sums<kParts>(q, red, at.part, at.lane);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fdiv_rn(q[0], n) + eps));
    if (at.lane == 0 && at.part == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
    TOut* yr = y + row * width;
#pragma unroll
    for (int j = 0; j < L::kVecs; ++j) {
      const int c = at.column(j);
      if (c < width) {
        float g[kVec], b[kVec], o[kVec];
        load<kVec>(gamma + c, g);
        load<kVec>(beta + c, b);
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          o[k] = __fmaf_rn((v[j * kVec + k] - mean) * rstd, g[k], b[k]);
        store<kVec>(yr + c, o);
      }
    }
  }
}

// dx of each row, and each block's sums of dy xh and dy over its rows in
// partial[block][0 | 1][column].
template <typename TX, typename TDY, int kVec, int kPer, int kParts>
__global__ void __launch_bounds__(kThreads)
    tic_layernorm_bwd_kernel(const TX* __restrict__ x, const TDY* __restrict__ dy,
                             const float* __restrict__ mean_in,
                             const float* __restrict__ rstd_in,
                             const float* __restrict__ gamma, TX* __restrict__ dx,
                             float* __restrict__ partial, long long rows, int width) {
  using L = Layout<kVec, kPer, kParts>;
  __shared__ float sums[2 * L::kSpan];
  __shared__ float red[2 * kParts];
  const L at;
  const long long stride = static_cast<long long>(gridDim.x) * L::kRowsPerBlock;
  const float n = static_cast<float>(width);
  float dg[kPer], db[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dg[i] = db[i] = 0.0f;
  for (long long row = static_cast<long long>(blockIdx.x) * L::kRowsPerBlock + at.group;
       row < rows; row += stride) {
    const TX* xr = x + row * width;
    const TDY* dyr = dy + row * width;
    float xh[kPer], g[kPer];
#pragma unroll
    for (int j = 0; j < L::kVecs; ++j) {
      const int c = at.column(j);
      if (c < width) {
        load<kVec>(xr + c, xh + j * kVec);
        load<kVec>(dyr + c, g + j * kVec);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) xh[j * kVec + k] = g[j * kVec + k] = 0.0f;
      }
    }
    const float mean = mean_in[row];
    const float rstd = rstd_in[row];
    float sg[2] = {0.0f, 0.0f};  // sums of g and of g xh
#pragma unroll
    for (int j = 0; j < L::kVecs; ++j) {
      const int c = at.column(j);
      if (c < width) {
        float w[kVec];
        load<kVec>(gamma + c, w);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int i = j * kVec + k;
          const float h = (xh[i] - mean) * rstd;
          const float d = g[i];
          dg[i] = __fmaf_rn(d, h, dg[i]);
          db[i] += d;
          xh[i] = h;
          g[i] = d * w[k];
          sg[0] += g[i];
          sg[1] = __fmaf_rn(g[i], h, sg[1]);
        }
      }
    }
    row_sums<kParts>(sg, red, at.part, at.lane);
    const float mg = __fdiv_rn(sg[0], n);
    const float mgx = __fdiv_rn(sg[1], n);
    TX* dxr = dx + row * width;
#pragma unroll
    for (int j = 0; j < L::kVecs; ++j) {
      const int c = at.column(j);
      if (c < width) {
        float o[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int i = j * kVec + k;
          o[k] = rstd * (g[i] - mg - xh[i] * mgx);
        }
        store<kVec>(dxr + c, o);
      }
    }
  }
  // the block's row groups in order: group 0 writes, each next one adds
  for (int grp = 0; grp < L::kRowsPerBlock; ++grp) {
    if (at.group == grp) {
#pragma unroll
      for (int j = 0; j < L::kVecs; ++j) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int i = j * kVec + k;
          const int c = at.column(j) + k;
          sums[c] = grp == 0 ? dg[i] : sums[c] + dg[i];
          sums[L::kSpan + c] = grp == 0 ? db[i] : sums[L::kSpan + c] + db[i];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * width;
  for (int c = threadIdx.x; c < width; c += kThreads) {
    out[c] = sums[c];
    out[width + c] = sums[L::kSpan + c];
  }
}

// dgamma and dbeta: the sums of partial's `blocks` rows of 2 * width columns,
// each column's rows taken in order by one warp a stripe and the stripes in
// order.
__global__ void __launch_bounds__(32 * kReduceWarps)
    tic_layernorm_dparams_kernel(const float* __restrict__ partial, int blocks, int width,
                                 float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float stripes[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const int columns = 2 * width;
  float s = 0.0f;
  if (c < columns)
    for (int b = warp; b < blocks; b += kReduceWarps)
      s += partial[static_cast<long long>(b) * columns + c];
  stripes[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < columns) {
    float t = stripes[0][lane];
#pragma unroll
    for (int w = 1; w < kReduceWarps; ++w) t += stripes[w][lane];
    if (c < width)
      dgamma[c] = t;
    else
      dbeta[c - width] = t;
  }
}

// The persistent grid: as many blocks of `kernel` as fit on the device's
// SMs, at most one for each `per_block` rows. `fits` keeps each device's
// count for the kernel, so the occupancy query runs once a kernel and device.
template <typename Kernel>
cudaError_t grid_of(Kernel kernel, std::atomic<int> (&fits)[kDevices], long long rows,
                    int per_block, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int fit = device < kDevices ? fits[device].load(std::memory_order_relaxed) : 0;
  if (fit == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    fit = sms * (per_sm > 0 ? per_sm : 1);
    if (device < kDevices) fits[device].store(fit, std::memory_order_relaxed);
  }
  const long long need = (rows + per_block - 1) / per_block;
  *blocks = static_cast<int>(need < fit ? need : fit);
  return cudaSuccess;
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// op.run<kVec, kPer, kParts>() for the layout of `width` on the 16-byte
// route of T (`vec`) or the one-element route.
template <typename T, typename Op>
int dispatch(int width, bool vec, const Op& op) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    if (width <= 256) return op.template run<kVec, 8, 1>();
    if (width <= 1024) return op.template run<kVec, 32, 1>();
    return op.template run<kVec, 32, kWarps>();
  }
  if (width <= 256) return op.template run<1, 8, 1>();
  if (width <= 1024) return op.template run<1, 32, 1>();
  return op.template run<1, 32, kWarps>();
}

template <typename TIn, typename TOut>
struct FwdLaunch {
  const void *x, *gamma, *beta;
  void *y, *mean, *rstd;
  long long rows;
  int width;
  float eps;
  cudaStream_t stream;
  template <int kVec, int kPer, int kParts>
  int run() const {
    static std::atomic<int> fits[kDevices];
    int blocks = 0;
    const cudaError_t err = grid_of(tic_layernorm_fwd_kernel<TIn, TOut, kVec, kPer, kParts>,
                                    fits, rows, kWarps / kParts, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    tic_layernorm_fwd_kernel<TIn, TOut, kVec, kPer, kParts><<<blocks, kThreads, 0, stream>>>(
        static_cast<const TIn*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<TOut*>(y), static_cast<float*>(mean),
        static_cast<float*>(rstd), rows, width, eps);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename TX, typename TDY>
struct BwdBlocks {
  long long rows;
  int* blocks;
  template <int kVec, int kPer, int kParts>
  int run() const {
    static std::atomic<int> fits[kDevices];
    return static_cast<int>(grid_of(tic_layernorm_bwd_kernel<TX, TDY, kVec, kPer, kParts>,
                                    fits, rows, kWarps / kParts, blocks));
  }
};

template <typename TX, typename TDY>
struct BwdLaunch {
  const void *x, *dy, *mean, *rstd, *gamma;
  void *dx, *partial;
  int blocks;
  long long rows;
  int width;
  cudaStream_t stream;
  template <int kVec, int kPer, int kParts>
  int run() const {
    tic_layernorm_bwd_kernel<TX, TDY, kVec, kPer, kParts><<<blocks, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TDY*>(dy),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const float*>(gamma), static_cast<TX*>(dx), static_cast<float*>(partial),
        rows, width);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename TIn, typename TOut>
int fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean, void* rstd,
        long long rows, int width, float eps, cudaStream_t stream) {
  const bool vec = width % (16 / sizeof(TIn)) == 0 && aligned(x) && aligned(gamma) &&
                   aligned(beta) && aligned(y);
  return dispatch<TIn>(width, vec, FwdLaunch<TIn, TOut>{x, gamma, beta, y, mean, rstd, rows,
                                                        width, eps, stream});
}

template <typename TX>
bool bwd_vec(const void* x, const void* dy, const void* gamma, const void* dx, int width) {
  return width % (16 / sizeof(TX)) == 0 && aligned(x) && aligned(dy) && aligned(gamma) &&
         aligned(dx);
}

template <typename TX, typename TDY>
int bwd_blocks(const void* x, const void* dy, const void* gamma, const void* dx,
               long long rows, int width, int* blocks) {
  return dispatch<TX>(width, bwd_vec<TX>(x, dy, gamma, dx, width),
                      BwdBlocks<TX, TDY>{rows, blocks});
}

template <typename TX, typename TDY>
int bwd(const void* x, const void* dy, const void* mean, const void* rstd, const void* gamma,
        void* dx, void* partial, int blocks, void* dgamma, void* dbeta, long long rows,
        int width, cudaStream_t stream) {
  const int err = dispatch<TX>(
      width, bwd_vec<TX>(x, dy, gamma, dx, width),
      BwdLaunch<TX, TDY>{x, dy, mean, rstd, gamma, dx, partial, blocks, rows, width, stream});
  if (err) return err;
  tic_layernorm_dparams_kernel<<<(2 * width + 31) / 32, 32 * kReduceWarps, 0, stream>>>(
      static_cast<const float*>(partial), blocks, width, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return static_cast<int>(cudaGetLastError());
}

// dtype codes of ops/layernorm.py: 0 float32, 1 bfloat16
bool valid(long long rows, int width, int a, int b) {
  return rows > 0 && width > 0 && width <= kMaxWidth && (a == 0 || a == 1) &&
         (b == 0 || b == 1);
}

}  // namespace

extern "C" int tic_layernorm_max_width() { return kMaxWidth; }

// y (rows, width) of out_dtype from x (rows, width) of in_dtype, and each
// row's mean and rstd (f32).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int tic_layernorm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                 void* mean, void* rstd, long long rows, int width, float eps,
                                 int in_dtype, int out_dtype, void* stream) {
  if (!valid(rows, width, in_dtype, out_dtype)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_dtype == 1)
    return out_dtype == 1 ? fwd<bf16, bf16>(x, gamma, beta, y, mean, rstd, rows, width, eps, s)
                          : fwd<bf16, float>(x, gamma, beta, y, mean, rstd, rows, width, eps, s);
  return out_dtype == 1 ? fwd<float, bf16>(x, gamma, beta, y, mean, rstd, rows, width, eps, s)
                        : fwd<float, float>(x, gamma, beta, y, mean, rstd, rows, width, eps, s);
}

// Blocks of the backward's persistent grid for these pointers and sizes: the
// rows of the (blocks, 2, width) f32 scratch that tic_layernorm_bwd takes;
// minus a CUDA error.
extern "C" int tic_layernorm_bwd_blocks(const void* x, const void* dy, const void* gamma,
                                        const void* dx, long long rows, int width,
                                        int x_dtype, int dy_dtype) {
  if (!valid(rows, width, x_dtype, dy_dtype)) return -static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  int blocks = 0, err = 0;
  if (x_dtype == 1)
    err = dy_dtype == 1 ? bwd_blocks<bf16, bf16>(x, dy, gamma, dx, rows, width, &blocks)
                        : bwd_blocks<bf16, float>(x, dy, gamma, dx, rows, width, &blocks);
  else
    err = dy_dtype == 1 ? bwd_blocks<float, bf16>(x, dy, gamma, dx, rows, width, &blocks)
                        : bwd_blocks<float, float>(x, dy, gamma, dx, rows, width, &blocks);
  return err ? -err : blocks;
}

// dx (rows, width) of x_dtype and dgamma, dbeta (width, f32) from x, dy
// (dy_dtype), the forward's mean and rstd and gamma, through `partial`, a
// (blocks, 2, width) f32 scratch of tic_layernorm_bwd_blocks's rows.
// Launches two kernels on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int tic_layernorm_bwd(const void* x, const void* dy, const void* mean,
                                 const void* rstd, const void* gamma, void* dx, void* partial,
                                 int blocks, void* dgamma, void* dbeta, long long rows,
                                 int width, int x_dtype, int dy_dtype, void* stream) {
  if (!valid(rows, width, x_dtype, dy_dtype) || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 1)
    return dy_dtype == 1 ? bwd<bf16, bf16>(x, dy, mean, rstd, gamma, dx, partial, blocks, dgamma,
                                           dbeta, rows, width, s)
                         : bwd<bf16, float>(x, dy, mean, rstd, gamma, dx, partial, blocks,
                                            dgamma, dbeta, rows, width, s);
  return dy_dtype == 1 ? bwd<float, bf16>(x, dy, mean, rstd, gamma, dx, partial, blocks, dgamma,
                                          dbeta, rows, width, s)
                       : bwd<float, float>(x, dy, mean, rstd, gamma, dx, partial, blocks,
                                           dgamma, dbeta, rows, width, s);
}
