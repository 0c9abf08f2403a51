// Patch embedding for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
// touhouimageclassification_tpu/ops/patch_embed.py::_kernel, which the ViT runs
// once per forward with patch_embed_impl='pallas'.
//
// What it computes. From NHWC images (B, H, W, C), a weight (D, K) in the
// nn.Linear layout of the port's patch projection (K = P*P*C in (ph, pw, c)
// order) and a bias (D,):
//   out[b, gy*gw + gx, d] = round(sum_k patch(b, gy, gx)[k] * W[d, k] + bias[d])
// with the products summed in f32, the f32 bias added to the f32 sum, and one
// rounding to the output type, as the TPU kernel's dot_general with
// preferred_element_type=f32 followed by "+ b.astype(f32)" and one cast.
//
// Both routes are implicit-im2col GEMMs, M = B*N output rows by D columns over
// K. Output row m = (b, gy, gx) and reduction index k = (ph, pw, c). For fixed
// ph the (pw, c) run is P*C contiguous elements of the image (48 at P 16, C 3),
// so element k of row m sits at
//   base(m) + (k / (P*C)) * W*C + k % (P*C),  base(m) = ((b*H + gy*P)*W + gx*P)*C
// and the A tile is gathered from the image by that formula: the (M, K) patch
// matrix never exists in memory. The weight is read as it is stored, (D, K)
// rows with K contiguous, which is the K-major B operand a GEMM on the tensor
// cores takes without a transpose.
//
// bf16, the route named 'wgmma' (patch_embed_wgmma_kernel). What bounds it on
// this card: at ViT-L B 64 (M 12,544, K 768, D 1024) the work is 19.7 GFLOP over
// 46.5 MB, 0.020 ms at the bf16 tensor-core rate and 0.014 ms at the memory
// rate, so a kernel that keeps the tensor cores fed is bound by operations.
// The design:
// - one block of two warpgroups computes a 128 x 128 output tile, each
//   warpgroup 64 rows with wgmma.mma_async m64n128k16 (bf16 in, f32 sums in
//   registers), both operands read from shared memory through descriptors;
// - the k loop runs over 64-element (128-byte) slabs through a ring of three
//   shared-memory stages. The weight slab of a stage comes by TMA (one 2-D
//   tensor map over (D, K), 64 x 128 box, 128-byte swizzle),
//   which completes on the stage's mbarrier; the encoder is taken from the
//   driver at run time (cudaGetDriverEntryPoint), so nothing links libcuda,
//   and the map is encoded on the host at every launch because the weight is
//   a fresh cast in every forward;
// - the image slab is gathered with 16-byte cp.async copies: P*C and W*C are
//   multiples of 8 elements, so each 16-byte chunk of k lies inside one run of
//   the image. Chunk j of tile row r is written to chunk j ^ (r % 8) of the
//   row's 128 bytes, the layout TMA's 128-byte swizzle gives the weight, so
//   one descriptor form (128B swizzle, 1024-byte row groups) reads both.
//   Rows past M and k past K are zero-filled;
// - every thread gathers (1,024 16-byte copies a slab need many threads'
//   issue slots) and the loads run two slabs ahead of the products;
//   three stages of 32 KB let two blocks share an SM, so one block's
//   epilogue and waits overlap the other's products;
// - the epilogue adds the f32 bias to the f32 sums, rounds once, stages the
//   tile in shared memory and writes it in 16-byte rows, masking the M and D
//   edges (D any size; a D that is not a multiple of 8 stores elementwise).
// The route takes P*C and W*C multiples of 8, K a multiple of 16 and 16-byte
// aligned images and weight; ops/patch_embed.py::kernel_route raises for any
// other bf16 shape, and the C entry point refuses it. On an H100 80GB HBM3
// (700 W) it takes 0.053 ms of device time at ViT-L B 64, 37% of the bound. What holds it
// there was not measured (no profiler of the SMs); each block runs only 12
// slabs, so the ring's fill and drain and the epilogue are a large share.
//
// The wgmma, descriptor, mbarrier, TMA and tensor-map helpers are sm90.cuh's,
// shared with the attention forward's wgmma route.
//
// f32, the route named 'simt' (patch_embed_simt_kernel). The tensor cores take
// f32 only as TF32, which would break the f32 bound the kernel is held to, so
// f32 stays on FMAs: blocks of 256 threads compute a 128 x 128 tile, each k
// step stages a 128 x 16 A tile and a 16 x 128 B tile in shared memory, and
// every thread accumulates an 8 x 8 sub-tile in registers. It is bound by the
// f32 FMA rate (67 TFLOP/s on an H100).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "slab_attention_common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// --- f32: the SIMT route -----------------------------------------------------

namespace simt {

constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kTileK = 16;
constexpr int kThreads = 256;        // 16 x 16 threads, 8 x 8 outputs each
constexpr int kSub = 8;
constexpr int kPad = 4;              // keeps the float4 reads aligned

__global__ void __launch_bounds__(kThreads)
    patch_embed_simt_kernel(const float* __restrict__ images,
                            const float* __restrict__ weight,
                            const float* __restrict__ bias, float* __restrict__ out,
                            int b, int h, int w, int c, int patch, int d) {
  __shared__ __align__(16) float as[kTileK][kTileM + kPad];  // A tile, k-major
  __shared__ __align__(16) float bs[kTileK][kTileN + kPad];  // B tile, k-major

  const int gw = w / patch;
  const int n = (h / patch) * gw;
  const int m_total = b * n;
  const int k_total = patch * patch * c;
  const int run = patch * c;                 // contiguous (pw, c) elements
  const size_t img_row = static_cast<size_t>(w) * c;
  const int m0 = blockIdx.y * kTileM;
  const int d0 = blockIdx.x * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;                   // output columns tx*8 ... tx*8+7
  const int ty = tid / 16;                   // output rows ty*8 ... ty*8+7

  // Each thread loads 8 elements of each tile per k step: tile rows
  // (tid / 16) + 16*j, column tid % 16. Their image offsets are fixed but for
  // k, so base(m) is computed once.
  const int lk = tid % kTileK;
  size_t a_base[kTileM / 16];
  bool a_ok[kTileM / 16];
#pragma unroll
  for (int j = 0; j < kTileM / 16; ++j) {
    const int m = m0 + tid / kTileK + 16 * j;
    a_ok[j] = m < m_total;
    const int mm = a_ok[j] ? m : 0;
    const int bi = mm / n;
    const int p = mm - bi * n;
    const int gy = p / gw;
    const int gx = p - gy * gw;
    a_base[j] = ((static_cast<size_t>(bi) * h + static_cast<size_t>(gy) * patch) * w +
                 static_cast<size_t>(gx) * patch) * c;
  }

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += kTileK) {
    const int k = k0 + lk;
    const bool k_ok = k < k_total;
    const size_t k_off = k_ok ? (k / run) * img_row + (k % run) : 0;
#pragma unroll
    for (int j = 0; j < kTileM / 16; ++j) {
      const int r = tid / kTileK + 16 * j;
      as[lk][r] = (a_ok[j] && k_ok) ? images[a_base[j] + k_off] : 0.f;
      const int dd = d0 + r;
      bs[lk][r] = (dd < d && k_ok) ? weight[static_cast<size_t>(dd) * k_total + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[kSub], bv[kSub];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * kSub]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * kSub + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * kSub]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][tx * kSub + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the next k step overwrites the tiles
  }

  // Epilogue: f32 sum + f32 bias.
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int dd = d0 + tx * kSub + j;
    if (dd >= d) continue;
    const float bj = bias[dd];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int m = m0 + ty * kSub + i;
      if (m < m_total) out[static_cast<size_t>(m) * d + dd] = acc[i][j] + bj;
    }
  }
}

int launch(const void* images, const void* weight, const void* bias, void* out, int b,
           int h, int w, int c, int patch, int d, cudaStream_t stream) {
  const int m_total = b * (h / patch) * (w / patch);
  const dim3 grid((d + kTileN - 1) / kTileN, (m_total + kTileM - 1) / kTileM);
  patch_embed_simt_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(images), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(out), b, h, w, c, patch, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// --- bf16: the wgmma route ---------------------------------------------------

namespace tc {

using namespace tic::sm90;

constexpr int kTileM = 128;                    // two warpgroups of 64 rows
constexpr int kSlabK = 64;                     // k per stage: one 128-byte row
constexpr int kRowBytes = kSlabK * 2;
constexpr int kThreads = 256;
constexpr int kATileBytes = kTileM * kRowBytes;  // 16 KB
constexpr int kChunksPerThread = kTileM * (kRowBytes / 16) / kThreads;  // 4
// A 128 x 128 tile through three stages (96 KB), so two blocks share an SM
// and one's epilogue overlaps the other's products.
constexpr int kBlockN = 128;
constexpr int kStages = 3;
constexpr int kBTileBytes = kBlockN * kRowBytes;
constexpr int kStageBytes = kATileBytes + kBTileBytes;
constexpr int kOutPitch = kBlockN + 8;  // staged output rows, in elements
static_assert(kTileM * kOutPitch * 2 <= kStages * kStageBytes, "output stage");
// Dynamic shared memory of one block: the stages, one mbarrier each, and the
// slack to align the stages on the 1024 bytes the 128-byte swizzle repeats at.
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + 8 * kStages;

// Epilogue of the 128 x 128 tile, once both warpgroups are done with the
// stages. Accumulator layout of m64n128k16 (warp q of the warpgroup,
// lane = 4 g + t): acc[4 i + e] is row 16 q + g + 8 (e / 2), column
// 8 i + 2 t + e % 2. Sum + f32 bias, one rounding, into the tile staged at
// `smem` (pitch kBlockN + 8: the eight rows g of a store fall on different
// banks), then 16-byte rows to `out`, masked at the M and D edges.
__device__ __forceinline__ void store_tile(const float (&acc)[64], uint8_t* smem,
                                           const bf16* __restrict__ bias,
                                           bf16* __restrict__ out, int m0, int d0,
                                           int m_total, int d) {
  const int tid = threadIdx.x;
  bf16* staged = reinterpret_cast<bf16*>(smem);
  const int lane = tid % 32;
  const int row = (tid / 128) * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < kBlockN / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    const float b0 = d0 + col < d ? __bfloat162float(bias[d0 + col]) : 0.f;
    const float b1 = d0 + col + 1 < d ? __bfloat162float(bias[d0 + col + 1]) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(staged + row * kOutPitch + col) =
        __floats2bfloat162_rn(acc[4 * i] + b0, acc[4 * i + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(staged + (row + 8) * kOutPitch + col) =
        __floats2bfloat162_rn(acc[4 * i + 2] + b0, acc[4 * i + 3] + b1);
  }
  __syncthreads();
  constexpr int kChunks = kBlockN / 8;
  const bool rows_aligned = d % 8 == 0;
  for (int x = tid; x < kTileM * kChunks; x += kThreads) {
    const int r = x / kChunks;
    const int col = 8 * (x - r * kChunks);
    const int m = m0 + r;
    if (m >= m_total || d0 + col >= d) continue;
    bf16* dst = out + static_cast<size_t>(m) * d + d0 + col;
    const bf16* src = staged + r * kOutPitch + col;
    if (rows_aligned && d0 + col + 8 <= d) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && d0 + col + e < d; ++e) dst[e] = src[e];
    }
  }
}

// One slab of the 128 x 128 tile's k loop on the tensor cores, by one
// warpgroup (rows 64 wg ... 64 wg + 63) on the stage at shared address
// `stage`: four m64n128k16 steps, each 32 bytes further into the 128-byte
// rows (2 units of the descriptor's address).
__device__ __forceinline__ void mma_slab(float (&acc)[64], uint32_t stage, int wg) {
  const uint64_t a_desc = sw128_desc(stage + wg * 64 * kRowBytes);
  const uint64_t b_desc = sw128_desc(stage + kATileBytes);
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kSlabK / 16; ++kk)
    wgmma_ss(acc, a_desc + 2 * kk, b_desc + 2 * kk, 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
    patch_embed_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                             const bf16* __restrict__ images, const bf16* __restrict__ bias,
                             bf16* __restrict__ out, int h, int w, int c, int patch,
                             int m_total, int d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);

  const int tid = threadIdx.x;
  const int gw = w / patch;
  const int n_img = (h / patch) * gw;
  const int k_total = patch * patch * c;
  const int run = patch * c;
  const size_t img_row = static_cast<size_t>(w) * c;
  const int num_k = (k_total + kSlabK - 1) / kSlabK;
  const int m0 = blockIdx.y * kTileM;
  const int d0 = blockIdx.x * kBlockN;

  if (tid == 0) {
    prefetch_tensormap(&w_map);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The thread's part of the gather: 16-byte chunk j of tile rows
  // tid / 8 + 32 i. Their image offsets are fixed but for k, and their
  // swizzled places in a stage are fixed (r % 8 is the same for every i).
  const int j = tid % 8;
  size_t a_base[kChunksPerThread];
  uint32_t a_dst[kChunksPerThread];
  bool a_ok[kChunksPerThread];
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const int r = tid / 8 + 32 * i;
    const int m = m0 + r;
    a_ok[i] = m < m_total;
    const int mm = a_ok[i] ? m : 0;
    const int bi = mm / n_img;
    const int p = mm - bi * n_img;
    const int gy = p / gw;
    const int gx = p - gy * gw;
    a_base[i] = ((static_cast<size_t>(bi) * h + static_cast<size_t>(gy) * patch) * w +
                 static_cast<size_t>(gx) * patch) * c;
    a_dst[i] = r * kRowBytes + ((j ^ (r & 7)) << 4);
  }
  __syncthreads();  // the mbarriers are initialised

  // Issues the loads of k slab `kt` into stage `s`: the image chunks by
  // every thread (not committed here), the weight box by thread 0.
  auto load = [&](int kt, int s) {
    uint8_t* stage = smem + s * kStageBytes;
    const int k = kt * kSlabK + 8 * j;
    const bool k_ok = k < k_total;
    const size_t k_off = k_ok ? static_cast<size_t>(k / run) * img_row + (k % run) : 0;
#pragma unroll
    for (int i = 0; i < kChunksPerThread; ++i) {
      const bool ok = a_ok[i] && k_ok;
      tic::mma::cp_async16(stage + a_dst[i], images + (ok ? a_base[i] + k_off : 0), ok);
    }
    if (tid == 0) {
      const uint32_t bar = smem_u32(&full[s]);
      mbar_expect_tx(bar, kBTileBytes);
      tma_load_2d(smem_u32(stage + kATileBytes), &w_map, bar, kt * kSlabK, d0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_k) load(s, s);
    tic::mma::cp_async_commit();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int wg = tid / 128;
  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt % kStages;
    // one commit group per slab: slab kt's is complete when at most
    // kStages - 2 younger ones are pending
    tic::mma::cp_async_wait<kStages - 2>();
    fence_proxy_async();
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    // every thread's chunks of slab kt have landed, and both warpgroups are
    // done with slab kt - 1, whose stage the next load takes
    __syncthreads();
    if (kt + kStages - 1 < num_k) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    tic::mma::cp_async_commit();

    mma_slab(acc, smem_u32(smem + s * kStageBytes), wg);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
  }

  __syncthreads();  // both warpgroups are done with the stages
  store_tile(acc, smem, bias, out, m0, d0, m_total, d);
}

// The route's limits: 16-byte image chunks inside one (pw, c) run and one
// image row, whole k16 steps, 16-byte aligned images and weight (TMA's
// global address and row pitch).
bool takes(const void* images, const void* weight, int w, int c, int patch) {
  return (patch * c) % 8 == 0 && (w * c) % 8 == 0 && (patch * patch * c) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(images) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(weight) % 16 == 0;
}

// Lets the kernel take its 96 KB of dynamic shared memory, once a device:
// the size is fixed, and the call costs host time on a launch that is
// shorter on the card than on the host.
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && done[device].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(patch_embed_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && cached) done[device].store(true, std::memory_order_release);
  return err;
}

int launch(const void* images, const void* weight, const void* bias, void* out, int b, int h,
           int w, int c, int patch, int d, cudaStream_t stream) {
  if (!takes(images, weight, w, c, patch)) return static_cast<int>(cudaErrorInvalidValue);
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int k = patch * patch * c;
  // the weight, (D, K) row-major: K innermost, rows 2K bytes apart; boxes of
  // 64 k by kBlockN rows, zero-filled past K and D
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(d)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {kSlabK, kBlockN};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(weight), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_total = b * (h / patch) * (w / patch);
  const dim3 grid((d + kBlockN - 1) / kBlockN, (m_total + kTileM - 1) / kTileM);
  patch_embed_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      map, static_cast<const bf16*>(images), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), h, w, c, patch, m_total, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// images (B, H, W, C), weight (D, P*P*C), bias (D,) and out (B, N, D), all
// contiguous and of one type (0 = float32: the SIMT route; 1 = bfloat16: the
// wgmma route); H and W multiples of P. Launches on `stream` without
// synchronising; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// bf16 shape or alignment the wgmma route does not take.
extern "C" int tic_patch_embed(const void* images, const void* weight, const void* bias,
                               void* out, int b, int h, int w, int c, int patch, int d,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return simt::launch(images, weight, bias, out, b, h, w, c, patch, d, s);
  if (dtype == 1)
    return tc::launch(images, weight, bias, out, b, h, w, c, patch, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
