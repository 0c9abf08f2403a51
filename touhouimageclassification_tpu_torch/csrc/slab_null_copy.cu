// Null copy of the attention slab for Hopper (sm_90a), bound to Python with
// ctypes: a measurement kernel on no path of the model (the slab null-copy
// study, S6).
//
// Replaces the two Pallas TPU kernels of tools/bench_dma.py, which time the
// data movement under the slab attention kernels without their work:
// - null_copy (:43-58, pallas_call :51): grid (B / images,), each step DMAs an
//   (images, n, 3C) block of the (B, n, 3C) slab into VMEM and writes its
//   first third;
// - null_copy_lanes (:60-75, pallas_call :67): grid (B, 3), each step reads
//   one (1, n, C) third and writes it to the image's one output block, so the
//   last write of the sequential grid (j = 2) is what stays.
//
// What it computes: out (B, n, C) = one third of a contiguous bf16 (B, n, 3C)
// slab, reading every byte of all three thirds, as the TPU block copy does.
// A block streams its rows through a ring of kStages shared-memory stages of
// kRingRows rows each, filled by 16-byte cp.async copies (a stage is consumed
// while the next two are in flight), and writes the kept third from shared
// memory with 16-byte stores. The tilings, one per template argument:
// - kRows64: 64 rows of one image a block, grid (ceil(n / 64), B), as K1
//   tiles N (the study's n197, and n208 / n256 on inputs padded to n rows);
// - kImages: `images` whole images a block, grid (ceil(B / images)): the TPU
//   study's fewer, bigger DMAs (img1, img2, img4, img4n208). On this card it
//   means fewer blocks than SMs at B 128 (128, 64, 32 blocks on 132 SMs);
// - kLanes: grid (B, 3), block (b, j) reads third j of image b; only j = 2
//   stores, so the output is the last third and no two blocks write one
//   address.
//
// What bounds it on this card: device-memory bytes, B n 3C read and B n C
// written, 2 bytes each (0.0617 ms at ViT-L B 128, n 197, at 3.35 TB/s).
#include "slab_attention_common.cuh"

namespace {

using namespace tic;
using bf16 = __nv_bfloat16;

enum class Tiling : int { kRows64 = 0, kImages = 1, kLanes = 2 };

constexpr int kRingRows = 4;  // rows of a ring stage
constexpr int kStages = 3;

// Shared memory of one block: the ring, for rows `width` elements wide (3C, or
// C for kLanes).
size_t ring_bytes(int width) {
  return static_cast<size_t>(kStages) * kRingRows * width * sizeof(bf16);
}

__device__ __forceinline__ size_t min_rows(size_t a, size_t b) { return a < b ? a : b; }

// Issues the cp.async copies of flat rows r0 ... min(r0 + kRingRows, r1), columns
// col0 ... col0 + width of each, into one ring stage; commits nothing.
__device__ __forceinline__ void fill_stage(bf16* stage, const bf16* in, size_t ld,
                                           size_t r0, size_t r1, int col0, int width) {
  const int chunks = width / 8;
  const int rows = static_cast<int>(min_rows(kRingRows, r1 - r0));
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int ch = i - r * chunks;
    mma::cp_async16(stage + r * width + 8 * ch, in + (r0 + r) * ld + col0 + 8 * ch, true);
  }
}

template <Tiling kTiling>
__global__ void __launch_bounds__(kThreads)
    null_copy_kernel(const bf16* __restrict__ in, bf16* __restrict__ out, int b, int n,
                     int c, int images) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const size_t ld = 3 * static_cast<size_t>(c);
  size_t row0, row1;  // the block's flat rows (B n of them)
  int col0 = 0, width = 3 * c;
  bool store = true;
  if constexpr (kTiling == Tiling::kRows64) {
    const size_t image = static_cast<size_t>(blockIdx.y) * n;
    row0 = image + static_cast<size_t>(kBlockRows) * blockIdx.x;
    row1 = min_rows(row0 + kBlockRows, image + n);
  } else if constexpr (kTiling == Tiling::kImages) {
    row0 = static_cast<size_t>(blockIdx.x) * images * n;
    row1 = min_rows(row0 + static_cast<size_t>(images) * n, static_cast<size_t>(b) * n);
  } else {
    row0 = static_cast<size_t>(blockIdx.x) * n;
    row1 = row0 + n;
    col0 = blockIdx.y * c;
    width = c;
    store = blockIdx.y == 2;
  }
  const int stage_elems = kRingRows * width;
  const int tiles = static_cast<int>((row1 - row0 + kRingRows - 1) / kRingRows);
  const int out_chunks = c / 8;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles)
      fill_stage(ring + t * stage_elems, in, ld, row0 + static_cast<size_t>(t) * kRingRows,
                 row1, col0, width);
    mma::cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    mma::cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();  // ... for every thread, and tile t - 1's stage is free
    const int next = t + kStages - 1;
    if (next < tiles)
      fill_stage(ring + (next % kStages) * stage_elems, in, ld,
                 row0 + static_cast<size_t>(next) * kRingRows, row1, col0, width);
    mma::cp_async_commit();
    if (store) {
      const bf16* src = ring + (t % kStages) * stage_elems;
      const size_t r0 = row0 + static_cast<size_t>(t) * kRingRows;
      const int rows = static_cast<int>(min_rows(kRingRows, row1 - r0));
      for (int i = threadIdx.x; i < rows * out_chunks; i += kThreads) {
        const int r = i / out_chunks;
        const int ch = i - r * out_chunks;
        *reinterpret_cast<uint4*>(out + (r0 + r) * c + 8 * ch) =
            *reinterpret_cast<const uint4*>(src + r * width + 8 * ch);
      }
    }
  }
  mma::cp_async_wait<0>();
}

template <Tiling kTiling>
int launch(const bf16* in, bf16* out, int b, int n, int c, int images, cudaStream_t stream) {
  const size_t smem = ring_bytes(kTiling == Tiling::kLanes ? c : 3 * c);
  auto kernel = null_copy_kernel<kTiling>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid;
  if (kTiling == Tiling::kRows64)
    grid = dim3((n + kBlockRows - 1) / kBlockRows, b);
  else if (kTiling == Tiling::kImages)
    grid = dim3((b + images - 1) / images);
  else
    grid = dim3(b, 3);
  kernel<<<grid, kThreads, smem, stream>>>(in, out, b, n, c, images);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, n, C) = the first third (tilings 0 and 1) or the last third (2) of
// a contiguous bf16 (B, n, 3C) slab; `images` whole images a block for tiling
// 1. C must be a multiple of 8 and both pointers 16-byte aligned. Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int tic_slab_null_copy(const void* qkv, void* out, int b, int n, int c,
                                  int tiling, int images, void* stream) {
  if (c % 8 != 0 || b < 1 || n < 1 || images < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tiling) {
    case 0: return launch<Tiling::kRows64>(in, o, b, n, c, images, s);
    case 1: return launch<Tiling::kImages>(in, o, b, n, c, images, s);
    case 2: return launch<Tiling::kLanes>(in, o, b, n, c, images, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
