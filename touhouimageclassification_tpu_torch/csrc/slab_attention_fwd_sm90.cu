// Attention forward for Hopper (sm_90a) on TMA and wgmma, bound to Python
// with ctypes: the route named 'wgmma' of K1, K3's forward and K4.
//
// Replaces the same three Pallas TPU kernels as slab_attention_fwd.cu
// (touhouimageclassification_tpu/ops/attention.py: _slab_fwd_kernel (K1),
// _packed_fwd_kernel (K3), _attention_kernel (K4)) for the shapes every
// model preset gives them: bf16, head dim D 64, N <= 256 tokens (ViT-L and
// ViT-B at 224x224: N 197). Other bf16 shapes stay on that file's mma.sync
// kernel, f32 on its SIMT kernel; ops/attention.py::kernel_route picks by
// shape and a launch the route cannot take fails, nothing falls back.
//
// What it computes, per image b and head h, with the TPU kernel's rounding
// points (_packed_fwd_kernel_body): S = Q_h K_h^T * D^-1/2 in f32; the exact
// two-phase softmax (m = the row max over all keys, l = sum exp(S - m),
// P = exp(S - m) * (1 / l)) in f32; P rounded to bf16 before PV, as the TPU
// kernel casts it; O_h = P V_h accumulated in f32, written as bf16 to
// out[b, :, h*D:(h+1)*D] of a contiguous (B, N, C) output. exp is exp2 of
// scores scaled by log2(e), as the mma route takes it.
//
// Operands. q, k and v are read through three 3-D tensor maps over
// (columns, N, B) with their row and batch strides, a box of 64 columns x 64
// rows x 1 image in the 128-byte swizzle (one D 64 row is 128 bytes), and a
// column offset each: the slab form (K1) encodes one map over the (B, N, 3C)
// slab and reads Q, K and V of head h at columns h*D, C + h*D and 2C + h*D;
// the three-operand form (K3, K4 on the views of the QKV slab or dense
// tensors) one map an operand. Rows at or past N of an image come back
// zero-filled from TMA's bounds on the N dimension, so nothing reads the next
// image and nothing is padded in device memory. The maps are encoded on the
// host at every launch (the operands are fresh tensors every forward).
//
// Design. What bounds the function on this card is device-memory bytes: at
// ViT-L batch 64 (N 197, 16 heads) q, k, v read once and o written once are
// 103 MB, 0.031 ms at 3.35 TB/s, against 10.2 GFLOP of the two products,
// 0.010 ms at the bf16 tensor-core rate (14.0 GFLOP issued here with the
// keys padded to 208 and the queries to 256 rows). The mma route lost to
// that bound (18-22% of it) by staging K_h and V_h once per 64-row block
// (2.5x the unique bytes at N 197), by each 4-warp block waiting for K
// before its first product, and by recomputing S in a second sweep. Here:
// - a persistent grid, one 384-thread block an SM (its shared memory and
//   registers allow one), walks over work items (image, head, part of the
//   query rows); a part is all ceil(N / 64) row blocks of a head when the
//   launch has enough items to fill the card, so K_h and V_h are staged once
//   for all of a head's rows, and 2 or 1 row blocks when B * H is small
//   (serve bucket 1-4), so that small launches still spread over the SMs;
// - warpgroup 0 is the producer: one thread keeps the TMA loads of the next
//   item in flight through a ring of two stages (Q's row blocks, K_h and V_h,
//   96 KB a stage) with a full and an empty mbarrier each, while the two
//   consumer warpgroups compute the current item. setmaxnreg moves registers
//   from the producer (40 a thread) to the consumers (232);
// - consumer warpgroup w takes row blocks w, w + 2, ... of the item, 64
//   query rows each: S = Q K^T as wgmma m64nNKk16 over the four 16-wide k
//   steps of D, Q and K both K-major from shared memory, NK the key count
//   rounded up to 64, 128, 192, 208 or 256 (a template argument: 208 at
//   N 197) with keys at or past N excluded. S stays in registers (NK / 2
//   floats a thread, 104 at N 197): the row max and the sum over the
//   thread's columns and then the quad (two shuffles), P = exp2(S c - m) / l
//   rounded to bf16 pairs in place, which are exactly wgmma's register A
//   operand; O = P V as NK / 16 wgmma m64n64k16 steps with V as the MN-major
//   B operand straight from its TMA tile. Two products, one exp2 a score;
//   the two warpgroups' softmax and products overlap each other;
// - O (f32 in registers) is rounded once to bf16, staged in the warpgroup's
//   own 8 KB of shared memory (16-byte chunks swizzled by row, conflict-free)
//   and written as 16-byte row segments, rows at or past N masked. No
//   atomics: a launch is deterministic, bit for bit.
// Shared memory: 2 stages x (4 Q tiles + 4 K tiles + 4 V tiles) x 8 KB +
// 2 x 8 KB of O staging + 4 mbarriers + 1 KB to align to the 1024 bytes the
// swizzle repeats at = 214,048 bytes (tic_slab_attention_fwd_sm90_smem_bytes),
// under the H100's 227 KB opt-in. ptxas reports 168 registers a thread at
// entry and no spills; setmaxnreg then gives the consumers 232.
//
// Measured (chip_smoke.py phase 3; NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 0.0514 ms of device time at ViT-L batch 64, 60% of the bytes bound,
// against 0.1205 for the mma.sync kernel and 0.0611 for SDPA; at bucket 1
// 0.0052 against 0.0097. What holds it above the bound is not bytes: peels
// cut from this kernel while it was designed (not kept) ran the loads alone
// well under its time, and the largest single cut was the softmax between
// the two products, then the output stores. Each consumer warpgroup runs
// S -> softmax -> PV -> store in series on 64 rows, so an SM has two such
// chains (8 warps) to hide each other's latency; a partial-sum softmax
// and a skip of the softmax for the padding rows measured slower and were
// dropped.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "slab_attention_common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace tic::sm90;
using tic::mma::pack_bf16;
using tic::mma::quad_max;
using tic::mma::quad_sum;

constexpr int kD = 64;                    // the head dim: one 128-byte row
constexpr int kRowBlock = 64;             // query rows a consumer warpgroup takes
constexpr int kMaxN = 256;
constexpr int kMaxRowBlocks = kMaxN / kRowBlock;
constexpr int kTileBytes = kRowBlock * kD * 2;  // one 64 x 64 box, 8 KB
constexpr int kQOffset = 0;                     // tiles of a stage: Q 0-3, K 4-7, V 8-11
constexpr int kKOffset = kMaxRowBlocks * kTileBytes;
constexpr int kVOffset = 2 * kMaxRowBlocks * kTileBytes;
constexpr int kStageBytes = 3 * kMaxRowBlocks * kTileBytes;  // 96 KB
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "register file");
constexpr size_t kSmemBytes =
    1024 + kStages * kStageBytes + kConsumers * kTileBytes + 2 * kStages * sizeof(uint64_t);
static_assert(kSmemBytes == 214048, "tic_slab_attention_fwd_sm90_smem_bytes");

// The keys a launch computes scores for: N rounded up to one of the widths
// the kernel is built for (wgmma's N, a multiple of 16 for the PV k steps).
// The K and V tiles loaded, ceil(NK / 64), are never wholly past N.
int key_width(int n) {
  return n <= 64 ? 64 : n <= 128 ? 128 : n <= 192 ? 192 : n <= 208 ? 208 : 256;
}

// The key width below NK: keys at or past n lie at or past it.
__host__ __device__ constexpr int mask_from(int nk) {
  return nk == 64 ? 0 : nk == 128 ? 64 : nk == 192 ? 128 : nk == 208 ? 192 : 208;
}

// 2^x on the special function unit: ex2.approx, subnormal results flushed to
// 0 (x <= 0 here: a score over its row's max; -inf gives 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One 64-row block of queries by one consumer warpgroup: O for query rows
// rb * 64 ... of image b, head h, from the stage's Q tile `q_tile` and the
// K and V tiles at `k_tile`, `v_tile` (shared addresses), through the
// warpgroup's staging `obuf`.
template <int NK>
__device__ __forceinline__ void row_block(uint32_t q_tile, uint32_t k_tile, uint32_t v_tile,
                                          uint8_t* obuf, int barrier_id, bf16* __restrict__ out,
                                          int b, int h, int rb, int n, int c,
                                          float score_scale) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;

  // S = Q K^T: four k steps of 16 through the 128-byte rows (32 bytes, two
  // descriptor units, each)
  float s[NK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(s, sw128_desc(q_tile) + 2 * kk, sw128_desc(k_tile) + 2 * kk, kk > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(s);

  // The softmax of rows g and g + 8 of the warp's 16, over the keys < n:
  // the row max and the sum over the thread's columns, then over the quad.
  // Column of s[4 j + e]: 8 j + 2 t + e % 2; only chunks j >= kMaskFrom can
  // hold keys at or past n (NK is the smallest width that holds n). Rows at
  // or past n (zero-filled queries) are computed alike and never stored.
  constexpr int kMaskFrom = mask_from(NK) / 8;
  const int lim = n - 2 * t;  // s[4 j + e] is a key iff 8 j + e % 2 < lim
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j >= kMaskFrom && 8 * j + (e & 1) >= lim) s[4 * j + e] = -INFINITY;
      mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
    }
  float m[2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(mx[r]) * score_scale;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2_ftz(fmaf(s[4 * j + e], score_scale, -m[e / 2]));
      s[4 * j + e] = x;
      l[e / 2] += x;
    }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l[r]);

  // P = e / l rounded to bf16, as the A registers of the PV k steps
  uint32_t p[NK / 16][4];
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i % 2;
      p[kk][i] = pack_bf16(s[8 * kk + 2 * i] * inv_l[r], s[8 * kk + 2 * i + 1] * inv_l[r]);
    }
  }

  // O = P V: V's 16 key rows of k step kk are 2048 bytes further
  float o[kD / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_rs_tnsp_b(o, p[kk], sw128_desc_mn(v_tile + kk * 2048), kk > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(o);

  // O through the warpgroup's staging: row r's 16-byte chunk j at chunk
  // j ^ (r % 8), so the eight rows g of a store hit eight bank groups
  named_barrier(barrier_id, 128);  // the last row block's reads are done
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int chunk = (j ^ (r0 & 7)) << 4;
    *reinterpret_cast<uint32_t*>(obuf + r0 * 128 + chunk + 4 * t) = pack_bf16(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(obuf + (r0 + 8) * 128 + chunk + 4 * t) =
        pack_bf16(o[4 * j + 2], o[4 * j + 3]);
  }
  named_barrier(barrier_id, 128);
#pragma unroll
  for (int i = 0; i < kRowBlock * 8 / 128; ++i) {
    const int x = tid + 128 * i;
    const int row = x / 8;
    const int chunk = x % 8;
    const int q = rb * kRowBlock + row;
    if (q < n)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * n + q) * c + h * kD + 8 * chunk) =
          *reinterpret_cast<const uint4*>(obuf + row * 128 + ((chunk ^ (row & 7)) << 4));
  }
}

// Work item `item` -> image, head and part (the parts of a head are `parts`
// runs of `part_blocks` row blocks).
struct Item {
  int b, h, rb0, rb1;
};
__device__ __forceinline__ Item decode(int item, int num_heads, int parts, int part_blocks,
                                       int row_blocks) {
  const int part = item % parts;
  const int bh = item / parts;
  const int rb0 = part * part_blocks;
  return {bh / num_heads, bh % num_heads, rb0, min(rb0 + part_blocks, row_blocks)};
}

template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map, int q_col,
                               int k_col, int v_col, bf16* __restrict__ out, int n,
                               int num_heads, int parts, int part_blocks, int items,
                               float score_scale) {
  constexpr int kKvTiles = (NK + kRowBlock - 1) / kRowBlock;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* obufs = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(obufs + kConsumers * kTileBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int row_blocks = (n + kRowBlock - 1) / kRowBlock;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the mbarriers are initialised

  if (wg == 0) {
    // the producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&q_map);
      prefetch_tensormap(&k_map);
      prefetch_tensormap(&v_map);
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int s = it % kStages;
        // the consumers are done with the item this stage held last
        if (it >= kStages) mbar_wait(smem_u32(&empty[s]), ((it / kStages) + 1) & 1);
        const Item w = decode(item, num_heads, parts, part_blocks, row_blocks);
        const uint32_t stage = smem_u32(smem + s * kStageBytes);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, (w.rb1 - w.rb0 + 2 * kKvTiles) * kTileBytes);
        for (int rb = w.rb0; rb < w.rb1; ++rb)
          tma_load_3d(stage + kQOffset + (rb - w.rb0) * kTileBytes, &q_map, bar,
                      q_col + w.h * kD, rb * kRowBlock, w.b);
#pragma unroll
        for (int j = 0; j < kKvTiles; ++j) {
          tma_load_3d(stage + kKOffset + j * kTileBytes, &k_map, bar, k_col + w.h * kD,
                      j * kRowBlock, w.b);
          tma_load_3d(stage + kVOffset + j * kTileBytes, &v_map, bar, v_col + w.h * kD,
                      j * kRowBlock, w.b);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int consumer = wg - 1;
    uint8_t* obuf = obufs + consumer * kTileBytes;
    const int c = num_heads * kD;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int s = it % kStages;
      mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
      const Item w = decode(item, num_heads, parts, part_blocks, row_blocks);
      const uint32_t stage = smem_u32(smem + s * kStageBytes);
      for (int rb = w.rb0 + consumer; rb < w.rb1; rb += kConsumers)
        row_block<NK>(stage + kQOffset + (rb - w.rb0) * kTileBytes, stage + kKOffset,
                      stage + kVOffset, obuf, 1 + consumer, out, w.b, w.h, rb, n, c,
                      score_scale);
      // every consumer thread, busy or not, releases the stage once an item
      mbar_arrive(smem_u32(&empty[s]));
    }
  }
}

// The SM count and the one-time shared-memory opt-in of each kernel, per
// device (the launch is short on the card; the host's calls add to it).
constexpr int kMaxDevices = 64;

int sm_count(int device) {
  static std::atomic<int> counts[kMaxDevices];
  if (device < kMaxDevices) {
    const int known = counts[device].load(std::memory_order_acquire);
    if (known) return known;
  }
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  if (device < kMaxDevices) counts[device].store(sms, std::memory_order_release);
  return sms;
}

template <int NK>
cudaError_t allow_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  const bool cached = device < kMaxDevices;
  if (cached && done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(attention_fwd_wgmma_kernel<NK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && cached) done[device].store(true, std::memory_order_release);
  return err;
}

// A (cols, N, B) bf16 tensor map at `base`, rows `row_stride` elements and
// images `batch_stride` elements apart, boxes of 64 columns x 64 rows x 1
// image in the 128-byte swizzle, zero-filled out of bounds.
bool encode(CUtensorMap* map, const void* base, long long cols, int n, int b,
            long long row_stride, long long batch_stride) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {kD, kRowBlock, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Row blocks a work item takes: a whole head (K_h and V_h staged once for all
// its rows) when that gives at least half as many items as SMs, else 2, else
// 1, so that a small launch (serve bucket 1-4) still spreads over the card.
int part_blocks_for(int b, int num_heads, int row_blocks, int sms) {
  const int candidates[3] = {row_blocks, 2, 1};
  for (int r : candidates) {
    if (r > row_blocks) continue;
    const long long items =
        static_cast<long long>(b) * num_heads * ((row_blocks + r - 1) / r);
    if (2 * items >= sms) return r;
  }
  return 1;
}

template <int NK>
int launch_nk(const CUtensorMap (&maps)[3], const int (&cols)[3], void* out, int b, int n,
              int num_heads, float scale, int device, cudaStream_t stream) {
  const cudaError_t err = allow_smem<NK>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int row_blocks = (n + kRowBlock - 1) / kRowBlock;
  const int part_blocks = part_blocks_for(b, num_heads, row_blocks, sms);
  const int parts = (row_blocks + part_blocks - 1) / part_blocks;
  const long long items = static_cast<long long>(b) * num_heads * parts;
  if (items > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sms ? items : sms);
  attention_fwd_wgmma_kernel<NK><<<grid, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], cols[0], cols[1], cols[2], static_cast<bf16*>(out), n,
      num_heads, parts, part_blocks, static_cast<int>(items),
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int launch(const CUtensorMap (&maps)[3], const int (&cols)[3], void* out, int b, int n,
           int num_heads, float scale, cudaStream_t stream) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (key_width(n)) {
    case 64: return launch_nk<64>(maps, cols, out, b, n, num_heads, scale, device, stream);
    case 128: return launch_nk<128>(maps, cols, out, b, n, num_heads, scale, device, stream);
    case 192: return launch_nk<192>(maps, cols, out, b, n, num_heads, scale, device, stream);
    case 208: return launch_nk<208>(maps, cols, out, b, n, num_heads, scale, device, stream);
    default: return launch_nk<256>(maps, cols, out, b, n, num_heads, scale, device, stream);
  }
}

// The route's limits: D 64, 1 <= N <= 256, every base 16-byte aligned and
// every stride a multiple of 16 bytes (TMA's global address and pitches).
bool takes(const void* const (&ptrs)[4], int b, int n, int d, long long batch_stride,
           long long row_stride) {
  if (d != kD || n < 1 || n > kMaxN || b < 1) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return (row_stride * 2) % 16 == 0 && (batch_stride * 2) % 16 == 0;
}

}  // namespace

// Dynamic shared memory of one block of the wgmma route at N keys and head
// dim d, or 0 for a shape the route does not take.
extern "C" size_t tic_slab_attention_fwd_sm90_smem_bytes(int n, int d) {
  return d == kD && n >= 1 && n <= kMaxN ? kSmemBytes : 0;
}

// The slab form (K1) on the wgmma route: q | k | v of a contiguous
// (B, N, 3C) bf16 slab -> out (B, N, C). Launches on `stream` without
// synchronising; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape or alignment the route does not take.
extern "C" int tic_slab_attention_fwd_sm90(const void* qkv, void* out, int b, int n,
                                           int num_heads, int d, float scale, void* stream) {
  const long long c = static_cast<long long>(num_heads) * d;
  const void* const ptrs[4] = {qkv, out, qkv, qkv};
  if (!takes(ptrs, b, n, d, 3 * n * c, 3 * c)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  if (!encode(&maps[0], qkv, 3 * c, n, b, 3 * c, 3 * n * c))
    return static_cast<int>(cudaErrorInvalidValue);
  maps[1] = maps[0];
  maps[2] = maps[0];
  const int cols[3] = {0, static_cast<int>(c), static_cast<int>(2 * c)};
  return launch(maps, cols, out, b, n, num_heads, scale, static_cast<cudaStream_t>(stream));
}

// The three-operand form (K3, K4) on the wgmma route: q, k, v with a shared
// batch stride and row stride in elements, each row holding H heads of D
// contiguous elements -> out (B, N, C) contiguous. Launches on `stream`
// without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or alignment the route does not take.
extern "C" int tic_attention_fwd_sm90(const void* q, const void* k, const void* v,
                                      long long batch_stride, int row_stride, void* out, int b,
                                      int n, int num_heads, int d, float scale, void* stream) {
  const void* const ptrs[4] = {q, k, v, out};
  if (!takes(ptrs, b, n, d, batch_stride, row_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long c = static_cast<long long>(num_heads) * d;
  CUtensorMap maps[3];
  const void* const bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!encode(&maps[i], bases[i], c, n, b, row_stride, batch_stride))
      return static_cast<int>(cudaErrorInvalidValue);
  const int cols[3] = {0, 0, 0};
  return launch(maps, cols, out, b, n, num_heads, scale, static_cast<cudaStream_t>(stream));
}
