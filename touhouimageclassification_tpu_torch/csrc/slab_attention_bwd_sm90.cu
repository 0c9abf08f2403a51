// Attention backward for Hopper (sm_90a) on TMA and wgmma, bound to Python
// with ctypes: the route named 'wgmma' of K2 and K3's backward.
//
// Replaces the same two Pallas TPU kernels as slab_attention_bwd.cu
// (touhouimageclassification_tpu/ops/attention.py: _slab_bwd_kernel (K2),
// _packed_bwd_kernel (K3's VJP), both through _packed_bwd_kernel_body) for
// the shapes every model preset gives them: bf16, head dim D 64, N <= 256
// tokens (ViT-L and ViT-B at 224x224: N 197). Other bf16 shapes stay on that
// file's mma.sync kernel, f32 on its SIMT kernel; ops/attention.py::
// kernel_route picks by shape and a launch the route cannot take fails,
// nothing falls back.
//
// What it computes, per image b and head h, with the TPU kernel's rounding
// points (as slab_attention_bwd.cu states them):
//   S  = Q_h K_h^T * D^-1/2 in f32; the exact softmax P in f32 (m = the row
//        max over all keys, P = exp2(S log2(e) - m) / l, exp2 on scores scaled
//        by log2(e) as both attention routes take it);
//   dP = g_h V_h^T in f32;  D_i = rowsum(P o dP) from the f32 P and dP (not
//        rowsum(g o O), which would read the rounded O);
//   dS = P o (dP - D_i);  dS and P rounded to bf16, then
//   dQ = dS K_h * scale,  dK = dS^T Q_h * scale,  dV = P^T g_h,
// accumulated in f32 and rounded once to bf16. Neither P nor dS reaches
// device memory. No atomics and a fixed order: a launch is deterministic,
// bit for bit.
//
// Operands. q, k, v and g are read through 3-D tensor maps over (columns, N,
// B), a box of 64 columns x 64 rows x 1 image in the 128-byte swizzle (one
// D 64 row is 128 bytes): the slab form (K2) encodes one map over the
// (B, N, 3C) slab (Q, K, V of head h at columns h*D, C + h*D, 2C + h*D) and
// one over g; the three-operand form (K3) one map an operand. Rows at or past
// N come back zero-filled from TMA's bounds, so nothing is padded in device
// memory. The gradients go to [dQ | dK | dV] of a (B, N, 3C) slab or to three
// outputs, through the same strides.
//
// Design. What bounds the function on this card is device-memory bytes: at
// ViT-L batch 64 (N 197, 16 heads) q, k, v and g read once and three
// gradients written once are 181 MB, 0.054 ms at 3.35 TB/s, against 25.4
// GFLOP of the five products the function needs, 0.026 ms at the bf16
// tensor-core rate (55.8 GFLOP issued here: eight products, the rows padded
// to whole 64-row blocks, the keys and queries of a chunk to 208). The
// mma.sync route reached 20% of the bytes bound: each 64-row block re-staged
// two whole head operands (four times a head and pass at N 197), it issued
// nine products with their fragment loads, and its statistics made a round
// trip through device memory between its two launches. Here:
// - a persistent grid, one 384-thread block an SM, walks over work items;
//   an item is one (image, head) with its Q_h, K_h, V_h and g_h of all N
//   rows loaded ONCE by TMA into one 128 KB stage (4 operands x 4 tiles of
//   64 x 64 bf16). Warpgroup 0 is the producer (one thread issues the loads
//   of the next item as soon as the consumers release the stage; setmaxnreg
//   gives it 40 registers a thread), warpgroups 1 and 2 the consumers (232);
// - phase A, query-row blocks (consumer w takes blocks w and w + 2):
//   S = Q K^T as wgmma m64nNKk16 (NK the key count rounded up to 64, 128,
//   192, 208 or 256; keys at or past N masked) held in registers (NK / 2
//   floats a thread), the exact m and l, P in f32 in place; a sweep over
//   64-key chunks of dP = g V^T (m64n64k16, the last chunk m64n16k16 at NK
//   208) sums P o dP into D_i; a second sweep recomputes each dP chunk, forms
//   dS = P (dP - D_i) rounded in place to bf16 pairs, which are wgmma's
//   register A, and accumulates dQ += dS K with K's own TMA tile as the
//   MN-major B operand. m, 1 / l and D_i of every query row go to shared
//   memory (rows at or past N get 1 / l = 0, so their P^T below is 0);
// - a named barrier across both consumers;
// - phase B, key-row blocks (consumer w takes blocks w and w + 2), over
//   chunks of 64 queries (16 for the last at NK 208): S^T = K Q^T and
//   dP^T = V g^T (both operands K-major, exactly as the tiles lie),
//   P^T = exp2(S^T log2(e) / sqrt(D) - m_q) / l_q with the statistics
//   broadcast along the columns, dS^T = P^T o (dP^T - D_q), both rounded to
//   bf16 register A; dV += P^T g and dK += dS^T Q with g and Q MN-major.
//   Phase B forms S^T with K as the A operand where phase A formed S with Q
//   as A, so the tensor cores may sum each score in another order: nothing
//   makes phase B's P equal phase A's bit for bit (chip_smoke.py reads the
//   gap through the mma.sync kernel's probes, the same situation);
// - each gradient block (f32 in registers) is rounded once to bf16, staged
//   in the warpgroup's own 8 KB of shared memory (16-byte chunks swizzled by
//   row, conflict-free) and written as 16-byte row segments, rows at or past
//   N masked.
// Eight products (S and dP in both phases, dP twice in phase A, dQ, dK, dV)
// against the mma.sync kernel's nine, every one on wgmma from TMA tiles, no
// fragment loads, and at large B * H one launch with no statistics in device
// memory.
//
// Small launches. At B * H below half the SM count (ViT-B batch 2 and 4 in
// the mixtures' train step, ViT-L batch 1-4) one item a head would leave most
// SMs idle. There the work is split over two launches of the same kernel:
// the first takes items of (image, head, row blocks), runs phase A and writes
// m, 1 / l and D_i of the rows < N to the (3, B, H, N) f32 scratch the
// wrapper allocates; the second takes items of (image, head, key-row blocks),
// reads them back and runs phase B. An item holds two blocks (one a
// consumer), or one (consumer 1 idle) where B * H * ceil(N / 64) blocks fit
// the SMs one each: a consumer alone on its SM shares no tensor cores and no
// special function unit, and that launch's time is one block's. The rule
// depends on the shape and the card's SM count only, and every form gives
// the same bits: the statistics cross device memory as f32, unchanged, and
// each phase's arithmetic is the same code.
//
// Shared memory: one stage of 16 tiles x 8 KB + 2 x 8 KB of gradient staging
// + 3 x 256 f32 statistics + 2 mbarriers + 1 KB to align the tiles to the
// 1024 bytes the swizzle repeats at = 151,568 bytes
// (tic_slab_attention_bwd_sm90_smem_bytes), under the H100's 227 KB opt-in;
// what is left cannot hold a second 128 KB stage. ptxas: 168 registers at
// entry (setmaxnreg then gives the consumers 232), no spills at NK 208.
//
// Measured (chip_smoke.py phase 4; NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 0.1697 ms of device time at ViT-L batch 64, 32% of the bytes bound,
// against 0.2608 for the mma.sync kernel and 0.2844 for SDPA's autograd
// backward; at ViT-B batch 2 (two launches of one-block items) 0.0144
// against 0.0193.
//
// Tried while it was designed, in probes not kept, and dropped: K and V of
// the next item prefetched into a second stage (with Q and g by row block),
// ping-pong turns that keep the two consumers' products from overlapping,
// TMA stores of the gradients, 32-key chunks of dP and products of the next
// chunk issued with the current one were no faster; two one-consumer blocks
// an SM do not compile (ptxas caps a thread at 128 registers there, and S
// alone takes NK / 2). A clock64 timeline of one block showed the two
// consumers working in step: each phase's softmax runs on both at once,
// bound by the special function unit, while the tensor cores wait; the
// softmax, and the products between short waits, are where the time goes.
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

constexpr int kD = 64;         // the head dim: one 128-byte row
constexpr int kBlock = 64;     // rows of a query or key block; keys or queries of a chunk
constexpr int kMaxN = 256;
constexpr int kMaxTiles = kMaxN / kBlock;
constexpr int kTileBytes = kBlock * kD * 2;             // one 64 x 64 box, 8 KB
constexpr int kOperandBytes = kMaxTiles * kTileBytes;  // one operand's 4 tiles
enum Operand { kQ = 0, kK = 1, kV = 2, kG = 3 };         // operand slots of the stage
constexpr int kStageBytes = 4 * kOperandBytes;          // 128 KB
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "register file");
constexpr int kStatsBytes = 3 * kMaxN * sizeof(float);
constexpr size_t kSmemBytes =
    1024 + kStageBytes + kConsumers * kTileBytes + kStatsBytes + 2 * sizeof(uint64_t);
static_assert(kSmemBytes == 151568, "tic_slab_attention_bwd_sm90_smem_bytes");
constexpr int kBothConsumers = 3;  // the named barrier of both consumer warpgroups

// What a launch runs: both phases of whole heads, or one phase of the
// two-launch form (see the header).
enum Form : int { kFused = 0, kRows = 1, kKeys = 2 };

// The keys (and queries) a launch computes: N rounded up to one of the widths
// the kernel is built for. ceil(NK / 64) = ceil(N / 64) tiles an operand.
int key_width(int n) {
  return n <= 64 ? 64 : n <= 128 ? 128 : n <= 192 ? 192 : n <= 208 ? 208 : 256;
}

// The key width below NK: keys at or past n lie at or past it.
__host__ __device__ constexpr int mask_from(int nk) {
  return nk == 64 ? 0 : nk == 128 ? 64 : nk == 192 ? 128 : nk == 208 ? 192 : 208;
}

// 2^x on the special function unit: ex2.approx, subnormal results flushed to
// 0 (-inf gives 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The three gradients with their shared batch and row strides (elements).
struct Grads {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long batch;
  int row;
};

// The statistics of the item's query rows in shared memory: the row max of
// the scores in the log2 domain, 1 / l (0 for rows at or past N) and D_i.
struct Stats {
  float* m;
  float* inv_l;
  float* d;
};

// A 64 x 64 gradient block (f32, the accumulator layout) times `scale`,
// rounded once to bf16 and written to rows row0 ... row0 + 63 (those < n) of
// dst, `row_stride` elements apart, through the warpgroup's staging `obuf`:
// row r's 16-byte chunk j at chunk j ^ (r % 8), so the eight rows of a store
// hit eight bank groups.
__device__ __forceinline__ void store_block(const float (&acc)[32], float scale, uint8_t* obuf,
                                            int barrier_id, bf16* __restrict__ dst,
                                            int row_stride, int row0, int n) {
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int r0 = (tid / 32) * 16 + lane / 4;
  named_barrier(barrier_id, 128);  // the last block's reads of obuf are done
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int chunk = (j ^ (r0 & 7)) << 4;
    *reinterpret_cast<uint32_t*>(obuf + r0 * 128 + chunk + 4 * t) =
        pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(obuf + (r0 + 8) * 128 + chunk + 4 * t) =
        pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
  named_barrier(barrier_id, 128);
#pragma unroll
  for (int i = 0; i < kBlock * 8 / 128; ++i) {
    const int x = tid + 128 * i;
    const int row = x / 8;
    const int chunk = x % 8;
    if (row0 + row < n)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + row) * row_stride + 8 * chunk) =
          *reinterpret_cast<const uint4*>(obuf + row * 128 + ((chunk ^ (row & 7)) << 4));
  }
}

// d = A B^T of two K-major operands over D's four k steps: the 64 rows of
// `a_tile` times as many rows from `b_rows` as d has columns (S: all NK keys;
// dP, S^T, dP^T: a chunk of 64, or the last 16).
template <int M>
__device__ __forceinline__ void chunk_product(float (&d)[M], uint32_t a_tile, uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(d, sw128_desc(a_tile) + 2 * kk, sw128_desc(b_rows) + 2 * kk, kk > 0 ? 1 : 0);
}

// Phase A for query block rb of the item in `stage`: dQ (written through
// `dq`, the head's column of its image) and the block's statistics, to
// shared memory and, when `global_stats` is not null (the two-launch form),
// to the (3, B, H, N) scratch (`global_stats` at this head, planes `plane`
// apart).
template <int NK>
__device__ __forceinline__ void query_block(uint32_t stage, int rb, int n, float score_scale,
                                            float scale, const Stats& st,
                                            float* __restrict__ global_stats, size_t plane,
                                            uint8_t* obuf, int barrier_id,
                                            bf16* __restrict__ dq, int row_stride) {
  constexpr int kFull = NK / kBlock;  // 64-key chunks
  constexpr int kTail = NK % kBlock;  // keys of a last, narrower chunk: 0 or 16
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const uint32_t q_tile = stage + kQ * kOperandBytes + rb * kTileBytes;
  const uint32_t g_tile = stage + kG * kOperandBytes + rb * kTileBytes;
  const uint32_t k0 = stage + kK * kOperandBytes;
  const uint32_t v0 = stage + kV * kOperandBytes;

  // S = Q K^T: four k steps of 16 through the 128-byte rows
  float s[NK / 2];
  wgmma_fence();
  chunk_product(s, q_tile, k0);
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(s);

  // The softmax of rows g and g + 8 of the warp's 16 over the keys < n, as
  // K1's wgmma kernel forms it. Column of s[4 j + e]: 8 j + 2 t + e % 2; only
  // chunks j >= kMaskFrom can hold keys at or past n.
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
  for (int x = 0; x < NK / 2; ++x) {
    s[x] = exp2_ftz(fmaf(s[x], score_scale, -m[(x % 4) / 2]));
    l[(x % 4) / 2] += s[x];
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l[r]);
#pragma unroll
  for (int x = 0; x < NK / 2; ++x) s[x] *= inv_l[(x % 4) / 2];  // P, f32

  // D_i = rowsum(P o dP), chunk by chunk: s[32 c + x] and dP's d[x] of
  // chunk c share row and column
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kFull; ++c) {
    float dp[32];
    wgmma_fence();
    chunk_product(dp, g_tile, v0 + c * kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) di[(x % 4) / 2] = fmaf(s[32 * c + x], dp[x], di[(x % 4) / 2]);
  }
  if constexpr (kTail > 0) {
    float dp[kTail / 2];
    wgmma_fence();
    chunk_product(dp, g_tile, v0 + kFull * kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dp);
#pragma unroll
    for (int x = 0; x < kTail / 2; ++x)
      di[(x % 4) / 2] = fmaf(s[32 * kFull + x], dp[x], di[(x % 4) / 2]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) di[r] = quad_sum(di[r]);

  // dS = P (dP - D_i) rounded to bf16 pairs, which are register A of the
  // k steps of dQ += dS K (K's 16 key rows of a k step 2048 bytes apart)
  float dq_acc[kD / 2];
#pragma unroll
  for (int c = 0; c < kFull; ++c) {
    float dp[32];
    wgmma_fence();
    chunk_product(dp, g_tile, v0 + c * kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dp);
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 8 * kk + 2 * i;
        const float d = di[i % 2];
        a[kk][i] = pack_bf16(s[32 * c + x] * (dp[x] - d), s[32 * c + x + 1] * (dp[x + 1] - d));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tnsp_b(dq_acc, a[kk], sw128_desc_mn(k0 + c * kTileBytes + kk * 2048),
                      c > 0 || kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dq_acc);
  }
  if constexpr (kTail > 0) {
    static_assert(kTail == 16 && kFull > 0, "one k step after whole chunks");
    float dp[kTail / 2];
    wgmma_fence();
    chunk_product(dp, g_tile, v0 + kFull * kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dp);
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = 2 * i;
      const float d = di[i % 2];
      a[i] = pack_bf16(s[32 * kFull + x] * (dp[x] - d), s[32 * kFull + x + 1] * (dp[x + 1] - d));
    }
    wgmma_fence();
    wgmma_rs_tnsp_b(dq_acc, a, sw128_desc_mn(k0 + kFull * kTileBytes), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dq_acc);
  }

  // the statistics of rows g and g + 8, from the quad's first thread
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rb * kBlock + ((threadIdx.x % 128) / 32) * 16 + lane / 4 + 8 * r;
      const bool valid = row < n;
      st.m[row] = m[r];
      st.inv_l[row] = valid ? inv_l[r] : 0.f;
      st.d[row] = di[r];
      if (global_stats != nullptr && valid) {
        global_stats[row] = m[r];
        global_stats[plane + row] = inv_l[r];
        global_stats[2 * plane + row] = di[r];
      }
    }
  }
  store_block(dq_acc, scale, obuf, barrier_id, dq, row_stride, rb * kBlock, n);
}

// P^T and dS^T in place of S^T and dP^T for the chunk's columns (queries)
// col0 + 8 i + e % 2 of st[4 i + e], from the queries' statistics.
template <int M>
__device__ __forceinline__ void transposed_probs(float (&st)[M], float (&dpt)[M],
                                                 const Stats& stats, int col0,
                                                 float score_scale) {
#pragma unroll
  for (int i = 0; i < M / 4; ++i) {
    const int col = col0 + 8 * i;  // even: float2 reads
    const float2 mm = *reinterpret_cast<const float2*>(stats.m + col);
    const float2 il = *reinterpret_cast<const float2*>(stats.inv_l + col);
    const float2 dd = *reinterpret_cast<const float2*>(stats.d + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * i + e;
      const bool odd = e % 2;
      const float p = exp2_ftz(fmaf(st[x], score_scale, -(odd ? mm.y : mm.x))) *
                      (odd ? il.y : il.x);
      dpt[x] = p * (dpt[x] - (odd ? dd.y : dd.x));
      st[x] = p;
    }
  }
}

// Phase B for key block kb of the item in `stage`: dK and dV over the query
// chunks, from the statistics in shared memory.
template <int NK>
__device__ __forceinline__ void key_block(uint32_t stage, int kb, float score_scale, float scale,
                                          int n, const Stats& stats, uint8_t* obuf,
                                          int barrier_id, bf16* __restrict__ dk,
                                          bf16* __restrict__ dv, int row_stride) {
  constexpr int kFull = NK / kBlock;
  constexpr int kTail = NK % kBlock;
  const int t = threadIdx.x % 4;
  const uint32_t k_tile = stage + kK * kOperandBytes + kb * kTileBytes;
  const uint32_t v_tile = stage + kV * kOperandBytes + kb * kTileBytes;
  const uint32_t q0 = stage + kQ * kOperandBytes;
  const uint32_t g0 = stage + kG * kOperandBytes;

  float dk_acc[kD / 2], dv_acc[kD / 2];
#pragma unroll
  for (int qc = 0; qc < kFull; ++qc) {
    float st[32], dpt[32];
    wgmma_fence();
    chunk_product(st, k_tile, q0 + qc * kTileBytes);   // S^T = K Q^T
    chunk_product(dpt, v_tile, g0 + qc * kTileBytes);  // dP^T = V g^T
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(st);
    fence_operands(dpt);
    transposed_probs(st, dpt, stats, qc * kBlock + 2 * t, score_scale);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t rows = qc * kTileBytes + kk * 2048;  // the k step's 16 queries
      wgmma_rs_tnsp_b(dv_acc, pa[kk], sw128_desc_mn(g0 + rows), qc > 0 || kk > 0 ? 1 : 0);
      wgmma_rs_tnsp_b(dk_acc, da[kk], sw128_desc_mn(q0 + rows), qc > 0 || kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
  }
  if constexpr (kTail > 0) {
    static_assert(kTail == 16 && kFull > 0, "one k step after whole chunks");
    float st[kTail / 2], dpt[kTail / 2];
    wgmma_fence();
    chunk_product(st, k_tile, q0 + kFull * kTileBytes);
    chunk_product(dpt, v_tile, g0 + kFull * kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(st);
    fence_operands(dpt);
    transposed_probs(st, dpt, stats, kFull * kBlock + 2 * t, score_scale);
    uint32_t pa[4], da[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pa[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
      da[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
    }
    wgmma_fence();
    wgmma_rs_tnsp_b(dv_acc, pa, sw128_desc_mn(g0 + kFull * kTileBytes), 1);
    wgmma_rs_tnsp_b(dk_acc, da, sw128_desc_mn(q0 + kFull * kTileBytes), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
  }
  store_block(dk_acc, scale, obuf, barrier_id, dk, row_stride, kb * kBlock, n);
  store_block(dv_acc, 1.f, obuf, barrier_id, dv, row_stride, kb * kBlock, n);
}

// Work item `item` -> image, head and part (a part is one or two row blocks
// of the two-launch form; the fused form has one part a head).
struct Item {
  int bh, b, h, part;
};
__device__ __forceinline__ Item decode(int item, int num_heads, int parts) {
  const int bh = item / parts;
  return {bh, bh / num_heads, bh % num_heads, item % parts};
}

template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap g_map, int q_col,
                               int k_col, int v_col, Grads out, float* __restrict__ stats,
                               int n, int num_heads, int form, int parts, int part_blocks,
                               int items, float score_scale, float scale) {
  constexpr int kTiles = (NK + kBlock - 1) / kBlock;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* obufs = smem + kStageBytes;
  float* stat_base = reinterpret_cast<float*>(obufs + kConsumers * kTileBytes);
  const Stats st{stat_base, stat_base + kMaxN, stat_base + 2 * kMaxN};
  uint64_t* full = reinterpret_cast<uint64_t*>(stat_base + 3 * kMaxN);
  uint64_t* empty = full + 1;
  const uint32_t stage = smem_u32(smem);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(full), 1);
    mbar_init(smem_u32(empty), kConsumers * 128);
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
      prefetch_tensormap(&g_map);
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        // the consumers are done with the item the stage held last
        if (it > 0) mbar_wait(smem_u32(empty), (it - 1) & 1);
        const Item w = decode(item, num_heads, parts);
        // a phase reads the operands of its own blocks (Q, g in phase A;
        // K, V in phase B) by block and the others whole
        const int own0 = form == kFused ? 0 : w.part * part_blocks;
        const int own1 = form == kFused ? kTiles : min(own0 + part_blocks, kTiles);
        const int q0 = form == kRows ? own0 : 0, q1 = form == kRows ? own1 : kTiles;
        const int k0 = form == kKeys ? own0 : 0, k1 = form == kKeys ? own1 : kTiles;
        const uint32_t bar = smem_u32(full);
        mbar_expect_tx(bar, 2 * (q1 - q0 + k1 - k0) * kTileBytes);
        const int head = w.h * kD;
        for (int j = q0; j < q1; ++j) {
          tma_load_3d(stage + kQ * kOperandBytes + j * kTileBytes, &q_map, bar, q_col + head,
                      j * kBlock, w.b);
          tma_load_3d(stage + kG * kOperandBytes + j * kTileBytes, &g_map, bar, head,
                      j * kBlock, w.b);
        }
        for (int j = k0; j < k1; ++j) {
          tma_load_3d(stage + kK * kOperandBytes + j * kTileBytes, &k_map, bar, k_col + head,
                      j * kBlock, w.b);
          tma_load_3d(stage + kV * kOperandBytes + j * kTileBytes, &v_map, bar, v_col + head,
                      j * kBlock, w.b);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int consumer = wg - 1;
    uint8_t* obuf = obufs + consumer * kTileBytes;
    const int barrier_id = 1 + consumer;
    const size_t plane = static_cast<size_t>(items / parts) * n;  // B * H * N
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      mbar_wait(smem_u32(full), it & 1);
      const Item w = decode(item, num_heads, parts);
      const size_t head = static_cast<size_t>(w.b) * out.batch + w.h * kD;
      float* head_stats = stats + static_cast<size_t>(w.bh) * n;
      // the blocks this consumer takes: w, w + 2 of a whole head, or its one
      // block of the item's (none if the item has one and this is consumer 1)
      const int first = form == kFused ? consumer : w.part * part_blocks + consumer;
      const int last = form == kFused ? kTiles
                                      : consumer < part_blocks ? min(first + 1, kTiles) : first;
      if (form == kKeys) {
        for (int i = threadIdx.x - 128; i < kMaxN; i += kConsumers * 128) {
          const bool valid = i < n;
          st.m[i] = valid ? head_stats[i] : 0.f;
          st.inv_l[i] = valid ? head_stats[plane + i] : 0.f;
          st.d[i] = valid ? head_stats[2 * plane + i] : 0.f;
        }
        named_barrier(kBothConsumers, kConsumers * 128);
      } else {
        for (int rb = first; rb < last; rb += kConsumers)
          query_block<NK>(stage, rb, n, score_scale, scale, st,
                          form == kRows ? head_stats : nullptr, plane, obuf, barrier_id,
                          out.dq + head, out.row);
      }
      if (form == kFused) named_barrier(kBothConsumers, kConsumers * 128);
      if (form != kRows) {
        for (int kb = first; kb < last; kb += kConsumers)
          key_block<NK>(stage, kb, score_scale, scale, n, st, obuf, barrier_id, out.dk + head,
                        out.dv + head, out.row);
      }
      // every consumer thread, busy or not, releases the stage once an item
      mbar_arrive(smem_u32(empty));
    }
  }
}

// The SM count and the one-time shared-memory opt-in of each kernel, per
// device.
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
      cudaFuncSetAttribute(attention_bwd_wgmma_kernel<NK>,
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
  const cuuint32_t box[3] = {kD, kBlock, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// split: -1 picks the form by the rule of the header, 0 forces one launch of
// whole heads, 1 the two-launch form with two blocks an item, 2 with one.
template <int NK>
int launch_nk(const CUtensorMap (&maps)[4], const int (&cols)[3], const Grads& out,
              float* stats, int b, int n, int num_heads, float scale, int split, int device,
              cudaStream_t stream) {
  cudaError_t err = allow_smem<NK>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long heads = static_cast<long long>(b) * num_heads;
  const int tiles = (n + kBlock - 1) / kBlock;
  // blocks an item of the two-launch form, 0 for the one-launch form
  const int part_blocks = split == 0 ? 0 : split == 1 ? 2 : split == 2 ? 1
                          : 2 * heads >= sms ? 0 : heads * tiles <= sms ? 1 : 2;
  const bool two = part_blocks > 0;
  const int parts = two ? (tiles + part_blocks - 1) / part_blocks : 1;
  const long long items = heads * parts;
  if (items > (1ll << 31) - 1 || heads * n > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sms ? items : sms);
  const float score_scale = scale * 1.4426950408889634f;
  const Form forms[2] = {two ? kRows : kFused, kKeys};
  for (int i = 0; i < (two ? 2 : 1); ++i) {
    attention_bwd_wgmma_kernel<NK><<<grid, kThreads, kSmemBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], cols[0], cols[1], cols[2], out,
        static_cast<float*>(stats), n, num_heads, forms[i], parts, part_blocks,
        static_cast<int>(items), score_scale, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int launch(const CUtensorMap (&maps)[4], const int (&cols)[3], const Grads& out, void* stats,
           int b, int n, int num_heads, float scale, int split, cudaStream_t stream) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* st = static_cast<float*>(stats);
  switch (key_width(n)) {
    case 64: return launch_nk<64>(maps, cols, out, st, b, n, num_heads, scale, split, device, stream);
    case 128: return launch_nk<128>(maps, cols, out, st, b, n, num_heads, scale, split, device, stream);
    case 192: return launch_nk<192>(maps, cols, out, st, b, n, num_heads, scale, split, device, stream);
    case 208: return launch_nk<208>(maps, cols, out, st, b, n, num_heads, scale, split, device, stream);
    default: return launch_nk<256>(maps, cols, out, st, b, n, num_heads, scale, split, device, stream);
  }
}

// The route's limits: D 64, 1 <= N <= 256, every base 16-byte aligned and
// every stride a multiple of 16 bytes (TMA's global address and pitches, the
// gradients' 16-byte stores), and a statistics scratch.
bool takes(const void* const (&ptrs)[8], int b, int n, int d, const long long (&strides)[4]) {
  if (d != kD || n < 1 || n > kMaxN || b < 1) return false;
  for (const void* p : ptrs)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long s : strides)
    if ((s * 2) % 16) return false;
  return true;
}

int slab(const void* qkv, const void* g, void* dqkv, void* stats, int b, int n, int num_heads,
         int d, float scale, int split, void* stream) {
  const long long c = static_cast<long long>(num_heads) * d;
  bf16* out = static_cast<bf16*>(dqkv);
  const void* const ptrs[8] = {qkv, g, out, out + c, out + 2 * c, stats, qkv, qkv};
  const long long strides[4] = {3 * n * c, 3 * c, n * c, c};
  if (!takes(ptrs, b, n, d, strides)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!encode(&maps[0], qkv, 3 * c, n, b, 3 * c, 3 * n * c) ||
      !encode(&maps[3], g, c, n, b, c, n * c))
    return static_cast<int>(cudaErrorInvalidValue);
  maps[1] = maps[0];
  maps[2] = maps[0];
  const int cols[3] = {0, static_cast<int>(c), static_cast<int>(2 * c)};
  const Grads grads{out, out + c, out + 2 * c, 3 * n * c, static_cast<int>(3 * c)};
  return launch(maps, cols, grads, stats, b, n, num_heads, scale, split,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

// Dynamic shared memory of one block of the wgmma backward at N keys and
// head dim d, or 0 for a shape the route does not take.
extern "C" size_t tic_slab_attention_bwd_sm90_smem_bytes(int n, int d) {
  return d == kD && n >= 1 && n <= kMaxN ? kSmemBytes : 0;
}

// The slab form (K2) on the wgmma route: a contiguous (B, N, 3C) bf16 slab
// and upstream g (B, N, C) in, the (B, N, 3C) gradient [dQ | dK | dV] out.
// `stats` is (3, B, H, N) f32 scratch (read and written only by the
// two-launch form). Launches on `stream` without synchronising; returns the
// first nonzero cudaGetLastError(), or cudaErrorInvalidValue for a shape or
// alignment the route does not take.
extern "C" int tic_slab_attention_bwd_sm90(const void* qkv, const void* g, void* dqkv,
                                           void* stats, int b, int n, int num_heads, int d,
                                           float scale, void* stream) {
  return slab(qkv, g, dqkv, stats, b, n, num_heads, d, scale, -1, stream);
}

// A measurement entry point, on no path of the model: the slab form with its
// form forced (split 0: one launch of whole heads; the two-launch form with
// 1: two row blocks an item, 2: one), so that the rule's sides can be timed
// at any batch.
extern "C" int tic_slab_attention_bwd_sm90_form(const void* qkv, const void* g, void* dqkv,
                                                void* stats, int b, int n, int num_heads,
                                                int d, float scale, int split, void* stream) {
  if (split < 0 || split > 2) return static_cast<int>(cudaErrorInvalidValue);
  return slab(qkv, g, dqkv, stats, b, n, num_heads, d, scale, split, stream);
}

// The three-operand form (K3's backward) on the wgmma route: q, k, v with a
// shared batch and row stride in, dq, dk, dv with theirs out (elements), g a
// contiguous (B, N, C), `stats` as for the slab form. Four tensor maps are
// encoded a launch (the slab form's q, k and v share one).
extern "C" int tic_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                      long long in_batch, int in_row, const void* g, void* dq,
                                      void* dk, void* dv, long long out_batch, int out_row,
                                      void* stats, int b, int n, int num_heads, int d,
                                      float scale, void* stream) {
  const long long c = static_cast<long long>(num_heads) * d;
  const void* const ptrs[8] = {q, k, v, g, dq, dk, dv, stats};
  const long long strides[4] = {in_batch, in_row, out_batch, out_row};
  if (!takes(ptrs, b, n, d, strides) || (c * 2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* const bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!encode(&maps[i], bases[i], c, n, b, in_row, in_batch))
      return static_cast<int>(cudaErrorInvalidValue);
  if (!encode(&maps[3], g, c, n, b, c, n * c)) return static_cast<int>(cudaErrorInvalidValue);
  const int cols[3] = {0, 0, 0};
  const Grads grads{static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                    out_batch, out_row};
  return launch(maps, cols, grads, stats, b, n, num_heads, scale, -1,
                static_cast<cudaStream_t>(stream));
}
