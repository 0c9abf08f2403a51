// Tiles of the bf16 slab attention for Hopper (sm_90a): K1's forward and K2's
// backward with the work of a block chosen by the caller. Measurement kernels
// of the kernel studies S1, S3 and S4, on no path of the model; bound to
// Python with ctypes (ops/attention_study.py). S2's softmax variants run on
// K1's own kernel (slab_attention_fwd.cu, tic_attention_fwd_softmax).
//
// Replaces the grid steps of three TPU studies of the JAX package's
// repository (tools/): bench_attn4.py::fwd_blocked (S1, whole images a step,
// `block_b`), bench_attn7.py (S3, head batching: `loop`, `batched`, `pairs`,
// `loop-i2`; forward and backward) and bench_attn8.py::fwd_split / bwd_split
// (S4, grid (B, S) with H / S heads a step). On the TPU a grid step is
// images x heads x all N rows, run in order; here a block of 4 warps
// (16-row query strips, as K1 and K2) does one step's work by walking its
// items, (image, head group) pairs, in a loop that takes the place of the
// TPU's sequential grid. A tile says what one block walks:
// - images: whole images a block (grid z: ceil(B / images); the ragged last
//   block walks the images that exist);
// - heads: heads a block, of the image's H (grid y: H / heads);
// - staged: heads staged together (2: the 256-byte row segment of two
//   adjacent heads in one pass, the TPU study's 128-lane `pairs`);
// - all_rows: every 64-row block of an item in this block (1), or one row
//   block a block (0, grid x: ceil(N / 64): K1's own tile, which measures
//   what the tile machinery costs against K1);
// - stages: 1 or 2 shared-memory stages of the staged operands. With 2, the
//   next item's K_h / V_h (the backward's pass 2: Q_h, g_h and the row
//   statistics) land by cp.async while the block computes the current one.
// S3's `batched` differs from `loop` only in how heads sit in the TPU's
// vregs; a head here is a column offset, so both are the `loop` tile.
//
// Per strip the arithmetic is K1's and K2's, on the same helpers in the same
// order (slab_attention_common.cuh: stage_async's copies, load_a_strip,
// strip_times_rows_t, scale_and_mask, accumulate_rows, store_strip), so each
// row's output is the shipped kernels' bit for bit. What differs: the output
// leaves through an area of its own (4 warps x 16 rows at pitch D + 8) and
// not over K, which a block still needs for its next row block; cp.async
// groups are counted across items; a __syncthreads precedes every refill of
// a stage.
//
// What bounds it on this card: device-memory bytes, as K1 and K2 (each q, k,
// v (and g) row read once, each output written once: at ViT-L batch 64,
// forward 0.0308 ms, backward 0.0540 ms). A tile of all rows stages K_h and
// V_h once a head, where K1's ceil(197 / 64) = 4 row blocks stage them 4
// times (2.5x the unique bytes); but two stages of one head (119,808 bytes at
// N 197) leave one block an SM where K1 runs three, and a tile of whole
// images gives the card fewer blocks than its 132 SMs below B 132 x images.
// Measured (tools/bench_attn{4,7,8}.py of the port, PERF.md): a warp's strip
// is latency-bound, so time follows the warps resident on each SM and not
// the bytes staged; every all-rows tile loses to K1.
#include "slab_attention_common.cuh"

namespace {

using namespace tic;
using bf16 = __nv_bfloat16;

// What a block walks (see the top of the file). The launchers check it.
struct Tile {
  int images;
  int heads;
  int staged;
  int all_rows;
  int stages;
};

template <int D>
constexpr size_t kOutAreaBytes = static_cast<size_t>(kWarps) * mma::kRows * mma::kPitch<D> *
                                 sizeof(bf16);

// One head operand of staged_rows(N) rows at pitch D + 8.
template <int D>
size_t head_bytes(int n) {
  return static_cast<size_t>(mma::staged_rows(n)) * mma::kPitch<D> * sizeof(bf16);
}

// A forward stage (and the backward's pass 1 with staged 1): K of the staged
// heads, then their V.
template <int D>
size_t kv_stage_bytes(int n, int staged) {
  return 2 * static_cast<size_t>(staged) * head_bytes<D>(n);
}

// A pass-2 stage: Q_h and g_h, then m, 1 / l and D of every staged row (f32).
template <int D>
size_t qg_stage_bytes(int n) {
  return 2 * head_bytes<D>(n) + 3 * static_cast<size_t>(mma::staged_rows(n)) * sizeof(float);
}

template <int D>
size_t fwd_tile_smem(int n, int staged, int stages) {
  return stages * kv_stage_bytes<D>(n, staged) + kOutAreaBytes<D>;
}

// Pass 2 needs the more.
template <int D>
size_t bwd_tile_smem(int n, int stages) {
  return stages * qg_stage_bytes<D>(n) + kOutAreaBytes<D>;
}

bool valid_tile(const Tile& t, int num_heads, bool backward) {
  return t.images >= 1 && t.heads >= 1 && num_heads % t.heads == 0 &&
         (t.staged == 1 || (t.staged == 2 && !backward)) && t.heads % t.staged == 0 &&
         (t.all_rows == 0 || t.all_rows == 1) && (t.stages == 1 || t.stages == 2);
}

// The items a block walks, images outer, head groups inner, and the row
// blocks of each item.
struct Walk {
  int img0, head0, groups, items, rb0, rb1;

  __device__ Walk(const Tile& t, int b, int n) {
    img0 = blockIdx.z * t.images;
    head0 = blockIdx.y * t.heads;
    groups = t.heads / t.staged;
    items = min(t.images, b - img0) * groups;
    rb0 = t.all_rows ? 0 : blockIdx.x;
    rb1 = t.all_rows ? (n + kBlockRows - 1) / kBlockRows : rb0 + 1;
  }
  __device__ int image(int it) const { return img0 + it / groups; }
  __device__ int head(int it, int staged) const { return head0 + (it % groups) * staged; }
};

// The tile forward. Per item: K and V of the staged heads land as two
// cp.async groups (V may still be in flight during sweep 1 of the item's
// first row block, as in K1); with 2 stages the next item's pair is issued
// once every warp is past the current item's start. Per strip: K1's sweeps.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_tile_kernel(const bf16* __restrict__ q_in, const bf16* __restrict__ k_in,
                              const bf16* __restrict__ v_in, long long batch_stride,
                              int row_stride, bf16* __restrict__ out, int b, int n,
                              int num_heads, float score_scale, Tile tile) {
  using namespace mma;
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = staged_rows(n);
  const size_t head_elems = static_cast<size_t>(rows) * P;
  const size_t stage_elems = 2 * tile.staged * head_elems;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* ostage = ring + tile.stages * stage_elems + warp * kRows * P;
  const int c = num_heads * D;
  const Walk walk(tile, b, n);
  const int chunks = (n + kRows - 1) / kRows;

  auto stage_item = [&](int it) {
    bf16* ks = ring + (it % tile.stages) * stage_elems;
    const size_t off =
        static_cast<size_t>(walk.image(it)) * batch_stride + walk.head(it, tile.staged) * D;
    stage_heads_async<D>(ks, k_in + off, n, rows, row_stride, tile.staged, kThreads);
    cp_async_commit();
    stage_heads_async<D>(ks + tile.staged * head_elems, v_in + off, n, rows, row_stride,
                         tile.staged, kThreads);
    cp_async_commit();
  };

  stage_item(0);
  for (int it = 0; it < walk.items; ++it) {
    if (tile.stages == 1 && it > 0) {
      __syncthreads();  // every warp is done with the one stage
      stage_item(it);
    }
    cp_async_wait<1>();  // K of item it has landed; its V may still be in flight
    __syncthreads();     // ... for every thread; every warp is past item it - 1
    const bool ahead = tile.stages == 2 && it + 1 < walk.items;
    if (ahead) stage_item(it + 1);  // into the stage item it - 1 used
    const bf16* stage = ring + (it % tile.stages) * stage_elems;
    const int img = walk.image(it);
    const int hbase = walk.head(it, tile.staged);
    for (int hh = 0; hh < tile.staged; ++hh) {
      const bf16* ks = stage + hh * head_elems;
      const bf16* vs = stage + (tile.staged + hh) * head_elems;
      const size_t head = static_cast<size_t>(img) * batch_stride + (hbase + hh) * D;
      for (int rb = walk.rb0; rb < walk.rb1; ++rb) {
        const int row0 = (rb * kWarps + warp) * kRows;
        const bool active = row0 < n;
        unsigned qa[D / 16][4];
        if (active) load_a_strip<D>(qa, q_in + head, row0, n, row_stride, lane);

        // Sweep 1 (K1's): the row max m and sum l, per lane, then over the quad.
        float m[2] = {-INFINITY, -INFINITY};
        float l[2] = {0.f, 0.f};
        if (active) {
          for (int kc = 0; kc < chunks; ++kc) {
            float s[2][4];
            strip_times_rows_t<D>(s, qa, ks, kRows * kc, lane);
            scale_and_mask(s, score_scale, kRows * kc, n, lane);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float mn = fmaxf(m[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                                 fmaxf(s[1][2 * r], s[1][2 * r + 1])));
              l[r] = l[r] * exp_below<true>(m[r], mn) + exp_below<true>(s[0][2 * r], mn) +
                     exp_below<true>(s[0][2 * r + 1], mn) + exp_below<true>(s[1][2 * r], mn) +
                     exp_below<true>(s[1][2 * r + 1], mn);
              m[r] = mn;
            }
          }
        }
        float inv_l[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float row_max = quad_max(m[r]);
          inv_l[r] = 1.f / quad_sum(l[r] * exp_below<true>(m[r], row_max));
          m[r] = row_max;
        }
        if (hh == 0 && rb == walk.rb0) {
          if (ahead) {
            cp_async_wait<2>();  // V of item it has landed (item it + 1 may not)
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
        }
        if (!active) continue;

        // Sweep 2: P = exp2(S - m) / l rounded to bf16, O += P V.
        float o[D / 8][4];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
        for (int kc = 0; kc < chunks; ++kc) {
          float s[2][4];
          strip_times_rows_t<D>(s, qa, ks, kRows * kc, lane);
          scale_and_mask(s, score_scale, kRows * kc, n, lane);
          unsigned pa[4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              pa[2 * j + r] = pack_bf16(exp_base<true>(s[j][2 * r] - m[r]) * inv_l[r],
                                        exp_base<true>(s[j][2 * r + 1] - m[r]) * inv_l[r]);
          accumulate_rows<D>(o, pa, vs, kRows * kc, lane);
        }
        store_strip<D>(out + static_cast<size_t>(img) * n * c + (hbase + hh) * D,
                       static_cast<size_t>(c), row0, n, o, 1.f, ostage, lane);
      }
    }
  }
}

// The tile backward, pass 1: dQ of every strip of the block's items and the
// rows' m (log2 domain), 1 / l and D_i, written to the (3, B, H, N) f32
// statistics. Per item K_h and V_h land as one cp.async group. Per strip: K2's
// pass 1 (attention_bwd_dq_mma_kernel).
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_tile_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                                 bf16* __restrict__ dqkv, float* __restrict__ stats, int b,
                                 int n, int num_heads, float scale, float scale_log2,
                                 Tile tile) {
  using namespace mma;
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = staged_rows(n);
  const size_t head_elems = static_cast<size_t>(rows) * P;
  const size_t stage_elems = 2 * head_elems;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* ostage = ring + tile.stages * stage_elems + warp * kRows * P;
  const int c = num_heads * D;
  const int row_stride = 3 * c;
  const size_t batch_stride = static_cast<size_t>(n) * row_stride;
  const size_t plane = static_cast<size_t>(b) * num_heads * n;
  const Walk walk(tile, b, n);
  const int chunks = (n + kRows - 1) / kRows;

  auto stage_item = [&](int it) {
    bf16* ks = ring + (it % tile.stages) * stage_elems;
    const bf16* k = qkv + c + static_cast<size_t>(walk.image(it)) * batch_stride +
                    walk.head(it, 1) * D;
    stage_async<D>(ks, k, n, rows, row_stride, kThreads);
    stage_async<D>(ks + head_elems, k + c, n, rows, row_stride, kThreads);
    cp_async_commit();
  };

  stage_item(0);
  for (int it = 0; it < walk.items; ++it) {
    if (tile.stages == 1 && it > 0) {
      __syncthreads();
      stage_item(it);
    }
    cp_async_wait<0>();  // item it has landed (item it + 1 is not issued yet)
    __syncthreads();
    if (tile.stages == 2 && it + 1 < walk.items) stage_item(it + 1);
    const bf16* ks = ring + (it % tile.stages) * stage_elems;
    const bf16* vs = ks + head_elems;
    const int img = walk.image(it);
    const int h = walk.head(it, 1);
    const size_t in_head = static_cast<size_t>(img) * batch_stride + h * D;
    float* stat = stats + (static_cast<size_t>(img) * num_heads + h) * n;
    for (int rb = walk.rb0; rb < walk.rb1; ++rb) {
      const int row0 = (rb * kWarps + warp) * kRows;
      if (row0 >= n) continue;
      unsigned qa[D / 16][4], ga[D / 16][4];
      load_a_strip<D>(qa, qkv + in_head, row0, n, row_stride, lane);
      load_a_strip<D>(ga, g + static_cast<size_t>(img) * n * c + h * D, row0, n, c, lane);

      // Sweep 1: per lane and row (g, g + 8), the running max m, the rescaled
      // sums of e = exp2(S - m) and of e dP; then over the quad.
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float edp[2] = {0.f, 0.f};
      for (int kc = 0; kc < chunks; ++kc) {
        float s[2][4], dp[2][4];
        strip_times_rows_t<D>(s, qa, ks, kRows * kc, lane);
        strip_times_rows_t<D>(dp, ga, vs, kRows * kc, lane);
        scale_and_mask(s, scale_log2, kRows * kc, n, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                             fmaxf(s[1][2 * r], s[1][2 * r + 1])));
          const float alpha = exp_below<true>(m[r], mn);
          float sum_e = 0.f, sum_edp = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float e = exp_below<true>(s[j][2 * r + x], mn);
              sum_e += e;
              sum_edp += __fmul_rn(e, dp[j][2 * r + x]);
            }
          l[r] = l[r] * alpha + sum_e;
          edp[r] = edp[r] * alpha + sum_edp;
          m[r] = mn;
        }
      }
      float inv_l[2], di[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float row_max = quad_max(m[r]);
        const float alpha = exp_below<true>(m[r], row_max);
        inv_l[r] = 1.f / quad_sum(l[r] * alpha);
        di[r] = quad_sum(edp[r] * alpha) * inv_l[r];
        m[r] = row_max;
      }

      // Sweep 2: P = exp2(S - m) / l and dS = P (dP - D_i) in f32, dS rounded
      // to bf16 as an A fragment, dQ += dS K.
      float dq[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
      for (int kc = 0; kc < chunks; ++kc) {
        float s[2][4], dp[2][4];
        strip_times_rows_t<D>(s, qa, ks, kRows * kc, lane);
        strip_times_rows_t<D>(dp, ga, vs, kRows * kc, lane);
        scale_and_mask(s, scale_log2, kRows * kc, n, lane);
        unsigned da[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = __fmul_rn(exp2f(s[j][2 * r] - m[r]), inv_l[r]);
            const float p1 = __fmul_rn(exp2f(s[j][2 * r + 1] - m[r]), inv_l[r]);
            da[2 * j + r] = pack_bf16(__fmul_rn(p0, dp[j][2 * r] - di[r]),
                                      __fmul_rn(p1, dp[j][2 * r + 1] - di[r]));
          }
        accumulate_rows<D>(dq, da, ks, kRows * kc, lane);
      }
      store_strip<D>(dqkv + in_head, row_stride, row0, n, dq, scale, ostage, lane);
      if (lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + lane / 4 + 8 * r;
          if (row < n) {
            stat[row] = m[r];
            stat[plane + row] = inv_l[r];
            stat[2 * plane + row] = di[r];
          }
        }
      }
    }
  }
}

// The tile backward, pass 2: dK and dV of every strip of the block's items,
// from pass 1's statistics. Per item Q_h, g_h and the statistics of every
// row land as one cp.async group. Per strip: K2's pass 2
// (attention_bwd_dkv_mma_kernel).
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_tile_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                                  bf16* __restrict__ dqkv, const float* __restrict__ stats,
                                  int b, int n, int num_heads, float scale, float scale_log2,
                                  Tile tile) {
  using namespace mma;
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = staged_rows(n);
  const size_t head_elems = static_cast<size_t>(rows) * P;
  const size_t stage_bytes = 2 * head_elems * sizeof(bf16) + 3 * rows * sizeof(float);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* ostage = reinterpret_cast<bf16*>(smem + tile.stages * stage_bytes) + warp * kRows * P;
  const int c = num_heads * D;
  const int row_stride = 3 * c;
  const size_t batch_stride = static_cast<size_t>(n) * row_stride;
  const size_t plane = static_cast<size_t>(b) * num_heads * n;
  const Walk walk(tile, b, n);
  const int chunks = (n + kRows - 1) / kRows;

  auto stage_item = [&](int it) {
    unsigned char* base = smem + (it % tile.stages) * stage_bytes;
    bf16* qs = reinterpret_cast<bf16*>(base);
    float* sm = reinterpret_cast<float*>(qs + 2 * head_elems);
    const int img = walk.image(it);
    const int h = walk.head(it, 1);
    stage_async<D>(qs, qkv + static_cast<size_t>(img) * batch_stride + h * D, n, rows,
                   row_stride, kThreads);
    stage_async<D>(qs + head_elems, g + static_cast<size_t>(img) * n * c + h * D, n, rows, c,
                   kThreads);
    const float* stat = stats + (static_cast<size_t>(img) * num_heads + h) * n;
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const bool valid = i < n;
      const size_t at = valid ? i : 0;
      cp_async4(sm + i, stat + at, valid);
      cp_async4(sm + rows + i, stat + plane + at, valid);
      cp_async4(sm + 2 * rows + i, stat + 2 * plane + at, valid);
    }
    cp_async_commit();
  };

  stage_item(0);
  for (int it = 0; it < walk.items; ++it) {
    if (tile.stages == 1 && it > 0) {
      __syncthreads();
      stage_item(it);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (tile.stages == 2 && it + 1 < walk.items) stage_item(it + 1);
    const unsigned char* base = smem + (it % tile.stages) * stage_bytes;
    const bf16* qs = reinterpret_cast<const bf16*>(base);
    const bf16* gs = qs + head_elems;
    const float* sm = reinterpret_cast<const float*>(gs + head_elems);
    const float* sl = sm + rows;
    const float* sd = sl + rows;
    const size_t in_head =
        static_cast<size_t>(walk.image(it)) * batch_stride + walk.head(it, 1) * D;
    for (int rb = walk.rb0; rb < walk.rb1; ++rb) {
      const int row0 = (rb * kWarps + warp) * kRows;
      if (row0 >= n) continue;
      unsigned ka[D / 16][4], va[D / 16][4];
      load_a_strip<D>(ka, qkv + c + in_head, row0, n, row_stride, lane);
      load_a_strip<D>(va, qkv + 2 * c + in_head, row0, n, row_stride, lane);
      float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
      const int t = lane % 4;
      for (int qc = 0; qc < chunks; ++qc) {
        // rows: keys (g, g + 8 of the strip); columns: queries
        float st[2][4], dpt[2][4];
        strip_times_rows_t<D>(st, ka, qs, kRows * qc, lane);
        strip_times_rows_t<D>(dpt, va, gs, kRows * qc, lane);
        scale_and_mask(st, scale_log2, kRows * qc, n, lane);
        unsigned pa[4], da[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = kRows * qc + 8 * j + 2 * t;  // even: float2 reads
          const float2 mm = *reinterpret_cast<const float2*>(sm + col);
          const float2 il = *reinterpret_cast<const float2*>(sl + col);
          const float2 dd = *reinterpret_cast<const float2*>(sd + col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // exp2(-inf - m) = 0 past N (m there is 0)
            const float p0 = __fmul_rn(exp2f(st[j][2 * r] - mm.x), il.x);
            const float p1 = __fmul_rn(exp2f(st[j][2 * r + 1] - mm.y), il.y);
            pa[2 * j + r] = pack_bf16(p0, p1);
            da[2 * j + r] = pack_bf16(__fmul_rn(p0, dpt[j][2 * r] - dd.x),
                                      __fmul_rn(p1, dpt[j][2 * r + 1] - dd.y));
          }
        }
        accumulate_rows<D>(dv, pa, gs, kRows * qc, lane);
        accumulate_rows<D>(dk, da, qs, kRows * qc, lane);
      }
      store_strip<D>(dqkv + c + in_head, row_stride, row0, n, dk, scale, ostage, lane);
      store_strip<D>(dqkv + 2 * c + in_head, row_stride, row0, n, dv, 1.f, ostage, lane);
    }
  }
}

dim3 tile_grid(const Tile& t, int b, int n, int num_heads) {
  return dim3(t.all_rows ? 1 : (n + kBlockRows - 1) / kBlockRows, num_heads / t.heads,
              (b + t.images - 1) / t.images);
}

template <int D>
int launch_fwd(const bf16* qkv, void* out, int b, int n, int num_heads, float scale,
               const Tile& t, cudaStream_t stream) {
  const size_t smem = fwd_tile_smem<D>(n, t.staged, t.stages);
  auto kernel = attention_fwd_tile_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c = num_heads * D;
  kernel<<<tile_grid(t, b, n, num_heads), kThreads, smem, stream>>>(
      qkv, qkv + c, qkv + 2 * c, 3LL * n * c, 3 * c, static_cast<bf16*>(out), b, n, num_heads,
      scale * 1.4426950408889634f, t);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const bf16* qkv, const bf16* g, bf16* dqkv, float* stats, int b, int n,
               int num_heads, float scale, const Tile& t, cudaStream_t stream) {
  const size_t smem1 = fwd_tile_smem<D>(n, 1, t.stages);
  const size_t smem2 = bwd_tile_smem<D>(n, t.stages);
  auto dq = attention_bwd_dq_tile_kernel<D>;
  auto dkv = attention_bwd_dkv_tile_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = tile_grid(t, b, n, num_heads);
  const float scale_log2 = scale * 1.4426950408889634f;
  dq<<<grid, kThreads, smem1, stream>>>(qkv, g, dqkv, stats, b, n, num_heads, scale,
                                         scale_log2, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv<<<grid, kThreads, smem2, stream>>>(qkv, g, dqkv, stats, b, n, num_heads, scale,
                                          scale_log2, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one tile block at N rows, head dim d (64 only):
// `stages` stages of K and V of `staged` heads and the output area (forward),
// or the larger pass of the backward (pass 2: stages of Q, g and the three
// f32 statistics, and the output area). 0 for a d the tiles do not take.
extern "C" size_t tic_attention_tile_smem_bytes(int n, int d, int staged, int stages,
                                                int backward) {
  if (d != 64) return 0;
  return backward ? bwd_tile_smem<64>(n, stages) : fwd_tile_smem<64>(n, staged, stages);
}

// A measurement entry point, on no path of the model: the bf16 slab forward
// (K1's arithmetic) at D 64 on the tile (images, heads, staged, all_rows,
// stages). The slab and the (B, N, C) output as tic_slab_attention_fwd.
// Launches on `stream` without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile or d it does not take.
extern "C" int tic_attention_fwd_tile(const void* qkv, void* out, int b, int n,
                                      int num_heads, int d, float scale, int images,
                                      int heads, int staged, int all_rows, int stages,
                                      void* stream) {
  const Tile t{images, heads, staged, all_rows, stages};
  if (d != 64 || !valid_tile(t, num_heads, false)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd<64>(static_cast<const bf16*>(qkv), out, b, n, num_heads, scale, t,
                        static_cast<cudaStream_t>(stream));
}

// A measurement entry point, on no path of the model: the bf16 slab backward
// (K2's two passes) at D 64, each pass on the tile (images, heads, all_rows,
// stages; one head staged at a time). Arguments as tic_slab_attention_bwd
// without the dtype; `stats` is (3, B, H, N) f32 scratch.
extern "C" int tic_attention_bwd_tile(const void* qkv, const void* g, void* dqkv, void* stats,
                                      int b, int n, int num_heads, int d, float scale,
                                      int images, int heads, int all_rows, int stages,
                                      void* stream) {
  const Tile t{images, heads, 1, all_rows, stages};
  if (d != 64 || !valid_tile(t, num_heads, true)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<64>(static_cast<const bf16*>(qkv), static_cast<const bf16*>(g),
                        static_cast<bf16*>(dqkv), static_cast<float*>(stats), b, n, num_heads,
                        scale, t, static_cast<cudaStream_t>(stream));
}
