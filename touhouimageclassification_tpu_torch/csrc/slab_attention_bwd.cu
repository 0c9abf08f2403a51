// Attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces two Pallas TPU kernels of
// touhouimageclassification_tpu/ops/attention.py, both through
// _packed_bwd_kernel_body:
// - _slab_bwd_kernel (K2), which every ViT encoder layer runs in the train
//   step with attention_impl='fused': one (B, N, 3C) slab in, one (B, N, 3C)
//   gradient [dQ | dK | dV] out;
// - _packed_bwd_kernel (K3, packed_attention's VJP): three (B, N, C)
//   operands in, three gradients out.
// Both are one device kernel pair per dtype over three input base pointers
// with a shared batch and row stride, and three output base pointers with
// theirs: the slab is (slab, slab + C, slab + 2C) with row stride 3C, K3's
// operands (q, k, v) with row stride C.
//
// What it computes. From q, k, v (head h at elements h*D ... (h+1)*D of a row)
// and the upstream gradient g, a contiguous (B, N, C), per image b and head h:
//   S  = Q_h K_h^T * D^-1/2           f32
//   P  = softmax(S)                    f32, max-subtracted, normalised
//   dP = g_h V_h^T                     f32 accumulation
//   dS = P o (dP - D_i), D_i = rowsum(P o dP) from the f32 P and dP (not
//        rowsum(g o O), which would read the rounded O)
//   dS and P are rounded to the input type, as the TPU kernel casts them, then
//   dQ = dS K_h * scale,  dK = dS^T Q_h * scale,  dV = P^T g_h
// with f32 accumulation, written to the three output row sets.
// Neither P nor dS reaches device memory.
//
// Design: two passes, one C entry point (FlashAttention-2's split), no
// atomics, so results are the same from run to run.
// - Pass 1, query-row blocks, grid (ceil(N / 64), H, B): dQ and the row
//   statistics m, 1 / l and D_i, saved to a (3, B, H, N) f32 scratch.
// - Pass 2, key-row blocks, same grid: dK and dV from the saved statistics.
//
// bf16: the tensor-core route (mma.sync m16n8k16, bf16 in, f32
// accumulation), 4 warps of 16 rows a block. Pass 1 stages K_h and V_h of
// all N keys with 16-byte cp.async copies (pitch D + 8, rows past N zeros);
// the warp's Q and g strips are A fragments in registers. Sweep 1 over
// 16-key chunks forms S = Q K^T and dP = g V^T (K and V rows as the B
// operand's columns) and keeps, per row, a running max, the rescaled sum of
// e = exp2(S - m) and the rescaled sum of e dP, so that D_i = (sum e dP) / l
// needs no sweep of its own. Sweep 2 recomputes S and dP, forms P = e / l and
// dS = P (dP - D_i) in f32, rounds dS to bf16 as an A fragment in registers
// and accumulates dQ += dS K (K by ldmatrix.trans). Pass 2 stages Q_h, g_h and
// the statistics of all N queries; the warp's K and V strips are A fragments.
// Over 16-query chunks it forms S^T = K Q^T and dP^T = V g^T, P^T = exp2(S^T
// - m) / l and dS^T with the statistics broadcast along columns, rounds both
// to bf16 A fragments, and accumulates dV += P^T g and dK += dS^T Q (g and Q by
// ldmatrix.trans). Gradients leave through shared memory as 16-byte stores.
// Nine products where the bound counts five (S and dP twice in pass 1, once
// more in pass 2). The two passes form S as Q K^T and as K Q^T on the tensor
// cores, whose summation order inside one mma is the hardware's, so nothing
// in the design makes pass 2's P equal pass 1's; every multiply is kept out
// of FMA contraction so that the arithmetic after the products agrees.
// Measured through tic_attention_bwd_probes on an H100 (chip_smoke.py): the
// two passes' P were equal bit for bit at (B 8, N 197, H 16, D 64),
// (2, 67, 2, 32) and (2, 257, 2, 128), so dQ, dK and dV came from one set of
// probabilities there; elsewhere they are held to the plain backward by
// tolerance.
//
// f32: the SIMT route (tensor cores take f32 only as TF32, too coarse for the
// f32 bound). Each warp takes one row at a time: pass 1 one query row (q_i,
// then g_i, in registers; lanes over keys for S_i, its max and sum, dP_i,
// D_i and dS_i; lanes over D for dQ_i), pass 2 one key row (k_j, then v_j;
// lanes over queries rebuild P_ij and dS_ij, lanes over D accumulate dK_j and
// dV_j). Both passes form S_ij and dP_ij as the same f32 FMA chain in
// element order (fma is symmetric in its factors) with the multiplies kept
// out of contraction (__fmul_rn), so pass 2 rebuilds pass 1's P and dS bit for
// bit on this route. Pair loads at a D + 2 pitch, free of bank conflicts.
//
// What bounds it on this card. At ViT-L train shapes (N 197, D 64) the bound
// is device-memory bytes (q, k, v, g read and three gradients written once:
// 0.054 ms at batch 64 bf16). The bf16 kernel's pace is set by the softmax
// and dS arithmetic between its products (two exp2 per score in pass 1, one in
// pass 2), the staging before the first product and the recomputed S and dP;
// the f32 kernel is bound by SIMT FMAs fed from shared memory.
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

// The three inputs, with their shared batch and row strides, and the three
// gradients, with theirs (elements). Passed by value as one kernel argument.
template <typename T>
struct Operands {
  const T* q;
  const T* k;
  const T* v;
  long long in_batch;
  int in_row;
  T* dq;
  T* dk;
  T* dv;
  long long out_batch;
  int out_row;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(Operands<T> op, const T* __restrict__ g,
                            float* __restrict__ stats, int n, int num_heads,
                            float scale) {
  constexpr int S = kStride<D>;
  constexpr int kAcc = (D / 2 + 31) / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + static_cast<size_t>(n) * S;
  float* rows = reinterpret_cast<float*>(vs + static_cast<size_t>(n) * S);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const size_t in_head = static_cast<size_t>(b) * op.in_batch + h * D;
  const size_t out_head = static_cast<size_t>(b) * op.out_batch + h * D;
  const T* __restrict__ qb = op.q + in_head;
  const T* __restrict__ kb = op.k + in_head;
  const T* __restrict__ vb = op.v + in_head;
  const T* __restrict__ gb = g + static_cast<size_t>(b) * n * c + h * D;
  T* __restrict__ dqb = op.dq + out_head;
  const size_t plane = static_cast<size_t>(gridDim.z) * num_heads * n;
  float* stat = stats + (static_cast<size_t>(b) * num_heads + h) * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  stage_rows<T, D>(ks, kb, n, op.in_row);
  stage_rows<T, D>(vs, vb, n, op.in_row);
  __syncthreads();

  float* prow = rows + warp * 2 * n;
  float* dsrow = prow + n;
  const int row_end = min(n, static_cast<int>(blockIdx.x + 1) * kBlockRows);
  for (int row = blockIdx.x * kBlockRows + warp; row < row_end; row += kWarps) {
    float x[D];
    load_row<T, D>(x, qb + static_cast<size_t>(row) * op.in_row);  // q_i
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

    load_row<T, D>(x, gb + static_cast<size_t>(row) * c);  // g_i
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
    store_pairs<T, D>(dqb + static_cast<size_t>(row) * op.out_row, acc, scale, lane);
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
    attention_bwd_dkv_kernel(Operands<T> op, const T* __restrict__ g,
                             const float* __restrict__ stats, int n, int num_heads,
                             float scale) {
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
  const size_t in_head = static_cast<size_t>(b) * op.in_batch + h * D;
  const size_t out_head = static_cast<size_t>(b) * op.out_batch + h * D;
  const T* __restrict__ qb = op.q + in_head;
  const T* __restrict__ kb = op.k + in_head;
  const T* __restrict__ vb = op.v + in_head;
  const T* __restrict__ gb = g + static_cast<size_t>(b) * n * c + h * D;
  T* __restrict__ dkb = op.dk + out_head;
  T* __restrict__ dvb = op.dv + out_head;
  const size_t plane = static_cast<size_t>(gridDim.z) * num_heads * n;
  const float* stat = stats + (static_cast<size_t>(b) * num_heads + h) * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  stage_rows<T, D>(qs, qb, n, op.in_row);
  stage_rows<T, D>(gs, gb, n, c);
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
    load_row<T, D>(x, kb + static_cast<size_t>(row) * op.in_row);  // k_j
    for (int i = lane; i < n; i += 32) {
      const float s = __fmul_rn(dot_row<T, D>(x, qs + i * S), scale);
      prow[i] = expf(s - sm[i]) / sl[i];
    }
    load_row<T, D>(x, vb + static_cast<size_t>(row) * op.in_row);  // v_j
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
    store_pairs<T, D>(dkb + static_cast<size_t>(row) * op.out_row, acck, scale, lane);
    store_pairs<T, D>(dvb + static_cast<size_t>(row) * op.out_row, accv, 1.f, lane);
    __syncwarp();  // the next row overwrites prow and dsrow
  }
}

template <typename T, int D>
int launch(const Operands<T>& op, const void* g, void* stats, int b, int n,
           int num_heads, float scale, cudaStream_t stream) {
  const size_t smem1 = smem_dq<T, D>(n);
  const size_t smem2 = smem_dkv<T, D>(n);
  auto dq = attention_bwd_dq_kernel<T, D>;
  auto dkv = attention_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, num_heads, b);
  const T* gg = static_cast<const T*>(g);
  float* st = static_cast<float*>(stats);
  dq<<<grid, kThreads, smem1, stream>>>(op, gg, st, n, num_heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv<<<grid, kThreads, smem2, stream>>>(op, gg, st, n, num_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// --- bf16: the tensor-core route ---------------------------------------------

using bf16 = __nv_bfloat16;

// Pass 1 shared memory: K_h and V_h as staged_rows(N) rows of kPitch<D>.
template <int D>
size_t mma_smem_dq(int n) {
  return 2 * static_cast<size_t>(mma::staged_rows(n)) * mma::kPitch<D> * sizeof(bf16);
}

// Pass 2 shared memory: Q_h and g_h likewise, then m, 1 / l and D of every
// staged query row (f32).
template <int D>
size_t mma_smem_dkv(int n) {
  return mma_smem_dq<D>(n) + 3 * static_cast<size_t>(mma::staged_rows(n)) * sizeof(float);
}

// Pass 1: dQ for a 16-row query strip a warp, and the rows' m (log2 domain),
// 1 / l and D_i. With kProbe, also every P_ij it forms, as f32, to
// probe[((b H + h) N + i) N + j].
template <int D, bool kProbe>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_mma_kernel(Operands<bf16> op, const bf16* __restrict__ g,
                                float* __restrict__ stats, int n, int num_heads,
                                float scale, float scale_log2, float* __restrict__ probe) {
  using namespace mma;
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = staged_rows(n);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + static_cast<size_t>(rows) * P;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const size_t in_head = static_cast<size_t>(b) * op.in_batch + h * D;
  const size_t out_head = static_cast<size_t>(b) * op.out_batch + h * D;
  const size_t plane = static_cast<size_t>(gridDim.z) * num_heads * n;
  float* stat = stats + (static_cast<size_t>(b) * num_heads + h) * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + warp) * kRows;
  const bool active = row0 < n;

  stage_async<D>(ks, op.k + in_head, n, rows, op.in_row, kThreads);
  stage_async<D>(vs, op.v + in_head, n, rows, op.in_row, kThreads);
  cp_async_commit();
  unsigned qa[D / 16][4], ga[D / 16][4];
  if (active) {
    load_a_strip<D>(qa, op.q + in_head, row0, n, op.in_row, lane);
    load_a_strip<D>(ga, g + static_cast<size_t>(b) * n * c + h * D, row0, n, c, lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Sweep 1: per lane and row (g, g + 8), the running max m, the rescaled
  // sums of e = exp2(S - m) and of e dP; then over the quad.
  const int chunks = (n + kRows - 1) / kRows;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float edp[2] = {0.f, 0.f};
  if (active) {
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

  // Sweep 2: P = exp2(S - m) / l and dS = P (dP - D_i) in f32, dS rounded to
  // bf16 as an A fragment, dQ += dS K.
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  if (active) {
    const int gq = lane / 4, t = lane % 4;
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
          if (kProbe) {
            const int row = row0 + gq + 8 * r;
            const int col = kRows * kc + 8 * j + 2 * t;
            float* dst = probe + ((static_cast<size_t>(b) * num_heads + h) * n + row) * n;
            if (row < n && col < n) dst[col] = p0;
            if (row < n && col + 1 < n) dst[col + 1] = p1;
          }
        }
      accumulate_rows<D>(dq, da, ks, kRows * kc, lane);
    }
  }
  __syncthreads();  // every warp is done with K and V: stage dQ over them
  if (active) {
    store_strip<D>(op.dq + out_head, op.out_row, row0, n, dq, scale,
                   ks + warp * kRows * P, lane);
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

// Pass 2: dK and dV for a 16-row key strip a warp, from pass 1's statistics.
// With kProbe, also every P_ij it forms to probe (pass 1's indexing).
template <int D, bool kProbe>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_mma_kernel(Operands<bf16> op, const bf16* __restrict__ g,
                                 const float* __restrict__ stats, int n, int num_heads,
                                 float scale, float scale_log2, float* __restrict__ probe) {
  using namespace mma;
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = staged_rows(n);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + static_cast<size_t>(rows) * P;
  float* sm = reinterpret_cast<float*>(gs + static_cast<size_t>(rows) * P);
  float* sl = sm + rows;
  float* sd = sl + rows;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * D;
  const size_t in_head = static_cast<size_t>(b) * op.in_batch + h * D;
  const size_t out_head = static_cast<size_t>(b) * op.out_batch + h * D;
  const size_t plane = static_cast<size_t>(gridDim.z) * num_heads * n;
  const float* stat = stats + (static_cast<size_t>(b) * num_heads + h) * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + warp) * kRows;
  const bool active = row0 < n;

  stage_async<D>(qs, op.q + in_head, n, rows, op.in_row, kThreads);
  stage_async<D>(gs, g + static_cast<size_t>(b) * n * c + h * D, n, rows, c, kThreads);
  cp_async_commit();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    sm[i] = i < n ? stat[i] : 0.f;
    sl[i] = i < n ? stat[plane + i] : 0.f;
    sd[i] = i < n ? stat[2 * plane + i] : 0.f;
  }
  unsigned ka[D / 16][4], va[D / 16][4];
  if (active) {
    load_a_strip<D>(ka, op.k + in_head, row0, n, op.in_row, lane);
    load_a_strip<D>(va, op.v + in_head, row0, n, op.in_row, lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  if (active) {
    const int gk = lane / 4, t = lane % 4;
    const int chunks = (n + kRows - 1) / kRows;
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
          if (kProbe) {
            const int key = row0 + gk + 8 * r;
            float* dst = probe + (static_cast<size_t>(b) * num_heads + h) * n * n + key;
            if (key < n && col < n) dst[static_cast<size_t>(col) * n] = p0;
            if (key < n && col + 1 < n) dst[static_cast<size_t>(col + 1) * n] = p1;
          }
        }
      }
      accumulate_rows<D>(dv, pa, gs, kRows * qc, lane);
      accumulate_rows<D>(dk, da, qs, kRows * qc, lane);
    }
  }
  __syncthreads();  // every warp is done with Q and g: stage dK and dV over them
  if (active) {
    store_strip<D>(op.dk + out_head, op.out_row, row0, n, dk, scale,
                   qs + warp * kRows * P, lane);
    store_strip<D>(op.dv + out_head, op.out_row, row0, n, dv, 1.f,
                   gs + warp * kRows * P, lane);
  }
}

template <int D, bool kProbe>
int launch_mma(const Operands<bf16>& op, const void* g, void* stats, int b, int n,
               int num_heads, float scale, float* probe1, float* probe2,
               cudaStream_t stream) {
  const size_t smem1 = mma_smem_dq<D>(n);
  const size_t smem2 = mma_smem_dkv<D>(n);
  auto dq = attention_bwd_dq_mma_kernel<D, kProbe>;
  auto dkv = attention_bwd_dkv_mma_kernel<D, kProbe>;
  cudaError_t err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, num_heads, b);
  const bf16* gg = static_cast<const bf16*>(g);
  float* st = static_cast<float*>(stats);
  const float scale_log2 = scale * 1.4426950408889634f;
  dq<<<grid, kThreads, smem1, stream>>>(op, gg, st, n, num_heads, scale, scale_log2,
                                        probe1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv<<<grid, kThreads, smem2, stream>>>(op, gg, st, n, num_heads, scale, scale_log2,
                                         probe2);
  return static_cast<int>(cudaGetLastError());
}

// --- dispatch by dtype (route) and head dim ----------------------------------

template <int D>
int launch_route(const Operands<float>& op, const void* g, void* stats, int b, int n,
                 int num_heads, float scale, cudaStream_t stream) {
  return launch<float, D>(op, g, stats, b, n, num_heads, scale, stream);
}
template <int D>
int launch_route(const Operands<bf16>& op, const void* g, void* stats, int b, int n,
                 int num_heads, float scale, cudaStream_t stream) {
  return launch_mma<D, false>(op, g, stats, b, n, num_heads, scale, nullptr, nullptr,
                              stream);
}

template <typename T>
int dispatch_d(const Operands<T>& op, const void* g, void* stats, int b, int n,
               int num_heads, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_route<32>(op, g, stats, b, n, num_heads, scale, stream);
    case 64: return launch_route<64>(op, g, stats, b, n, num_heads, scale, stream);
    case 128: return launch_route<128>(op, g, stats, b, n, num_heads, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_slab(const void* qkv, const void* g, void* dqkv, void* stats, int b, int n,
                  int num_heads, int d, float scale, cudaStream_t stream) {
  const T* in = static_cast<const T*>(qkv);
  T* out = static_cast<T*>(dqkv);
  const int c = num_heads * d;
  const Operands<T> op{in, in + c, in + 2 * c, 3LL * n * c, 3 * c,
                       out, out + c, out + 2 * c, 3LL * n * c, 3 * c};
  return dispatch_d<T>(op, g, stats, b, n, num_heads, d, scale, stream);
}

template <typename T>
Operands<T> three(const void* q, const void* k, const void* v, long long in_batch,
                  int in_row, void* dq, void* dk, void* dv, long long out_batch,
                  int out_row) {
  return Operands<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), in_batch, in_row,
                     static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
                     out_batch, out_row};
}

template <typename T, int D>
size_t smem_max(int n) {
  const size_t a = smem_dq<T, D>(n);
  const size_t c = smem_dkv<T, D>(n);
  return a > c ? a : c;
}

size_t smem_for_d(int n, int d, int dtype) {
  if (dtype == 0) {
    switch (d) {
      case 32: return smem_max<float, 32>(n);
      case 64: return smem_max<float, 64>(n);
      case 128: return smem_max<float, 128>(n);
    }
  } else if (dtype == 1) {  // pass 2 needs the more
    switch (d) {
      case 32: return mma_smem_dkv<32>(n);
      case 64: return mma_smem_dkv<64>(n);
      case 128: return mma_smem_dkv<128>(n);
    }
  }
  return 0;
}

}  // namespace

// The larger of the two passes' dynamic shared memory. dtype: 0 = float32
// (SIMT route), 1 = bfloat16 (tensor-core route).
extern "C" size_t tic_slab_attention_bwd_smem_bytes(int n, int d, int dtype) {
  return smem_for_d(n, d, dtype);
}

// The slab form (K2): a contiguous (B, N, 3C) slab in, its (B, N, 3C)
// gradient out. Launches both passes on `stream` without synchronising;
// returns the first nonzero cudaGetLastError(). `stats` is (3, B, H, N) f32
// scratch.
extern "C" int tic_slab_attention_bwd(const void* qkv, const void* g, void* dqkv,
                                      void* stats, int b, int n, int num_heads, int d,
                                      int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_slab<float>(qkv, g, dqkv, stats, b, n, num_heads, d, scale, s);
  if (dtype == 1)
    return dispatch_slab<bf16>(qkv, g, dqkv, stats, b, n, num_heads, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The three-operand form (K3): q, k, v with a shared batch and row stride in,
// dq, dk, dv with theirs out (elements), g a contiguous (B, N, C). Launches
// both passes as tic_slab_attention_bwd does.
extern "C" int tic_attention_bwd(const void* q, const void* k, const void* v,
                                 long long in_batch, int in_row, const void* g,
                                 void* dq, void* dk, void* dv, long long out_batch,
                                 int out_row, void* stats, int b, int n, int num_heads,
                                 int d, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(three<float>(q, k, v, in_batch, in_row, dq, dk, dv,
                                          out_batch, out_row),
                             g, stats, b, n, num_heads, d, scale, s);
  if (dtype == 1)
    return dispatch_d<bf16>(three<bf16>(q, k, v, in_batch, in_row, dq, dk, dv, out_batch,
                                        out_row),
                            g, stats, b, n, num_heads, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A measurement entry point, on no path of the model: the bf16 route of
// tic_attention_bwd, which also writes the probabilities each pass forms,
// as f32 (B, H, N, N) P[i][j], pass 1's to probe1 and pass 2's to probe2.
extern "C" int tic_attention_bwd_probes(const void* q, const void* k, const void* v,
                                        long long in_batch, int in_row, const void* g,
                                        void* dq, void* dk, void* dv, long long out_batch,
                                        int out_row, void* stats, int b, int n,
                                        int num_heads, int d, float scale, void* probe1,
                                        void* probe2, void* stream) {
  const Operands<bf16> op =
      three<bf16>(q, k, v, in_batch, in_row, dq, dk, dv, out_batch, out_row);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p1 = static_cast<float*>(probe1);
  float* p2 = static_cast<float*>(probe2);
  switch (d) {
    case 32: return launch_mma<32, true>(op, g, stats, b, n, num_heads, scale, p1, p2, s);
    case 64: return launch_mma<64, true>(op, g, stats, b, n, num_heads, scale, p1, p2, s);
    case 128: return launch_mma<128, true>(op, g, stats, b, n, num_heads, scale, p1, p2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
