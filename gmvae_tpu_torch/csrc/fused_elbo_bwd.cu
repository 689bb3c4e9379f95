// Fused mixture-ELBO head backward for Hopper (sm_90a).
//
// Replaces the TPU kernels gmvae_tpu/ops/kernels/fused_elbo_bwd.py:
// _bwd_kernel_flat and :_bwd_kernel (the same hand-derived VJP in the
// TPU's flat and (TB, K, D) layouts; one kernel here serves every shape).
// It computes what gmvae_tpu_torch/ops/kernels/fused_elbo_bwd.py:manual_bwd
// computes, the analytic VJP of the head:
//
//   inputs      k_logits [B,K], q_means/q_logvars [B,K,D], pi_logits [K],
//               prior means/logvars [K,D], cotangents cs [B,8] (log_prior_mix,
//               log_q_mix, log_p_cond, log_q_cond, kl_cat, 0, 0, 0),
//               cz [B,D], cy [B,K]; the threefry key or the streamed noise
//   outputs     d_k_logits [B,K], d_q_means/d_q_logvars [B,K,D] (logvars
//               masked outside the inclusive clamp band [-12, 12]),
//               d_pi [K], d_prior_means/d_prior_logvars [K,D] (batch sums)
//
// The row's noise, y, z and component densities are recomputed by
// head_row.cuh:row_forward, the forward kernel's own function, so no noise
// residuals cross device memory and a hard y has the forward's argmax. The
// recomputation runs in float64 from the float32 inputs, noise and y
// (row_forward<double>: the q-mixture, z, each component log-density term
// and its sum), and so do the two LSE weights (D/E), each rounded to float32
// once; the VJP is float32. At D >= 64 the float32 recomputation's rounding
// was most of d_k_logits' and d_q_means' error from float64 (PERF.md §6).
//
// What bounds it on an H100: bytes. A row reads 2*K*D + 2K + D + 8 floats
// and writes 2*K*D + K, for about 50*K*D operations (18*K*D of them in
// float64): far below the card's balance point. At the flagship shape the
// function moves ~230 KB (0.07 us at 3.35 TB/s), so the chain of dependent
// phases through a row sets the time in practice.
//
// Design. One launch of min(B, P) blocks, P the blocks the card holds at
// once at (K, D) (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the
// SMs): a cooperative launch, so every block is resident at once. Block i
// takes rows i, i + P, i + 2P, ... in order (one row where B <= P).
// - The row's q tiles and the prior are staged in shared memory once, as
//   in the forward (head_row.cuh:stage_row). The VJP's passes over (k, d)
//   after row_forward read shared memory: the densities' pull on z with the
//   prior gradients (pass F/G), then the q gradients (pass I), written in
//   place over the q tiles and stored by a TMA bulk copy where aligned. At
//   (128,64,256), where the prior is not staged, it is read twice: in
//   row_forward's density pass and in pass F/G.
// - The K-vector steps run on separate warps: the two LSE weights (D/E) on
//   warps 0 and 1, the latter also d_pi's row term, beside the per-d
//   conditionals (B/C) on every thread.
// - The batch sum of the prior gradients, in a fixed order and without
//   float atomics, spread over every block. A row's partial (d_pi's K
//   terms padded to 4, then d_pm's and d_plv's K*D each) is built in shared
//   memory; where it does not fit beside the tiles, pass F/G walks K in
//   chunks of kc components (d_plv's terms are masked to the clamp band
//   there, before any sum). Each chunk is added into the block's own row of
//   the scratch [blocks, pad4(K) + 2*K*D] (the thread that owns a column
//   reads, adds and writes it; the block's first row stores). After a grid
//   barrier on ticket 0, every block sums its own stripe of the columns over
//   the scratch rows in block order, its threads split into row slices
//   whose sums are added in a fixed tree; the last block past ticket 1
//   resets both tickets, so a call leaves no state behind. So d_prior[j] =
//   the tree over slices s of (sum over blocks i = s, s + S, ... of (sum
//   over block i's rows in order of the row's term)).
//
// The order is fixed by the shape and the card (P is cached by device and
// (K, D)): bit-identical run to run, though not to a sum in row order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "head_row.cuh"

namespace {

using namespace gmvae;

constexpr int kBwdWarps = 8;  // warps a block at most

struct Cotangents {
  const float* cs;  // [B, 8]
  const float* cz;  // [B, D]
  const float* cy;  // [B, K]
};

struct Grads {
  float* d_kl;       // [B, K]
  float* d_qm;       // [B, K, D]
  float* d_qlv;      // [B, K, D]
  float* d_pi;       // [K]
  float* d_pm;       // [K, D]
  float* d_plv;      // [K, D]
  float* scratch;    // [blocks, pad4(K) + 2*K*D]: a block's partial sum
  unsigned* ticket;  // [2]: [0] blocks arrived, [1] blocks done; 0 between
                     // calls
};

struct Plan {
  int B, stage_q, stage_p, kc;
};

// shared floats the backward adds to RowState: a_q, a_p, d_y, the prior
// terms of d_y [K]; d_z, d_mean, d_lv, d_pmean, d_pl [D]
inline size_t bwd_extra_floats(int K, int D) {
  return 4 * static_cast<size_t>(K) + 5 * static_cast<size_t>(D);
}

// a prior-gradient partial: d_pi's terms padded to 4 floats, then d_pm's
// and d_plv's [K*D each], so both start 16-byte aligned when K*D % 4 == 0
__host__ __device__ inline int partial_floats(int K, int D) {
  return pad4(K) + 2 * K * D;
}

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float shfl_down(float v, int h, int width) {
  return __shfl_down_sync(kFull, v, h, width);
}

__device__ __forceinline__ float4 shfl_down(float4 v, int h, int width) {
  return make_float4(shfl_down(v.x, h, width), shfl_down(v.y, h, width),
                     shfl_down(v.z, h, width), shfl_down(v.w, h, width));
}

// A segment of the prior-gradient partial: n floats at `src` in shared
// memory, at column `off` of each scratch row; moved in float4 quads where
// every row can take them (seg_vec), else in floats.
struct Segment {
  float* src;
  int n, off;
};

__device__ __forceinline__ bool seg_vec(const Segment& g, int cols,
                                        const float* scratch) {
  return ((g.n | g.off | cols) & 3) == 0 && aligned16(g.src) &&
         aligned16(scratch);
}

// The add of a segment of this row's partial into the block's scratch row
// `row` (the block's first row stores): each thread reads, adds and writes
// the columns it owns, the same ones every row.
template <typename V>
__device__ __forceinline__ void accumulate_as(const V* src, V* dst, int n,
                                              bool first) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const V v = src[j];
    __stcg(dst + j, first ? v : __ldcg(dst + j) + v);
  }
}

__device__ __forceinline__ void accumulate(const Segment& g, float* row,
                                           int cols, const float* scratch,
                                           bool first) {
  if (seg_vec(g, cols, scratch))
    accumulate_as(reinterpret_cast<const float4*>(g.src),
                  reinterpret_cast<float4*>(row + g.off), g.n / 4, first);
  else
    accumulate_as(static_cast<const float*>(g.src), row + g.off, g.n, first);
}

// Every block of the grid (all resident: a cooperative launch) waits here
// until all have arrived; their writes before it are visible after it.
// `count` goes from 0 to the grid's blocks.
__device__ __forceinline__ void grid_barrier(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {  // the fence is cumulative: the block's writes
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if (seen >= gridDim.x) break;
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// the sum of column (or column quad) j of the scratch over its rows s,
// s + S, ... below n, in order, loads issued kRowBatch at a time
constexpr int kRowBatch = 8;

template <typename V>
__device__ __forceinline__ V slice_sum(const V* scratch, int s, int S, int n,
                                       int cols, int j) {
  V acc{};  // replaced by the first row's value
  for (int c0 = s; c0 < n; c0 += kRowBatch * S) {
    V v[kRowBatch];
#pragma unroll
    for (int q = 0; q < kRowBatch; ++q)
      if (c0 + q * S < n)
        v[q] = __ldcg(scratch + static_cast<size_t>(c0 + q * S) * cols + j);
#pragma unroll
    for (int q = 0; q < kRowBatch; ++q)
      if (c0 + q * S < n) acc = (c0 + q * S == s) ? v[q] : acc + v[q];
  }
  return acc;
}

// The batch sum of the block's stripe of `cols` columns of V over the n
// scratch rows, each column to emit(column, sum). The block's threads take
// S consecutive lanes a column (S a power of two, at most 32, n and the
// threads over the stripe's width): lane s sums rows s, s + S, ... in
// order, and the lanes' sums meet in a fixed tree of shuffles.
template <typename V, typename Emit>
__device__ __forceinline__ void stripe_sum_as(const V* scratch, int n,
                                              int cols, int lo, int hi,
                                              Emit emit) {
  const int w = hi - lo;
  const int T = blockDim.x;
  int S = 1;
  while (S < 32 && 2 * S * w <= T && 2 * S <= n) S *= 2;
  const int s = threadIdx.x % S;
  for (int j0 = lo; j0 < hi; j0 += T / S) {  // the same turns in every lane
    const int j = j0 + static_cast<int>(threadIdx.x) / S;
    V v{};
    if (j < hi) v = slice_sum(scratch, s, S, n, cols, j);
    for (int h = S / 2; h > 0; h /= 2) v = v + shfl_down(v, h, S);
    if (s == 0 && j < hi) emit(j, v);
  }
}

// The block's stripe of the partial's columns (its share of them, in
// float4 quads where the scratch rows take them, else in floats), summed
// over the n scratch rows into d_pi, d_pm and d_plv.
__device__ __forceinline__ void stripe_sum(const Grads& out, int n, int K,
                                           int D) {
  const int kp = pad4(K), kd = K * D, cols = partial_floats(K, D);
  auto emit = [&](int j, float v) {
    if (j < K)
      out.d_pi[j] = v;
    else if (j >= kp && j < kp + kd)
      out.d_pm[j - kp] = v;
    else if (j >= kp + kd)
      out.d_plv[j - kp - kd] = v;
  };
  const bool vec = (cols & 3) == 0 && aligned16(out.scratch);
  const int items = vec ? cols / 4 : cols;
  const int blocks = gridDim.x;
  const int per = (items + blocks - 1) / blocks;
  const int lo = min(items, static_cast<int>(blockIdx.x) * per);
  const int hi = min(items, lo + per);
  if (vec)
    stripe_sum_as(reinterpret_cast<const float4*>(out.scratch), n, items, lo,
                  hi, [&](int j, float4 v) {
                    emit(4 * j, v.x);
                    emit(4 * j + 1, v.y);
                    emit(4 * j + 2, v.z);
                    emit(4 * j + 3, v.w);
                  });
  else
    stripe_sum_as(out.scratch, n, items, lo, hi, emit);
}

// two blocks an SM at most 128 registers a thread, so two rows share an SM
// where shared memory allows (every 128-row config's shape): P is 264 there
__global__ void __launch_bounds__(32 * kBwdWarps, 2)
    fused_elbo_bwd_kernel(const HeadIn in, const Cotangents ct,
                          const Grads out, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = in.K, D = in.D, L = in.L;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int G = T / L;
  const int g = t / L;
  const int l = t % L;
  const size_t gd = static_cast<size_t>(G) * D;
  const int kd = K * D;
  const int kp = pad4(K);
  const int cols = partial_floats(K, D);

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* tiles = reinterpret_cast<float*>(smem_raw + kHeaderBytes);
  float* pi_part =
      tiles + static_cast<size_t>(2 * (p.stage_q + p.stage_p)) * kd;
  float* pm_part = pi_part + kp;      // [kc, D] a chunk of its d_pm terms
  float* plv_part = pm_part + static_cast<size_t>(p.kc) * D;  // [kc, D]
  const RowState<double> st =
      row_state<double>(plv_part + static_cast<size_t>(p.kc) * D, K, D, G);
  float* aq = st.red + 8;  // [K] c_lqm * softmax(log q(k|x) + cq)
  float* ap = aq + K;      // [K] c_lpm * softmax(log pi + cp)
  float* dy = ap + K;      // [K] d y
  float* dyp = dy + K;     // [K] the prior's terms of d y
  float* dz = dyp + K;     // [D]
  float* dmean = dz + D;   // [D]
  float* dlv = dmean + D;  // [D]
  float* dpmean = dlv + D; // [D]
  float* dpl = dpmean + D; // [D]
  float* fq = st.part;                // [G][D] pass F/G's partials, q
  float* fp = st.part + gd;           // [G][D] and the prior
  float* scratch = out.scratch + static_cast<size_t>(blockIdx.x) * cols;
  // the partial's segments: d_pi's terms, then a chunk's d_pm and d_plv
  const Segment pi_seg{pi_part, kp, 0};
  auto pm_seg = [&](int k0, int k1) {
    return Segment{pm_part, (k1 - k0) * D, kp + k0 * D};
  };
  auto plv_seg = [&](int k0, int k1) {
    return Segment{plv_part, (k1 - k0) * D, kp + kd + k0 * D};
  };
  // with one chunk the shared partial is laid out as a scratch row: one
  // segment
  const Segment row_seg{pi_part, cols, 0};
  const int chunks = (K + p.kc - 1) / p.kc;
  const int k_last = (chunks - 1) * p.kc;  // the last chunk's first k
  int staged_mode = kStageNone;

  // rows blockIdx.x, + gridDim.x, ... in order (the grid is at most B)
  for (int row = blockIdx.x; row < p.B; row += gridDim.x) {
    const bool first = row == static_cast<int>(blockIdx.x);
    if (!first) {
      // the last row's bulk store reads the tiles until it is done, and
      // this row's copies rewrite them through the async proxy
      if (t == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        if (staged_mode == kStageBulk)
          asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(
                           smem_addr(bar))
                       : "memory");
      }
      __syncthreads();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    RowIn r = row_in(in, row);
    const Staging staged = stage_row(tiles, kd, p.stage_q, p.stage_p, r, bar);
    staged_mode = staged.mode;
    row_forward(in, r, st, row, staged, nullptr, nullptr);

    const float* cs = ct.cs + static_cast<size_t>(row) * 8;
    const float c_lpm = cs[0], c_lqm = cs[1], c_lpc = cs[2], c_lqc = cs[3],
                c_klc = cs[4];

    // ---- B/C. the prior's mixing and the y-interpolated conditionals ----
    // z - mean (= e^{lv/2} eps) and z - pmean from the double z and mean
    for (int d = t; d < D; d += T) {
      const double z = st.zs[d];
      float pmean, pl;
      prior_mix(st, D, G, d, pmean, pl);
      const float zq = static_cast<float>(z - st.mix[d]);
      const float zp = static_cast<float>(z - static_cast<double>(pmean));
      const float r_q = zq * expf(-static_cast<float>(st.mix[D + d]));
      const float r_p = zp * expf(-pl);
      dz[d] = ct.cz[static_cast<size_t>(row) * D + d] - c_lqc * r_q -
              c_lpc * r_p;
      dmean[d] = c_lqc * r_q;
      dlv[d] = c_lqc * 0.5f * (zq * r_q - 1.f);
      dpmean[d] = c_lpc * r_p;
      dpl[d] = c_lpc * 0.5f * (zp * r_p - 1.f);
    }
    for (size_t i = t; i < 2 * gd; i += T) st.part[i] = 0.f;
    // ---- D/E. the LSE weights in double (warps 0 and 1), rounded to
    // float once; A. d_pi's row term --------------------------------------
    if (warp == 0) {
      double m = -INFINITY;
      for (int k = lane; k < K; k += 32)
        m = fmax(m, static_cast<double>(st.lq[k]) + st.cq[k]);
      m = warp_max(m);
      double s = 0.0;
      for (int k = lane; k < K; k += 32)
        s += exp(static_cast<double>(st.lq[k]) + st.cq[k] - m);
      s = warp_sum(s);
      float saq = 0.f;
      for (int k = lane; k < K; k += 32) {
        const double w =
            exp(static_cast<double>(st.lq[k]) + st.cq[k] - m) / s;
        aq[k] = c_lqm * static_cast<float>(w);
        saq += aq[k];
      }
      saq = warp_sum(saq);
      if (lane == 0) st.red[1] = saq;
    } else if (warp == 1) {
      double m = -INFINITY;
      for (int k = lane; k < K; k += 32) m = fmax(m, st.cp[k]);
      m = warp_max(m);
      double s = 0.0;
      for (int k = lane; k < K; k += 32) s += exp(st.cp[k] - m);
      s = warp_sum(s);
      for (int k = lane; k < K; k += 32) {
        ap[k] = c_lpm * static_cast<float>(exp(st.cp[k] - m) / s);
        const float pi_k = expf(st.lp[k]);
        pi_part[k] = c_klc * (pi_k - expf(st.lq[k])) + ap[k] - c_lpm * pi_k;
      }
    }
    __syncthreads();

    // ---- F/G. the densities' pull on z (per-group partials), the prior
    // gradients and the prior's terms of d_y, per (k, d), in chunks of kc
    // components; every chunk but the last added into the block's scratch
    // row here
    for (int c = 0; c < chunks; ++c) {
      const int k0 = c * p.kc, k1 = min(K, k0 + p.kc);
      // the loop counts are the same for every thread (see row_forward)
      for (int kb = k0; kb < k1; kb += G) {
        const int k = kb + g;
        float acc = 0.f;
        if (k < k1) {
          const float y = st.ys[k];
          const float a_q = aq[k], a_p = ap[k];
          float* __restrict__ pmc = pm_part + static_cast<size_t>(k - k0) * D;
          float* __restrict__ plc =
              plv_part + static_cast<size_t>(k - k0) * D;
          float* __restrict__ fqg = fq + static_cast<size_t>(g) * D;
          float* __restrict__ fpg = fp + static_cast<size_t>(g) * D;
          for (int d = l; d < D; d += L) {
            const size_t i = static_cast<size_t>(k) * D + d;
            const float z = static_cast<float>(st.zs[d]);
            const float lvq = clamp_logvar(r.qlv[i]);
            const float plv_in = r.plv[i];
            const float lvp = clamp_logvar(plv_in);
            const float pm = r.pm[i];
            const float dp = z - pm;
            const float dpe = dp * expf(-lvp);
            fqg[d] += a_q * ((z - r.qm[i]) * expf(-lvq));
            fpg[d] += a_p * dpe;
            pmc[d] = y * dpmean[d] + a_p * dpe;
            // masked to the clamp band here: the batch sum of masked
            // terms is the masked batch sum
            plc[d] = (y * dpl[d] + a_p * 0.5f * (dp * dpe - 1.f)) *
                     band_mask(plv_in);
            acc += pm * dpmean[d] + lvp * dpl[d];
          }
        }
        acc = group_sum(acc, L);
        if (l == 0 && k < k1) dyp[k] = acc;
      }
      if (c + 1 < chunks) {
        __syncthreads();
        accumulate(pm_seg(k0, k1), scratch, cols, out.scratch, first);
        accumulate(plv_seg(k0, k1), scratch, cols, out.scratch, first);
        __syncthreads();  // the chunk buffers are free again
      }
    }
    __syncthreads();

    // ---- H. d_z complete; z = mean + e^{lv/2} eps -------------------------
    for (int d = t; d < D; d += T) {
      float sq = 0.f, sp = 0.f;
#pragma unroll 8
      for (int j = 0; j < G; ++j) {
        sq += fq[static_cast<size_t>(j) * D + d];
        sp += fp[static_cast<size_t>(j) * D + d];
      }
      const float dzd = dz[d] - sq - sp;
      dz[d] = dzd;
      dmean[d] += dzd;
      dlv[d] += dzd * 0.5f *
                expf(0.5f * static_cast<float>(st.mix[D + d])) * st.es[d];
    }
    __syncthreads();

    // ---- I. the q gradients and the rest of d_y, per (k, d) ----------------
    // written in place over the staged q tiles (each element read, then
    // written, by one thread), else straight to device memory
    const size_t row_kd = static_cast<size_t>(row) * kd;
    float* dqm = p.stage_q ? tiles : out.d_qm + row_kd;
    float* dqlv = p.stage_q ? tiles + kd : out.d_qlv + row_kd;
    for (int kb = 0; kb < K; kb += G) {
      const int k = kb + g;
      float acc = 0.f;
      if (k < K) {
        const float y = st.ys[k];
        const float a_q = aq[k];
        for (int d = l; d < D; d += L) {
          const size_t i = static_cast<size_t>(k) * D + d;
          const float z = static_cast<float>(st.zs[d]);
          const float qlv_in = r.qlv[i];
          const float lvq = clamp_logvar(qlv_in);
          const float qm = r.qm[i];
          const float dq = z - qm;
          const float dqe = dq * expf(-lvq);
          dqm[i] = a_q * dqe + y * dmean[d];
          dqlv[i] = (a_q * 0.5f * (dq * dqe - 1.f) + y * dlv[d]) *
                    band_mask(qlv_in);
          acc += qm * dmean[d] + lvq * dlv[d];
        }
      }
      acc = group_sum(acc, L);
      if (l == 0 && k < K)
        dy[k] = ct.cy[static_cast<size_t>(row) * K + k] + dyp[k] + acc;
    }
    if (p.stage_q) {
      // the tiles, rewritten by the generic proxy, out by the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t bytes = static_cast<uint32_t>(kd) * 4u;
      if ((kd & 3) == 0 && aligned16(out.d_qm + row_kd) &&
          aligned16(out.d_qlv + row_kd)) {
        if (t == 0) {
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
              "%2;\n" ::"l"(gmem_addr(out.d_qm + row_kd)),
              "r"(smem_addr(dqm)), "r"(bytes)
              : "memory");
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
              "%2;\n" ::"l"(gmem_addr(out.d_qlv + row_kd)),
              "r"(smem_addr(dqlv)), "r"(bytes)
              : "memory");
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      } else {
        store_row(out.d_qm + row_kd, dqm, kd);
        store_row(out.d_qlv + row_kd, dqlv, kd);
      }
    } else {
      __syncthreads();
    }

    // ---- J/K. d k_logits (warp 0) -------------------------------------------
    if (warp == 0) {
      float sdy = 0.f;
      for (int k = lane; k < K; k += 32) sdy += dy[k] * st.ysoft[k];
      sdy = warp_sum(sdy);
      const float kl = st.red[0], saq = st.red[1];
      for (int k = lane; k < K; k += 32) {
        const float qk = expf(st.lq[k]);
        const float ysoft = st.ysoft[k];
        out.d_kl[static_cast<size_t>(row) * K + k] =
            c_klc * qk * ((st.lq[k] - st.lp[k]) - kl) +
            (dy[k] - sdy) * ysoft / *in.tau + aq[k] - qk * saq;
      }
    }
    // the last chunk's and d_pi's terms into the block's scratch row (H, I
    // and J/K leave them be; the next row's first barrier is after them)
    if (chunks == 1) {
      accumulate(row_seg, scratch, cols, out.scratch, first);
    } else {
      accumulate(pi_seg, scratch, cols, out.scratch, first);
      accumulate(pm_seg(k_last, K), scratch, cols, out.scratch, first);
      accumulate(plv_seg(k_last, K), scratch, cols, out.scratch, first);
    }
  }

  // ---- M/N. the batch sums: every block's rows are in the scratch; each
  // block sums its stripe of the columns over the blocks' rows --------------
  if (p.stage_q && t == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  grid_barrier(out.ticket);
  stripe_sum(out, gridDim.x, K, D);
  // every block is past the barrier's wait once all are here
  if (t == 0 && atomicAdd(out.ticket + 1, 1u) == gridDim.x - 1) {
    atomicExch(out.ticket, 0u);
    atomicExch(out.ticket + 1, 0u);
  }
}

// The backward's launch at (K, D): its block and shared memory
// (plan_launch) and P, the blocks the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs). Cached by
// device and shape: every call at a shape launches min(B, P) blocks, so
// takes the same sum order.
struct BwdLaunch {
  LaunchPlan lp;
  int resident;  // P
};

cudaError_t bwd_launch(int K, int D, BwdLaunch* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, BwdLaunch> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, K, D);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  BwdLaunch b{plan_launch(K, D, bwd_extra_floats(K, D), true, kBwdWarps), 0};
  e = allow_smem(fused_elbo_bwd_kernel, b.lp.smem.bytes);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_elbo_bwd_kernel, 32 * b.lp.warps, b.lp.smem.bytes);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;  // too large
  b.resident = per_sm * sms;
  cache[key] = b;
  *out = b;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of prior-gradient scratch a call takes: one partial per block (0
// if the launch cannot be planned: the launch then reports the error).
size_t gmvae_fused_elbo_bwd_scratch(int B, int K, int D) {
  BwdLaunch b;
  if (bwd_launch(K, D, &b) != cudaSuccess) return 0;
  return static_cast<size_t>(std::min(B, b.resident)) * partial_floats(K, D);
}

// P at (K, D) on the current device: a call of more than P rows launches
// P blocks, each taking several rows. Minus the CUDA error if the launch
// cannot be planned.
int gmvae_fused_elbo_bwd_resident(int K, int D) {
  BwdLaunch b;
  const cudaError_t e = bwd_launch(K, D, &b);
  return e == cudaSuccess ? b.resident : -static_cast<int>(e);
}

// g_in/eps_in null: the forward's threefry noise regenerated from the key.
// `key` (two words) and `tau` are device pointers, read by the kernel.
// `scratch` holds gmvae_fused_elbo_bwd_scratch(B, K, D) floats;
// `ticket` is 0 and is left 0. One launch on `stream`; `blocks`, if not
// null, receives its blocks, min(B, P). Returns the launch's CUDA error (0
// on success).
int gmvae_fused_elbo_bwd(const float* k_logits, const float* q_means,
                         const float* q_logvars, const float* pi_logits,
                         const float* p_means, const float* p_logvars,
                         const float* g_in, const float* eps_in,
                         const float* cs, const float* cz, const float* cy,
                         float* d_kl, float* d_qm, float* d_qlv, float* d_pi,
                         float* d_pm, float* d_plv, float* scratch,
                         unsigned int* ticket, int B, int K, int D,
                         const unsigned int* key, const float* tau, int hard,
                         void* stream, int* blocks) {
  BwdLaunch b;
  cudaError_t e = bwd_launch(K, D, &b);
  if (e != cudaSuccess) return static_cast<int>(e);
  const HeadIn in{k_logits, q_means, q_logvars, pi_logits, p_means,
                  p_logvars, g_in,     eps_in,    K,         D,
                  group_lanes(D), key, tau,       hard};
  const SmemPlan& plan = b.lp.smem;
  const int n = std::min(B, b.resident);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(32 * b.lp.warps);
  cfg.dynamicSmemBytes = plan.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // the grid barrier's need
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_elbo_bwd_kernel, in,
                         Cotangents{cs, cz, cy},
                         Grads{d_kl, d_qm, d_qlv, d_pi, d_pm, d_plv, scratch,
                               ticket},
                         Plan{B, plan.stage_q, plan.stage_p, plan.kc});
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks != nullptr) *blocks = n;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
