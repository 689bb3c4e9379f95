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
// residuals cross device memory and a hard y has the forward's argmax.
//
// What bounds it on an H100: bytes. A row reads 2*K*D + 2K + D + 8 floats
// and writes 2*K*D + K, for about 50*K*D float operations: far below the
// card's balance point. At the flagship shape the function moves ~230 KB
// (0.07 us at 3.35 TB/s), so the chain of dependent phases through a row
// sets the time in practice.
//
// Design. One launch; one block per row, in thread-block clusters of C
// blocks, the grid padded to a multiple of C (padding blocks compute
// nothing and take part in the cluster barriers). C is the largest of
// min(8, B) and its halvings at which every cluster is resident at once
// (bwd_launch): a cluster that waited for a second wave would double the
// launch's time.
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
// - The batch sum of the prior gradients, in one launch and a fixed order,
//   without float atomics. Each block keeps its row's partial (d_pi's K
//   terms padded to 4, then d_pm's and d_plv's K*D each) in shared memory
//   and arrives at a split cluster barrier, whose wait comes after passes
//   H, I and J/K, so the blocks' skew hides behind them. Then each block
//   of cluster rank r reads its stripe of columns from the cluster's
//   blocks through distributed shared memory and sums it in rank order
//   into the cluster's row of the scratch [clusters, pad4(K) + 2*K*D]. The
//   block of rank r owns the same stripe in every cluster: after a
//   __threadfence it takes its rank's ticket (atomicAdd on an unsigned,
//   not a float sum), and the last block of the rank sums the stripe over
//   the clusters in cluster order and resets the ticket to 0, so a call
//   leaves no state behind (d_plv's terms are masked to the clamp band in
//   pass F/G, before any sum). So
//   d_prior[j] = sum over clusters c in order of (sum over ranks q in
//   order of row c*C + q's term): bit-identical run to run, though not to
//   a sum in row order. Where the partial does not fit beside the tiles,
//   pass F/G walks K in chunks of kc components, each summed across the
//   cluster in turn.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "head_row.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gmvae;

constexpr int kMaxCluster = 8;  // blocks a cluster (the portable limit)
// warps a block at most: small enough blocks that clusters of 8 stay
// resident (see bwd_launch)
constexpr int kBwdWarps = 8;

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
  float* scratch;    // [clusters, pad4(K) + 2*K*D]: a partial a cluster
  unsigned* ticket;  // [kMaxCluster] blocks of each rank done; 0 between
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

// A segment of the prior-gradient partial: n floats at `src` in each
// block's shared memory, at column `off` of each scratch row. The block of
// cluster rank r owns the segment's r-th of C contiguous stripes, in float4
// quads where every cluster can take them (seg_vec), else in floats: the
// same columns in every cluster.
struct Segment {
  float* src;
  int n, off;
};

__device__ __forceinline__ bool seg_vec(const Segment& g, int cols,
                                        const float* scratch) {
  return ((g.n | g.off | cols) & 3) == 0 && aligned16(g.src) &&
         aligned16(scratch);
}

// rank r's stripe [lo, hi) of n items
struct Stripe {
  int lo, hi;
};

__device__ __forceinline__ Stripe stripe(int n, int rank, int C) {
  const int per = (n + C - 1) / C;
  return Stripe{min(n, rank * per), min(n, (rank + 1) * per)};
}

// The cluster's sum of the segment over its first `ranks` blocks, in rank
// order, into this cluster's scratch row: this block's stripe. A column's
// loads through distributed shared memory are issued together, then added.
template <typename V>
__device__ __forceinline__ void cluster_sum_as(cg::cluster_group& cl,
                                               const Segment& g, int n,
                                               int ranks, V* dst) {
  const Stripe sr = stripe(n, static_cast<int>(cl.block_rank()),
                           static_cast<int>(cl.num_blocks()));
  const V* from[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    from[q] = reinterpret_cast<const V*>(
        cl.map_shared_rank(g.src, q < ranks ? q : 0));
  for (int j = sr.lo + threadIdx.x; j < sr.hi; j += blockDim.x) {
    V v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < ranks) v[q] = from[q][j];
    V s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < ranks) s = s + v[q];
    dst[j] = s;
  }
}

__device__ __forceinline__ void cluster_sum(cg::cluster_group& cl,
                                            const Segment& g, int ranks,
                                            float* row, int cols,
                                            const float* scratch) {
  if (seg_vec(g, cols, scratch))
    cluster_sum_as(cl, g, g.n / 4, ranks,
                   reinterpret_cast<float4*>(row + g.off));
  else
    cluster_sum_as(cl, g, g.n, ranks, row + g.off);
}

// the sum over the n cluster rows of the scratch's column (or column quad)
// j, in row order, loads issued kRowBatch at a time
constexpr int kRowBatch = 8;

template <typename V>
__device__ __forceinline__ V scratch_sum(const V* scratch, int n, int cols,
                                         int j) {
  V s;
  for (int c0 = 0; c0 < n; c0 += kRowBatch) {
    V v[kRowBatch];
#pragma unroll
    for (int q = 0; q < kRowBatch; ++q)
      if (c0 + q < n) v[q] = __ldcg(scratch + static_cast<size_t>(c0 + q) * cols + j);
#pragma unroll
    for (int q = 0; q < kRowBatch; ++q)
      if (c0 + q < n) s = (c0 + q == 0) ? v[q] : s + v[q];
  }
  return s;
}

// The batch sum of this block's stripe of a segment: the scratch rows of
// the n clusters in cluster order, each column to emit(column, sum).
template <typename Emit>
__device__ __forceinline__ void stripe_sum(const Segment& g, int n, int cols,
                                           const float* scratch, int rank,
                                           int C, Emit emit) {
  if (seg_vec(g, cols, scratch)) {
    const float4* s4 = reinterpret_cast<const float4*>(scratch + g.off);
    const Stripe sr = stripe(g.n / 4, rank, C);
    for (int j = sr.lo + threadIdx.x; j < sr.hi; j += blockDim.x) {
      const float4 s = scratch_sum(s4, n, cols / 4, j);
      emit(g.off + 4 * j, s.x);
      emit(g.off + 4 * j + 1, s.y);
      emit(g.off + 4 * j + 2, s.z);
      emit(g.off + 4 * j + 3, s.w);
    }
  } else {
    const Stripe sr = stripe(g.n, rank, C);
    for (int j = sr.lo + threadIdx.x; j < sr.hi; j += blockDim.x)
      emit(g.off + j, scratch_sum(scratch + g.off, n, cols, j));
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(32 * kBwdWarps)
    fused_elbo_bwd_kernel(const HeadIn in, const Cotangents ct,
                          const Grads out, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int cid = blockIdx.x / C;
  const int ranks = min(C, p.B - cid * C);  // rows of this cluster
  const int row = blockIdx.x;
  const bool live = row < p.B;
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
  int* last_of_rank = reinterpret_cast<int*>(smem_raw + 8);
  float* tiles = reinterpret_cast<float*>(smem_raw + kHeaderBytes);
  float* pi_part =
      tiles + static_cast<size_t>(2 * (p.stage_q + p.stage_p)) * kd;
  float* pm_part = pi_part + kp;      // [kc, D] a chunk of its d_pm terms
  float* plv_part = pm_part + static_cast<size_t>(p.kc) * D;  // [kc, D]
  const RowState st =
      row_state(plv_part + static_cast<size_t>(p.kc) * D, K, D, G);
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
  float* scratch = out.scratch + static_cast<size_t>(cid) * cols;
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / C;
  // the partial's segments: d_pi's terms, then a chunk's d_pm and d_plv
  const Segment pi_seg{pi_part, kp, 0};
  auto pm_seg = [&](int k0, int k1) {
    return Segment{pm_part, (k1 - k0) * D, kp + k0 * D};
  };
  auto plv_seg = [&](int k0, int k1) {
    return Segment{plv_part, (k1 - k0) * D, kp + kd + k0 * D};
  };

  RowIn r{};
  float c_lpm = 0.f, c_lqm = 0.f, c_lpc = 0.f, c_lqc = 0.f, c_klc = 0.f;
  if (live) {
    r = row_in(in, row);
    const Staging staged = stage_row(tiles, kd, p.stage_q, p.stage_p, r, bar);
    row_forward(in, r, st, row, staged, nullptr, nullptr);

    const float* cs = ct.cs + static_cast<size_t>(row) * 8;
    c_lpm = cs[0];
    c_lqm = cs[1];
    c_lpc = cs[2];
    c_lqc = cs[3];
    c_klc = cs[4];

    // ---- B/C. the prior's mixing and the y-interpolated conditionals ------
    for (int d = t; d < D; d += T) {
      const float z = st.zs[d];
      const float mean = st.mix[d], lv = st.mix[D + d];
      float pmean, pl;
      prior_mix(st, D, G, d, pmean, pl);
      const float r_q = (z - mean) * expf(-lv);
      const float r_p = (z - pmean) * expf(-pl);
      dz[d] = ct.cz[static_cast<size_t>(row) * D + d] - c_lqc * r_q -
              c_lpc * r_p;
      dmean[d] = c_lqc * r_q;
      dlv[d] = c_lqc * 0.5f * ((z - mean) * r_q - 1.f);
      dpmean[d] = c_lpc * r_p;
      dpl[d] = c_lpc * 0.5f * ((z - pmean) * r_p - 1.f);
    }
    for (size_t i = t; i < 2 * gd; i += T) st.part[i] = 0.f;
    // ---- D/E. the LSE weights (warps 0 and 1); A. d_pi's row term ---------
    if (warp == 0) {
      float m = -INFINITY;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, st.lq[k] + st.cq[k]);
      m = warp_max(m);
      float s = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float e = expf(st.lq[k] + st.cq[k] - m);
        aq[k] = e;
        s += e;
      }
      s = warp_sum(s);
      float saq = 0.f;
      for (int k = lane; k < K; k += 32) {
        aq[k] = c_lqm * (aq[k] * __frcp_rn(s));
        saq += aq[k];
      }
      saq = warp_sum(saq);
      if (lane == 0) st.red[1] = saq;
    } else if (warp == 1) {
      float m = -INFINITY;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, st.cp[k]);
      m = warp_max(m);
      float s = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float e = expf(st.cp[k] - m);
        ap[k] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int k = lane; k < K; k += 32) {
        ap[k] = c_lpm * (ap[k] * __frcp_rn(s));
        const float pi_k = expf(st.lp[k]);
        pi_part[k] = c_klc * (pi_k - expf(st.lq[k])) + ap[k] - c_lpm * pi_k;
      }
    }
    __syncthreads();
  }

  // ---- F/G. the densities' pull on z (per-group partials), the prior
  // gradients and the prior's terms of d_y, per (k, d), in chunks of kc
  // components; every chunk but the last summed across the cluster here
  const int chunks = (K + p.kc - 1) / p.kc;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * p.kc, k1 = min(K, k0 + p.kc);
    if (live) {
      // the loop counts are the same for every thread (see row_forward)
      for (int kb = k0; kb < k1; kb += G) {
        const int k = kb + g;
        float acc = 0.f;
        if (k < k1) {
          const float y = st.ys[k];
          const float a_q = aq[k], a_p = ap[k];
          float* __restrict__ pmc = pm_part + static_cast<size_t>(k - k0) * D;
          float* __restrict__ plc = plv_part + static_cast<size_t>(k - k0) * D;
          float* __restrict__ fqg = fq + static_cast<size_t>(g) * D;
          float* __restrict__ fpg = fp + static_cast<size_t>(g) * D;
          for (int d = l; d < D; d += L) {
            const size_t i = static_cast<size_t>(k) * D + d;
            const float z = st.zs[d];
            const float lvq = clamp_logvar(r.qlv[i]);
            const float plv_in = r.plv[i];
            const float lvp = clamp_logvar(plv_in);
            const float pm = r.pm[i];
            const float dp = z - pm;
            const float dpe = dp * expf(-lvp);
            fqg[d] += a_q * ((z - r.qm[i]) * expf(-lvq));
            fpg[d] += a_p * dpe;
            pmc[d] = y * dpmean[d] + a_p * dpe;
            // masked to the clamp band here: the batch sum of masked terms
            // is the masked batch sum
            plc[d] = (y * dpl[d] + a_p * 0.5f * (dp * dpe - 1.f)) *
                     band_mask(plv_in);
            acc += pm * dpmean[d] + lvp * dpl[d];
          }
        }
        acc = group_sum(acc, L);
        if (l == 0 && k < k1) dyp[k] = acc;
      }
    }
    if (c + 1 < chunks) {
      cluster.sync();
      cluster_sum(cluster, pm_seg(k0, k1), ranks, scratch, cols, out.scratch);
      cluster_sum(cluster, plv_seg(k0, k1), ranks, scratch, cols,
                  out.scratch);
      cluster.sync();  // the chunk buffers are free again
    }
  }

  // the last chunk's and d_pi's terms are in shared memory: the cluster
  // may read them once every block has arrived (a split barrier, so the
  // blocks' skew hides behind H, I, J/K)
  cluster_arrive();
  if (live) {
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
      dlv[d] += dzd * 0.5f * expf(0.5f * st.mix[D + d]) * st.es[d];
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
          const float z = st.zs[d];
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
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
              ::"l"(gmem_addr(out.d_qm + row_kd)), "r"(smem_addr(dqm)),
              "r"(bytes)
              : "memory");
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
              ::"l"(gmem_addr(out.d_qlv + row_kd)), "r"(smem_addr(dqlv)),
              "r"(bytes)
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
            (dy[k] - sdy) * ysoft / in.tau + aq[k] - qk * saq;
      }
    }
  }

  // ---- M/N. the batch sums: this cluster's rows, then every cluster ------
  cluster_wait();
  // with one chunk the shared partial is laid out as a scratch row: one
  // segment
  const Segment row_seg{pi_part, cols, 0};
  const int k0 = (chunks - 1) * p.kc;
  if (chunks == 1) {
    cluster_sum(cluster, row_seg, ranks, scratch, cols, out.scratch);
  } else {
    cluster_sum(cluster, pi_seg, ranks, scratch, cols, out.scratch);
    cluster_sum(cluster, pm_seg(k0, K), ranks, scratch, cols, out.scratch);
    cluster_sum(cluster, plv_seg(k0, K), ranks, scratch, cols, out.scratch);
  }
  cluster_arrive();  // done reading the peers' shared memory
  // this block's stripe of the cluster's row is written; the last block of
  // its rank to get here sums that stripe over the clusters
  __syncthreads();
  if (t == 0) {  // the fence is cumulative: it covers the block's writes
    __threadfence();
    *last_of_rank = atomicAdd(out.ticket + rank, 1u) == n_clusters - 1u;
    __threadfence();
  }
  __syncthreads();
  if (*last_of_rank) {
    // column j's batch sum to its gradient: d_pi, d_pm, d_plv
    auto emit = [&](int j, float v) {
      if (j < K)
        out.d_pi[j] = v;
      else if (j >= kp && j < kp + kd)
        out.d_pm[j - kp] = v;
      else if (j >= kp + kd)
        out.d_plv[j - kp - kd] = v;
    };
    if (chunks == 1)
      stripe_sum(row_seg, n_clusters, cols, out.scratch, rank, C, emit);
    else
      stripe_sum(pi_seg, n_clusters, cols, out.scratch, rank, C, emit);
    for (int c = 0; chunks > 1 && c < chunks; ++c) {
      const int c0 = c * p.kc, c1 = min(K, c0 + p.kc);
      stripe_sum(pm_seg(c0, c1), n_clusters, cols, out.scratch, rank, C,
                 emit);
      stripe_sum(plv_seg(c0, c1), n_clusters, cols, out.scratch, rank, C,
                 emit);
    }
    if (t == 0) atomicExch(out.ticket + rank, 0u);
  }
  // the bulk store reads the tiles until it is done
  if (live && p.stage_q && t == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  cluster_wait();  // the peers are done reading this block's partial
}

// The backward's launch at (B, K, D): its block and shared memory
// (plan_launch) and the cluster size C, the largest of min(8, B) and its
// halvings at which every cluster of the padded grid is resident at once
// (cudaOccupancyMaxActiveClusters), so that no cluster waits for a second
// wave. Cached by device and shape: every call at a shape takes the same
// C, so the same sum order.
struct BwdLaunch {
  LaunchPlan lp;
  int C, clusters;
};

cudaError_t bwd_launch(int B, int K, int D, BwdLaunch* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int>, BwdLaunch> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, B, K, D);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  BwdLaunch b{plan_launch(K, D, bwd_extra_floats(K, D), true, kBwdWarps), 1,
              B};
  e = allow_smem(fused_elbo_bwd_kernel, b.lp.smem.bytes);
  if (e != cudaSuccess) return e;
  for (int c = std::min(kMaxCluster, B); c > 1; c /= 2) {
    const int n = (B + c - 1) / c;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n * c);
    cfg.blockDim = dim3(32 * b.lp.warps);
    cfg.dynamicSmemBytes = b.lp.smem.bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int resident = 0;
    e = cudaOccupancyMaxActiveClusters(&resident, fused_elbo_bwd_kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (resident >= n) {
      b.C = c;
      b.clusters = n;
      break;
    }
  }
  cache[key] = b;
  *out = b;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of prior-gradient scratch a call takes: one partial per cluster
// (0 if the launch cannot be planned: the launch then reports the error).
size_t gmvae_fused_elbo_bwd_scratch(int B, int K, int D) {
  BwdLaunch b;
  if (bwd_launch(B, K, D, &b) != cudaSuccess) return 0;
  return static_cast<size_t>(b.clusters) * partial_floats(K, D);
}

// g_in/eps_in null: the forward's threefry noise regenerated from (k0, k1).
// `scratch` holds gmvae_fused_elbo_bwd_scratch(B, K, D) floats;
// `ticket` is 0 and is left 0. One launch on `stream`. Returns the launch's
// CUDA error (0 on success).
int gmvae_fused_elbo_bwd(const float* k_logits, const float* q_means,
                         const float* q_logvars, const float* pi_logits,
                         const float* p_means, const float* p_logvars,
                         const float* g_in, const float* eps_in,
                         const float* cs, const float* cz, const float* cy,
                         float* d_kl, float* d_qm, float* d_qlv, float* d_pi,
                         float* d_pm, float* d_plv, float* scratch,
                         unsigned int* ticket, int B, int K, int D,
                         unsigned int k0, unsigned int k1, float tau,
                         int hard, void* stream) {
  BwdLaunch b;
  cudaError_t e = bwd_launch(B, K, D, &b);
  if (e != cudaSuccess) return static_cast<int>(e);
  const HeadIn in{k_logits, q_means, q_logvars, pi_logits, p_means,
                  p_logvars, g_in,     eps_in,    K,         D,
                  group_lanes(D), k0,  k1,        tau,       hard};
  const SmemPlan& plan = b.lp.smem;
  const int C = b.C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b.clusters * C);
  cfg.blockDim = dim3(32 * b.lp.warps);
  cfg.dynamicSmemBytes = plan.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_elbo_bwd_kernel, in,
                         Cotangents{cs, cz, cy},
                         Grads{d_kl, d_qm, d_qlv, d_pi, d_pm, d_plv, scratch,
                               ticket},
                         Plan{B, plan.stage_q, plan.stage_p, plan.kc});
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
