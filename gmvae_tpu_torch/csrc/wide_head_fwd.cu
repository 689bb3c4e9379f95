// Wide-boundary mixture-ELBO head forward for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_head_boundary.py:_wide_kernel: the
// three posterior-head matmuls fused into the head forward, so the
// boundary tensors k_logits [B,K], q_means and q_logvars [B,K*D] never
// cross device memory on the forward. Per batch row:
//
//   k_logits = feats @ wk + bk,  q_means = feats @ wm + bm,
//   q_logvars = feats @ wlv + blv      (float32-exact, on the tensor cores)
//   then the head of fused_elbo_fwd.cu on them: soft y, threefry noise
//   (the narrow kernel's counters: rows 0..B-1 of the call)
//
// Inputs: feats [B,H], wk [H,K], bk [K], wm/wlv [H,N], bm/blv [N] (N = K*D),
// pi_logits [K], prior means/logvars [N]. Outputs: z [B,D], y [B,K],
// scal [B,8] (fused_elbo_fwd.cu's packing) and k_logits [B,K], all float32.
//
// What bounds it on an H100: operations, on paper. The function reads the
// weights once, H*(K+2N)*4 bytes (0.43 MB at H=512, K=10, D=10; 10.5 MB at
// K=20, D=128), and does 2*B*H*(K+2N) float32 operations for the
// projections (27.5 and 674 MFLOP at B=128): ~0.41 and ~10 us at 67 TFLOP/s
// outside the tensor cores against ~0.13 and ~3.2 us for its bytes at
// 3.35 TB/s. As done here, three TF32 products per float32 product (2.0
// GFLOP at cifar_head) take ~4.1 us at the tensor cores' 495 TFLOP/s. In
// practice the weight stripes' reads bound it: a tile's 16 rows need all
// the weights, so each of the 8 clusters of a B=128 call reads them, 656 KB
// a block at cifar_head, and one SM with 8 warps reads about 28 GB/s from
// L2 (measured: PERF.md), ~23 us.
//
// Design. The batch is cut into tiles of TB = 16 rows, one m16 fragment of
// the tensor cores' mma.sync.m16n8k8. Each tile is one thread-block
// cluster of C blocks, and the K + 2N columns of [wk | wm | wlv] are split
// over the cluster's ranks in stripes of `width` columns (a multiple of 8,
// the mma's n), so a cluster reads the weights once a tile, and a B=128
// call runs 8 clusters of 16 blocks on the card's 132 SMs. C is the
// largest of 16 (a non-portable cluster size), 8, 4, 2, 1 whose plan fits
// a block's shared memory and whose clusters are all resident at once
// (cudaOccupancyMaxActiveClusters): a cluster that waited for a second
// wave would double the launch's time. The results do not depend on C:
// each column's sum runs over H in one block, in h order.
// - Projections, float32-exact by 3xTF32: each operand x splits into
//   hi = x rounded to TF32 and lo = (x - hi) truncated to TF32, and each
//   product is hi*hi + (hi*lo + lo*hi); the dropped lo*lo term and lo's
//   truncation are ~2^-21 of the product. Plain TF32 (~2^-11) would break
//   the port's float32 contract. The tensor cores' own additions truncate,
//   so the hi*hi products of a stage go to a fresh accumulator, added to a
//   float32 total once a stage (over 64 k-steps, the truncation's bias had
//   grown k_logits' error to 4e-6 of the 1e-5 tolerance; now ~8e-7). The
//   cross terms, 2^-11 smaller, share one accumulator. mma.sync, not
//   wgmma: wgmma's 64-row tiles would leave 2 row tiles at B=128, and a
//   16-row tile is all mma.sync needs.
// - The rank's weight stripe streams through a ring of two stages of ks
//   rows of h (32 at cifar_head) by cp.async (16-byte copies where source
//   and destination align, else 4-byte), with the tile's feats for the same
//   h as [TB][ks + 4] (a row stride of 4 mod 8 floats: the A fragments
//   load without bank conflicts; the weight rows' stride is 8 or 24 mod 32
//   for the B fragments). One stage fills while the other is read. Each
//   warp takes n-fragments warp, warp + W, ... (NF of them, a template
//   parameter: 1, 2, 4 or 6, wider stripes in passes) and holds their
//   accumulators in registers; the fragment loop is straight-line code
//   (a fragment past the pass's end computes a copy of the last one, which
//   is discarded), so every load of a k-step issues before its products.
//   Rows past the batch's end and h past H are zeros.
// - The projections (plus bias) stay in the block's shared memory,
//   [TB][width]: nothing of [B, K+2N] is written to device memory. After
//   a cluster barrier, each rank takes TB/C of the tile's rows (one at
//   C = 16) and gathers each row's K + 2N projections from every rank's
//   shared memory through distributed shared memory (float4 reads) into
//   its own, writes its k_logits, and runs head_row.cuh's row_forward and
//   row_scalars on it, exactly as the head kernels do on staged tiles
//   (the prior is read from device memory, where it is used). The
//   gathered row and the head's state reuse the ring. The block arrives
//   on a split cluster barrier after its last gather and waits on it
//   before it exits, so every rank's shared memory lives until all its
//   peers have read it. One launch a call; no atomics.
// Tried and dropped (PERF.md): three stages of 16 rows and six of 8
// (a stage's fixed cost dominates), TMA bulk copies of each row segment
// (slower than cp.async), cvt.rna.tf32 (emulated: 8 instructions).

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

constexpr int kTileRows = 16;   // TB: rows a tile, one m16 fragment
constexpr int kMaxCluster = 16; // blocks a cluster (non-portable above 8)
constexpr int kWideWarps = 8;   // warps a block at most
constexpr int kStages = 2;      // the ring: one stage filled, one read
constexpr int kMaxFrags = 6;    // n-fragments a warp holds at most
constexpr int kStageFloats = 12288;  // a stage's target size (48 KB)

struct WideIn {
  const float* feats;  // [B, H]
  const float* wk;     // [H, K]
  const float* bk;     // [K]
  const float* wm;     // [H, N]
  const float* bm;     // [N]
  const float* wlv;    // [H, N]
  const float* blv;    // [N]
  int B, H;
};

// A launch's shape: ranks, stripes, passes and stages, and its bytes.
struct WidePlan {
  int C;      // blocks a cluster, ranks over the columns
  int warps;  // warps a block
  int width;  // columns a rank (a multiple of 8)
  int pass;   // columns a pass over H (a multiple of 8)
  int nf;     // n-fragments a warp takes in a pass: 1, 2, 4 or 6
  int ws;     // floats a weight row of a stage takes (>= pass)
  int ks;     // h rows a stage (a multiple of 8)
  size_t bytes;
};

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// floats of a stage: the tile's feats [TB][ks + 4], then the weight rows
// [ks][ws]
__host__ __device__ inline int stage_floats(int ks, int ws) {
  return kTileRows * (ks + 4) + ks * ws;
}

inline WidePlan wide_plan(int H, int K, int D, int C) {
  const int cols = K + 2 * K * D;
  const int W = block_warps(K, D, kWideWarps);
  WidePlan p;
  p.C = C;
  p.warps = W;
  p.width = round_up((cols + C - 1) / C, 8);
  p.pass = std::min(p.width, 8 * kMaxFrags * W);
  const int frags = (p.pass / 8 + W - 1) / W;
  p.nf = frags <= 1 ? 1 : frags <= 2 ? 2 : frags <= 4 ? 4 : kMaxFrags;
  // a row stride of 8 or 24 mod 32 floats: the B fragments' four k rows
  // fall in distinct banks
  p.ws = (p.pass % 32 == 0 || p.pass % 32 == 16) ? p.pass + 8 : p.pass;
  p.ks = std::max(8, std::min(round_up(H, 8),
                              kStageFloats / (p.ws + kTileRows) / 8 * 8));
  const size_t ring =
      static_cast<size_t>(kStages) * stage_floats(p.ks, p.ws);
  const size_t post = pad4(cols) + row_state_floats(K, D,
                                                    32 * W / group_lanes(D));
  p.bytes = sizeof(float) * (static_cast<size_t>(kTileRows) * p.width +
                             std::max(ring, post));
  return p;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(gmem_addr(src))
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(gmem_addr(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo to within ~2^-21 of x, both TF32 bit patterns (the low 13
// bits zero): hi is x rounded to nearest (ties away, as cvt.rna, which
// sm_90 emulates in twice the instructions), lo the rest truncated. Finite
// x well below FLT_MAX (the rounding add could carry it to infinity).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b for one m16n8k8 TF32 fragment, float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A pass's columns from one of wk, wm, wlv: src's columns [so, so + n)
// (row stride `stride`) into the stage's weight columns [dof, dof + n)
struct Segment {
  const float* src;
  int stride, so, dof, n;
};

// the virtual columns [lo, hi) of a matrix whose first column is numbered
// `base`, in a pass whose first column is v0
__device__ __forceinline__ Segment segment(const float* src, int stride,
                                           int base, int lo, int hi, int v0) {
  return Segment{src, stride, lo - base, lo - v0, hi - lo};
}

// 16-byte aligned on both sides in whole 16-byte units, or empty
__device__ __forceinline__ bool aligned(const Segment& s) {
  return s.n <= 0 || ((s.stride & 3) == 0 && (s.so & 3) == 0 &&
                      (s.dof & 3) == 0 && (s.n & 3) == 0 && aligned16(s.src));
}

// Rows [h0, h0 + hk) of a segment into a stage's weight rows (stride ws)
// by cp.async, 16 bytes a copy when aligned, else 4; rows at or past H
// are zeros.
__device__ __forceinline__ void stage_columns(float* wt, int ws,
                                              const Segment& sg, int h0,
                                              int hk, int H) {
  const int n = sg.n;
  if (n <= 0) return;
  const int T = blockDim.x;
  // element (kk, j) of the thread's copies, stepped by T without a divide
  if (aligned(sg)) {
    const int nq = n >> 2;
    const int dk = T / nq, dj = T - dk * nq;
    for (int kk = threadIdx.x / nq, j = threadIdx.x - kk * nq; kk < hk;) {
      float* dst = wt + kk * ws + sg.dof + 4 * j;
      const int h = h0 + kk;
      if (h < H)
        cp_async16(dst, sg.src + static_cast<size_t>(h) * sg.stride + sg.so +
                            4 * j);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      kk += dk;
      j += dj;
      if (j >= nq) { j -= nq; ++kk; }
    }
  } else {
    const int dk = T / n, dj = T - dk * n;
    for (int kk = threadIdx.x / n, j = threadIdx.x - kk * n; kk < hk;) {
      float* dst = wt + kk * ws + sg.dof + j;
      const int h = h0 + kk;
      if (h < H)
        cp_async4(dst, sg.src + static_cast<size_t>(h) * sg.stride + sg.so + j);
      else
        *dst = 0.f;
      kk += dk;
      j += dj;
      if (j >= n) { j -= n; ++kk; }
    }
  }
}

template <int NF>
__global__ void __launch_bounds__(32 * kWideWarps, 2)
    wide_head_fwd_kernel(const WideIn w, const HeadIn in, const WidePlan p,
                         float* __restrict__ z_out, float* __restrict__ y_out,
                         float* __restrict__ scal_out,
                         float* __restrict__ kl_out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = in.K, D = in.D, H = w.H, B = w.B;
  const int N = K * D;
  const int cols = K + 2 * N;
  const int C = p.C;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / C * kTileRows;
  const int live = min(kTileRows, B - row0);  // the tile's rows in the batch
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int W = T >> 5;
  const int warp = t >> 5;
  const int g = (t & 31) >> 2;  // the fragments' groupID
  const int q = t & 3;          // and thread in group
  const int Hp = round_up(H, 8);
  const int c0 = rank * p.width;                    // this rank's stripe
  const int nv = max(0, min(p.width, cols - c0));   // its live columns
  float* proj = smem;                               // [TB][width]
  float* ring = proj + kTileRows * p.width;
  const int fs = p.ks + 4;  // a feats row: 4 mod 8, for the A fragments
  const int sf = stage_floats(p.ks, p.ws);

  // ---- this rank's projections of the tile's rows, pass by pass ----------
  for (int pc = 0; pc < nv; pc += p.pass) {
    const int pw = min(p.pass, nv - pc);  // columns of this pass
    const int v0 = c0 + pc;               // its first virtual column
    const int nlast = (pw - 1) / 8 * 8;   // its last fragment's column
    const int n_stages = (Hp + p.ks - 1) / p.ks;
    const int hi = v0 + pw;
    const Segment segs[3] = {
        segment(w.wk, K, 0, v0, min(hi, K), v0),
        segment(w.wm, N, K, max(v0, K), min(hi, K + N), v0),
        segment(w.wlv, N, K + N, max(v0, K + N), hi, v0)};
    auto issue = [&](int s) {
      float* ft = ring + (s % kStages) * sf;  // [TB][fs] the tile's feats
      float* wt = ft + kTileRows * fs;        // [ks][ws] the weight rows
      const int h0 = s * p.ks;
      const int hk = min(p.ks, Hp - h0);
      const int hv = min(hk, H - h0);  // rows of h with data, then zeros
      const int dr = T / hk, dk = T - dr * hk;
      for (int r = t / hk, kk = t - r * hk; r < kTileRows;) {
        float* dst = ft + r * fs + kk;
        if (r < live && kk < hv)
          cp_async4(dst, w.feats + static_cast<size_t>(row0 + r) * H + h0 + kk);
        else
          *dst = 0.f;
        r += dr;
        kk += dk;
        if (kk >= hk) { kk -= hk; ++r; }
      }
      for (const Segment& sg : segs) stage_columns(wt, p.ws, sg, h0, hk, H);
    };
    // hi*hi of the stage, hi*hi of the stages before, and the cross terms
    float big[NF][4], acc[NF][4], small[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[f][e] = acc[f][e] = small[f][e] = 0.f;
    __syncthreads();  // the previous pass is done with the ring
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stages) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<kStages - 2>();  // this thread's copies of stage s
      __syncthreads();  // everyone's; and stage s - 1's buffer is free
      if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
      cp_async_commit();
      const float* ft = ring + (s % kStages) * sf;
      const float* wt = ft + kTileRows * fs;
      const int hk = min(p.ks, Hp - s * p.ks);
#pragma unroll 4
      for (int kk = 0; kk < hk; kk += 8) {
        const float* fa = ft + g * fs + kk + q;
        uint32_t ah[4], al[4];
        split_tf32(fa[0], ah[0], al[0]);                 // (g, q)
        split_tf32(fa[8 * fs], ah[1], al[1]);            // (g + 8, q)
        split_tf32(fa[4], ah[2], al[2]);                 // (g, q + 4)
        split_tf32(fa[8 * fs + 4], ah[3], al[3]);        // (g + 8, q + 4)
        // every fragment's loads, then its products: straight-line code,
        // a fragment past the pass's last one a copy of that (discarded)
        const float* wb = wt + (kk + q) * p.ws + g;
        float bv[NF][2];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int n0 = min((warp + f * W) * 8, nlast);
          bv[f][0] = wb[n0];               // (q, g)
          bv[f][1] = wb[4 * p.ws + n0];    // (q + 4, g)
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(bv[f][0], bh0, bl0);
          split_tf32(bv[f][1], bh1, bl1);
          mma_tf32(big[f], ah, bh0, bh1);
          mma_tf32(small[f], ah, bl0, bl1);
          mma_tf32(small[f], al, bh0, bh1);
        }
      }
      // the tensor cores' additions truncate: the hi*hi sum joins its
      // float32 total once a stage, rounded to nearest
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[f][e] += big[f][e];
          big[f][e] = 0.f;
        }
    }
    // the accumulators (rows g and g + 8, columns 2q and 2q + 1 of each
    // fragment) plus bias into the projections
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int n0 = (warp + f * W) * 8;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + 2 * q + e;
        if (n0 < pw && c < pw) {
          const int v = v0 + c;
          const float bias = v < K ? w.bk[v]
                             : v < K + N ? w.bm[v - K]
                                         : w.blv[v - K - N];
          proj[g * p.width + pc + c] = (acc[f][e] + small[f][e]) + bias;
          proj[(g + 8) * p.width + pc + c] =
              (acc[f][2 + e] + small[f][2 + e]) + bias;
        }
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // every rank's projections are in its shared memory

  // ---- each of this rank's rows: gather its projections, run the head ----
  float* grow = ring;  // [K + 2N] the row's projections (the ring is free)
  const RowState<float> st = row_state(grow + pad4(cols), K, D, T / in.L);
  const int rows = kTileRows / C;
  const int quads = p.width >> 2;
  for (int i = 0; i < rows; ++i) {
    const int lr = rank * rows + i;  // the row in the tile
    const int row = row0 + lr;
    if (row < B) {
      for (int j = t; j < C * quads; j += T) {
        const int r = j / quads, x = 4 * (j - r * quads);
        const int n = min(p.width, cols - r * p.width);  // rank r's columns
        if (x >= n) continue;
        const float* src =
            cluster.map_shared_rank(proj, r) + lr * p.width + x;
        float* dst = grow + r * p.width + x;
        if (x + 4 <= n) {
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
        } else {
          for (int e = 0; e < n - x; ++e) dst[e] = src[e];
        }
      }
    }
    if (i == rows - 1) cluster_arrive();  // done reading the peers
    __syncthreads();
    if (row < B) {
      store_row(kl_out + static_cast<size_t>(row) * K, grow, K);
      const RowIn ri{grow, grow + K, grow + K + N, in.p_means, in.p_logvars};
      row_forward(in, ri, st, row, Staging{nullptr, kStageNone}, y_out,
                  z_out);
      row_scalars(in, st, row, scal_out);
    }
    __syncthreads();  // row_scalars' reads of st before the next row
  }
  cluster_wait();  // the peers are done reading this block's projections
}

using WideKernel = void (*)(WideIn, HeadIn, WidePlan, float*, float*, float*,
                           float*);

// the kernel compiled for a plan's fragments a warp
WideKernel wide_kernel(const WidePlan& p) {
  switch (p.nf) {
    case 1: return wide_head_fwd_kernel<1>;
    case 2: return wide_head_fwd_kernel<2>;
    case 4: return wide_head_fwd_kernel<4>;
    default: return wide_head_fwd_kernel<kMaxFrags>;
  }
}

// a launch of ceil(B / 16) clusters of p.C blocks (`attr` holds the
// cluster's shape)
cudaLaunchConfig_t wide_config(const WidePlan& p, int B,
                               cudaLaunchAttribute* attr,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + kTileRows - 1) / kTileRows * p.C);
  cfg.blockDim = dim3(32 * p.warps);
  cfg.dynamicSmemBytes = p.bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The launch at (B, H, K, D): the largest C whose plan fits a block's
// shared memory and whose ceil(B / 16) clusters are all resident at once,
// else the largest that fits. Cached by device and shape. Returns
// cudaErrorInvalidValue, with the C = 16 plan in *out, when none fits.
cudaError_t wide_launch(int B, int H, int K, int D, WidePlan* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int>, WidePlan> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, B, H, K, D);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  const int tiles = (B + kTileRows - 1) / kTileRows;
  bool found = false;
  WidePlan best = wide_plan(H, K, D, kMaxCluster);
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    const WidePlan p = wide_plan(H, K, D, c);
    if (p.bytes > kMaxSmem) continue;
    const WideKernel kernel = wide_kernel(p);
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) e = allow_smem(kernel, p.bytes);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = wide_config(p, B, &attr, nullptr);
    int resident = 0;
    e = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (!found || resident >= tiles) best = p;
    found = true;
    if (resident >= tiles) break;
  }
  *out = best;
  if (!found) return cudaErrorInvalidValue;
  e = allow_smem(wide_kernel(best), best.bytes);
  if (e != cudaSuccess) return e;
  cache[key] = best;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory a block of the call's launch takes, in bytes (the wrapper
// checks it against the card's limit before it launches: when no cluster
// size fits, the least any takes); 0 if the launch cannot be planned (the
// launch then reports the error).
size_t gmvae_wide_head_smem(int B, int H, int K, int D) {
  WidePlan p;
  const cudaError_t e = wide_launch(B, H, K, D, &p);
  return (e == cudaSuccess || e == cudaErrorInvalidValue) ? p.bytes : 0;
}

// Blocks a cluster of the call's launch (0 if it cannot be planned).
int gmvae_wide_head_cluster(int B, int H, int K, int D) {
  WidePlan p;
  return wide_launch(B, H, K, D, &p) == cudaSuccess ? p.C : 0;
}

// Soft y and in-kernel threefry noise from the key only; `key` (two words)
// and `tau` are device pointers, read by the kernel. One launch on
// `stream`. Returns the launch's CUDA error (0 on success).
int gmvae_wide_head_fwd(const float* feats, const float* wk, const float* bk,
                        const float* wm, const float* bm, const float* wlv,
                        const float* blv, const float* pi_logits,
                        const float* p_means, const float* p_logvars,
                        float* z, float* y, float* scal, float* k_logits,
                        int B, int H, int K, int D, const unsigned int* key,
                        const float* tau, void* stream) {
  WidePlan p;
  cudaError_t e = wide_launch(B, H, K, D, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const WideIn w{feats, wk, bk, wm, bm, wlv, blv, B, H};
  const HeadIn in{nullptr, nullptr, nullptr,     pi_logits, p_means,
                  p_logvars, nullptr, nullptr,   K,         D,
                  group_lanes(D), key, tau,      0};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wide_config(p, B, &attr, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&cfg, wide_kernel(p), w, in, p, z, y, scal,
                         k_logits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
