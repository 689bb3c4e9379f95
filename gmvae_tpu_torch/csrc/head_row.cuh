// The mixture-ELBO head's per-row forward, shared by the forward kernel
// (fused_elbo_fwd.cu), the backward kernel (fused_elbo_bwd.cu) and the wide
// kernel (wide_head_fwd.cu).
//
// One block per batch row, T = 32W threads (4 <= W <= 20: plan_launch). The block's
// threads form G = T / L groups of L lanes, L the smallest power of two >= D
// (at most 32): lane l of group g takes the (k, d) pairs with k = g (mod G)
// and d = l (mod L). Sums over k go through per-group partials in shared
// memory, added in group order; sums over d inside a group are butterfly
// shuffles within its L lanes (groups never straddle a warp). Every sum has
// a fixed order: no atomics.
//
// Staging. The head kernels copy the row's q_means and q_logvars tiles and
// the prior's means and logvars [K*D each] into shared memory once, as the
// block starts (stage_row): one TMA bulk copy a tile (cp.async.bulk, thread
// 0, completing on an mbarrier) when K*D % 4 == 0 and every source is
// 16-byte aligned, else 4-byte cp.async by every thread. While the copies
// fly, the threads draw the threefry noise and load k_logits and pi_logits;
// they wait for the tiles only before the mixing step. Every later pass
// reads shared memory, so each input byte crosses from L2 or device memory
// once per block. plan_smem is the budget rule both launchers share: all
// four tiles when they fit in the 227 KB a block may take; else the q tiles
// only, and the prior is read from device memory where it is used. The
// prior's y-mixing is folded into the component-density pass, so the
// forward touches the prior in one pass and the backward in two: at most
// two reads of any input at (128,64,256), where the four tiles take 256 KB.
//
// Steps of row_forward, each ending on a barrier:
//   noise: Gumbel g [K] and normal eps [D] over one loop of K + D counters;
//     k_logits and pi_logits into shared memory;
//   the K-vector steps side by side: the Gumbel softmax and hard argmax on
//     warp 0, log-softmax(k_logits) on warp 1, log-softmax(pi) on warp 2;
//   the q y-mixing partials (and KL(q(k|x) || pi) on the last warp);
//   the mixed mean, logvar and z (in Acc);
//   the K component log-densities under q and the prior (each term and its
//     sum over D in Acc), and the prior's y-mixing partials (float).
// row_scalars then computes the row's packed scalars on four warps at once
// (the two conditionals and the two LSEs). The row index numbers the noise
// counters and the output rows.
//
// row_forward<Acc> carries the mixed mean and logvar, z and the component
// log-densities in Acc: float in the forward kernels, double in the
// backward, whose VJP takes the LSE weights and z - mean from them (float32
// rounding of the recomputation carried into the cancellation dy - sum_k y
// dy was most of its d_k_logits error at D >= 64; PERF.md §6). The double
// arrays take the float arrays' room twice over (RowState<double>); the q
// partials, as doubles, fill the four G*D partial blocks before the prior's
// partials reuse the upper two.
//
// The forward and backward kernels inline this one function, compiled with
// the same flags. y's arithmetic (threefry words, -log(-log u), an add, a
// divide by tau, exp, a fixed-order sum, a divide) holds no multiply
// feeding an add, so no contraction can round it differently in the two
// kernels: the backward's y (and in hard mode its argmax, the first index
// among equals) is the forward's, bit for bit.
//
// Tensor cores do not apply. The work is float32 elementwise work and
// reductions over each row's own [K, D]. The one product that rows share,
// the prior densities sum_d (z_d - m_kd)^2 e^{-lv_kd} across the batch,
// becomes a GEMM only by expanding the square, which cancels
// catastrophically and breaks the 1e-4 tolerances.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "threefry.cuh"

namespace gmvae {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kLogvarMin = -12.0f;
constexpr float kLogvarMax = 12.0f;
constexpr int kMinWarps = 4;   // the four warp roles of row_scalars
constexpr int kMaxWarps = 20;  // the forward's __launch_bounds__
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may take (H100)
// the staging mbarrier, padded so that the tiles after it are 16-byte aligned
constexpr size_t kHeaderBytes = 16;

// lanes per component group: the smallest power of two >= D, at most 32
inline int group_lanes(int D) {
  int l = 1;
  while (l < D && l < 32) l <<= 1;
  return l;
}

// warps per block: enough for one pass over K when possible, kMinWarps to
// max_warps
inline int block_warps(int K, int D, int max_warps) {
  const int per_warp = 32 / group_lanes(D);
  return std::min(max_warps,
                  std::max(kMinWarps, (K + per_warp - 1) / per_warp));
}

// opt a kernel into `smem` bytes of dynamic shared memory when it needs
// more than the default 48 KB; above the 227 KB limit the call fails. The
// limit is the kernel's, not a shape's: it is only ever raised, so a shape
// planned earlier (and cached by its launcher) still launches after a
// later shape that needs less
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (static_cast<size_t>(attr.maxDynamicSharedSizeBytes) >= smem)
    return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// What a head kernel keeps in shared memory: which input tiles it stages,
// the components per chunk of the backward's prior-gradient partial, and
// the bytes. `fixed` is the kernel's per-row state in floats; `bwd` adds
// the partial's pad4(K) + 2*kc*D floats, kc = K or a multiple of G.
struct SmemPlan {
  int stage_q;   // the row's q_means and q_logvars tiles
  int stage_p;   // the prior's means and logvars
  int kc;
  size_t bytes;
};

inline SmemPlan plan_smem(int K, int D, int G, size_t fixed, bool bwd) {
  const size_t kd = static_cast<size_t>(K) * D;
  const int modes[3][2] = {{1, 1}, {1, 0}, {0, 0}};
  for (const auto& m : modes) {
    const size_t floats = fixed + 2 * kd * (m[0] + m[1]) + (bwd ? pad4(K) : 0);
    int kc = K;
    while (kc > 0) {
      const size_t bytes =
          kHeaderBytes +
          4 * (floats + (bwd ? 2 * static_cast<size_t>(kc) * D : 0));
      if (bytes <= kMaxSmem) return SmemPlan{m[0], m[1], kc, bytes};
      if (!bwd) break;
      kc = (kc == K) ? (K - 1) / G * G : kc - G;
    }
  }
  return SmemPlan{0, 0, K, kMaxSmem + 1};  // too large: the launch fails
}

template <typename Acc = float>
inline size_t row_state_floats(int K, int D, int G);

// A head kernel's block: the most warps up to max_warps (block_warps)
// whose per-group state still leaves room to stage the q tiles, and its
// shared-memory plan. `extra` is the kernel's own per-row floats; the
// backward's row state is RowState<double>'s.
struct LaunchPlan {
  int warps;
  SmemPlan smem;
};

inline LaunchPlan plan_launch(int K, int D, size_t extra, bool bwd,
                              int max_warps) {
  const int L = group_lanes(D);
  for (int w = block_warps(K, D, max_warps);; --w) {
    const int G = 32 * w / L;
    const size_t state = bwd ? row_state_floats<double>(K, D, G)
                             : row_state_floats<float>(K, D, G);
    const SmemPlan p = plan_smem(K, D, G, state + extra, bwd);
    if (p.stage_q || w == kMinWarps) return LaunchPlan{w, p};
  }
}

// warp and group reductions, of float or of double values
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;  // identical in every lane: float addition commutes
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the sum of v over each group of L lanes, in every lane of the group
__device__ __forceinline__ float group_sum(float v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double group_sum(double v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float acc_exp(float x) { return expf(x); }
__device__ __forceinline__ double acc_exp(double x) { return exp(x); }

// log(2 pi) in the accumulation type
template <typename Acc>
__device__ __forceinline__ Acc log_2pi();
template <>
__device__ __forceinline__ float log_2pi<float>() { return kLog2Pi; }
template <>
__device__ __forceinline__ double log_2pi<double>() {
  return 1.8378770664093453;
}

__device__ __forceinline__ float clamp_logvar(float v) {
  return fminf(fmaxf(v, kLogvarMin), kLogvarMax);
}

// 1 inside the inclusive clamp band, where a clamped logvar passes gradient
__device__ __forceinline__ float band_mask(float v) {
  return (v >= kLogvarMin && v <= kLogvarMax) ? 1.f : 0.f;
}

// log-sum-exp over a K-vector plus an optional per-k offset, on one warp;
// every lane returns the same value
__device__ __forceinline__ float warp_lse(const float* a, const float* add,
                                          int k, int lane) {
  float m = -INFINITY;
  for (int i = lane; i < k; i += 32) m = fmaxf(m, a[i] + (add ? add[i] : 0.f));
  m = warp_max(m);
  float s = 0.f;
  for (int i = lane; i < k; i += 32) s += expf(a[i] + (add ? add[i] : 0.f) - m);
  return m + logf(warp_sum(s));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[0:n) = src[0:n) (src in shared memory) by the whole block: float4
// stores where both are 16-byte aligned and n % 4 == 0, else coalesced
// 4-byte stores
__device__ __forceinline__ void store_row(float* dst, const float* src,
                                          int n) {
  if ((n & 3) == 0 && aligned16(dst) && aligned16(src)) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// a thread-block cluster's barrier in two halves (release on arrive,
// acquire on wait), so work can run between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t gmem_addr(const void* p) {
  return reinterpret_cast<uint64_t>(p);
}

// ---- staging: asynchronous copies of the row's tiles ----------------------

enum StageMode { kStageNone = 0, kStageBulk = 1, kStageAsync = 2 };

struct Staging {
  uint64_t* bar;  // the bulk copies' mbarrier
  int mode;
};

// Issue copies of N tiles of `count` floats each, src[i] -> dst[i]: TMA bulk
// copies by thread 0 onto `bar` when count % 4 == 0 and every source is
// 16-byte aligned (the destinations are), else 4-byte cp.async by every
// thread. Every thread calls it; a barrier must separate it from
// wait_tiles.
template <int N>
__device__ __forceinline__ Staging stage_tiles(float* const (&dst)[N],
                                               const float* const (&src)[N],
                                               int count, uint64_t* bar) {
  bool bulk = (count & 3) == 0;
#pragma unroll
  for (int i = 0; i < N; ++i) bulk = bulk && aligned16(src[i]);
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint32_t b = smem_addr(bar);
      const uint32_t bytes = static_cast<uint32_t>(count) * 4u;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(bytes * N)
          : "memory");
#pragma unroll
      for (int i = 0; i < N; ++i)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst[i])),
            "l"(gmem_addr(src[i])), "r"(bytes), "r"(b)
            : "memory");
    }
    return Staging{bar, kStageBulk};
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int j = threadIdx.x; j < count; j += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst[i] + j)),
                   "l"(gmem_addr(src[i] + j))
                   : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return Staging{bar, kStageAsync};
}

// wait until this thread sees the staged tiles (a barrier must follow for
// the cp.async path, whose copies each thread waits for alone)
__device__ __forceinline__ void wait_tiles(const Staging& s) {
  if (s.mode == kStageAsync) asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (s.mode == kStageBulk) {
    const uint32_t b = smem_addr(s.bar);
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b)
          : "memory");
  }
}

// ---- the row's inputs and state ------------------------------------------

// the head's inputs for the whole batch
struct HeadIn {
  const float* k_logits;   // [B, K]
  const float* q_means;    // [B, K, D]
  const float* q_logvars;  // [B, K, D]
  const float* pi_logits;  // [K]
  const float* p_means;    // [K, D]
  const float* p_logvars;  // [K, D]
  const float* g_in;       // [B, K] streamed Gumbel noise, or null
  const float* eps_in;     // [B, D] streamed normal noise, or null
  int K, D, L;
  // the threefry key's two words (used when the noise is not streamed) and
  // tau, in device memory: a launch captured in a CUDA graph reads each
  // replay's values. Read where they are used, so no register holds them
  // past that
  const uint32_t* key;
  const float* tau;
  int hard;
};

// one row's posterior-head outputs and the prior, in device or shared
// memory
struct RowIn {
  const float* logits;  // [K]
  const float* qm;      // [K, D]
  const float* qlv;     // [K, D]
  const float* pm;      // [K, D]
  const float* plv;     // [K, D]
};

// row `row` of the head's inputs in device memory
static __device__ __forceinline__ RowIn row_in(const HeadIn& in, int row) {
  const size_t kd = static_cast<size_t>(in.K) * in.D;
  return RowIn{in.k_logits + static_cast<size_t>(row) * in.K,
               in.q_means + static_cast<size_t>(row) * kd,
               in.q_logvars + static_cast<size_t>(row) * kd, in.p_means,
               in.p_logvars};
}

// The plan's tiles at `tiles` (q_means, q_logvars if stage_q, then the
// prior's means, logvars if stage_p): issue their copies and point `r` at
// them. Returns what wait_tiles waits for.
static __device__ __forceinline__ Staging stage_row(float* tiles, int kd,
                                                    int stage_q, int stage_p,
                                                    RowIn& r, uint64_t* bar) {
  Staging s{bar, kStageNone};
  if (stage_q && stage_p) {
    float* const dst[4] = {tiles, tiles + kd, tiles + 2 * kd, tiles + 3 * kd};
    const float* const src[4] = {r.qm, r.qlv, r.pm, r.plv};
    s = stage_tiles<4>(dst, src, kd, bar);
    r.pm = dst[2];
    r.plv = dst[3];
  } else if (stage_q) {
    float* const dst[2] = {tiles, tiles + kd};
    const float* const src[2] = {r.qm, r.qlv};
    s = stage_tiles<2>(dst, src, kd, bar);
  }
  if (stage_q) {
    r.qm = tiles;
    r.qlv = tiles + kd;
  }
  return s;
}

// The row's forward state in shared memory. Acc is the type of the
// recomputation's mixture, z and component log-densities: float in the
// forward kernels, double in the backward (see row_forward).
template <typename Acc>
struct RowState {
  float* ys;     // [K] y: the softmax, or its one-hot in hard mode
  float* ysoft;  // [K] the softmax
  float* lq;     // [K] k_logits, then log q(k|x)
  float* lp;     // [K] pi_logits, then log pi
  Acc* cq;       // [K] log N(z; q_k)
  Acc* cp;       // [K] log pi_k + log N(z; prior_k)
  float* es;     // [D] eps
  Acc* zs;       // [D] z
  Acc* mix;      // [2][D] y-mixed: mean, logvar (4D floats of room)
  float* part;   // [4][G][D] floats of per-group partials: the q mixing
                 // (as Acc, [2][G][D]), then the prior mixing (floats at
                 // part[2GD:4GD], over the dead q partials)
  float* red;    // [8] row scalars: red[0] the KL
};

// floats of shared memory RowState<Acc> takes
template <typename Acc>
inline size_t row_state_floats(int K, int D, int G) {
  constexpr size_t a = sizeof(Acc) / sizeof(float);
  return (4 + 2 * a) * static_cast<size_t>(K) +
         (5 + a) * static_cast<size_t>(D) + 4 * static_cast<size_t>(G) * D +
         8;
}

// RowState<float> keeps the forward kernels' layout; RowState<double>
// puts its double arrays first (`smem` 8-byte aligned)
template <typename Acc = float>
static __device__ __forceinline__ RowState<Acc> row_state(float* smem, int K,
                                                          int D, int G) {
  RowState<Acc> s;
  if constexpr (sizeof(Acc) == sizeof(float)) {
    s.ys = smem;
    s.ysoft = s.ys + K;
    s.lq = s.ysoft + K;
    s.lp = s.lq + K;
    s.cq = s.lp + K;
    s.cp = s.cq + K;
    s.es = s.cp + K;
    s.zs = s.es + D;
    s.mix = s.zs + D;
    s.part = s.mix + 4 * D;
    s.red = s.part + 4 * static_cast<size_t>(G) * D;
  } else {
    s.cq = reinterpret_cast<Acc*>(smem);
    s.cp = s.cq + K;
    s.zs = s.cp + K;
    s.mix = s.zs + D;
    s.part = reinterpret_cast<float*>(s.mix + 2 * D);
    s.ys = s.part + 4 * static_cast<size_t>(G) * D;
    s.ysoft = s.ys + K;
    s.lq = s.ysoft + K;
    s.lp = s.lq + K;
    s.es = s.lp + K;
    s.red = s.es + D;
  }
  return s;
}

// a[k] -= LSE(a) on one warp (each lane rewrites only the entries it read)
__device__ __forceinline__ void warp_log_softmax(float* a, int K, int lane) {
  const float lse = warp_lse(a, nullptr, K, lane);
  for (int k = lane; k < K; k += 32) a[k] -= lse;
}

// The Gumbel softmax into ys and ysoft, then the one-hot of its argmax in
// ys when hard, on one warp. Its operations and their order are y's
// contract with the backward (see the file comment).
template <typename Acc>
__device__ __forceinline__ void warp_gumbel_softmax(RowState<Acc> st, int K,
                                                    int hard, int lane) {
  float m = -INFINITY;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, st.ys[k]);
  m = warp_max(m);
  float s = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float e = expf(st.ys[k] - m);
    st.ys[k] = e;
    s += e;
  }
  s = warp_sum(s);
  float best = -INFINITY;
  int best_k = K;
  for (int k = lane; k < K; k += 32) {
    const float y = st.ys[k] / s;
    st.ys[k] = y;
    st.ysoft[k] = y;
    if (y > best) { best = y; best_k = k; }  // first index among equals
  }
  if (hard) {
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int ok = __shfl_xor_sync(kFull, best_k, o);
      if (ob > best || (ob == best && ok < best_k)) { best = ob; best_k = ok; }
    }
    for (int k = lane; k < K; k += 32) st.ys[k] = (k == best_k) ? 1.f : 0.f;
  }
}

// The row's forward recomputation (see the file comment) from its inputs
// `r`; `row` numbers its noise counters and output rows; `staged` the
// copies to wait for before the mixing step. Every thread of the block
// calls it; it ends on a barrier with the KL in st.red[0], and the prior's
// y-mixing as per-group partials in st.part[2G*D:4G*D). y_out / z_out,
// when not null, receive the row's y and z (Acc = float only).
//
// Acc = double (the backward): the q y-mixing, the mixed mean and logvar,
// z and the K component log-densities (each term and its sum over D) are
// carried in double from the float32 inputs, noise and y, so the LSE
// weights the VJP takes from them, and its z - mean, carry no float32
// rounding of the recomputation; y and the prior's y-mixing stay float32,
// the forward's bits.
template <typename Acc>
static __device__ __forceinline__ void row_forward(const HeadIn& in,
                                                   const RowIn& r,
                                                   RowState<Acc> st, int row,
                                                   const Staging& staged,
                                                   float* y_out,
                                                   float* z_out) {
  const int K = in.K, D = in.D, L = in.L;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int W = T >> 5;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int G = T / L;
  const int g = t / L;
  const int l = t % L;
  const size_t gd = static_cast<size_t>(G) * D;
  Acc* __restrict__ qmix = reinterpret_cast<Acc*>(st.part);  // [2][G][D]

  // ---- noise; the K-vectors' inputs ----------------------------------------
  const uint32_t k0 = in.key[0], k1 = in.key[1];
  const float tau = *in.tau;
  for (int i = t; i < K + D; i += T) {
    if (i < K) {
      const float lg = r.logits[i];
      const float gk = in.g_in ? in.g_in[static_cast<size_t>(row) * K + i]
                               : gumbel_at(k0, k1, row, i);
      st.ys[i] = (lg + gk) / tau;
      st.lq[i] = lg;
      st.lp[i] = in.pi_logits[i];
    } else {
      const int d = i - K;
      st.es[d] = in.eps_in ? in.eps_in[static_cast<size_t>(row) * D + d]
                           : normal_at(k0, k1, row, d);
    }
  }
  __syncthreads();

  // ---- the K-vector steps, one warp each -----------------------------------
  if (warp == 0) warp_gumbel_softmax(st, K, in.hard, lane);
  if (warp == 1) warp_log_softmax(st.lq, K, lane);
  if (warp == 2) warp_log_softmax(st.lp, K, lane);
  wait_tiles(staged);
  __syncthreads();

  // ---- y out; q y-mixing: per-group partial sums over k; the KL ------------
  if (y_out) store_row(y_out + static_cast<size_t>(row) * K, st.ys, K);
  for (int d = l; d < D; d += L) {
    Acc mean = 0, logvar = 0;
#pragma unroll 4
    for (int k = g; k < K; k += G) {
      const Acc y = st.ys[k];
      const size_t i = static_cast<size_t>(k) * D + d;
      mean += y * static_cast<Acc>(r.qm[i]);
      logvar += y * static_cast<Acc>(clamp_logvar(r.qlv[i]));
    }
    const size_t i = static_cast<size_t>(g) * D + d;
    qmix[i] = mean;
    qmix[gd + i] = logvar;
  }
  if (warp == W - 1) {
    float kl = 0.f;
    for (int k = lane; k < K; k += 32)
      kl += expf(st.lq[k]) * (st.lq[k] - st.lp[k]);
    kl = warp_sum(kl);
    if (lane == 0) st.red[0] = kl;
  }
  __syncthreads();

  // ---- the mixed parameters and the reparameterized z ---------------------
  for (int d = t; d < D; d += T) {
    Acc mean = 0, logvar = 0;
#pragma unroll 8
    for (int j = 0; j < G; ++j) {
      const size_t i = static_cast<size_t>(j) * D + d;
      mean += qmix[i];
      logvar += qmix[gd + i];
    }
    const Acc z =
        mean + acc_exp(static_cast<Acc>(0.5) * logvar) * static_cast<Acc>(st.es[d]);
    st.zs[d] = z;
    st.mix[d] = mean;
    st.mix[D + d] = logvar;
  }
  __syncthreads();

  // ---- z out; the K component log-densities; the prior's y-mixing ----------
  // the q partials are dead: each thread zeroes the prior partials it adds
  // to. The loop counts are the same for every thread, so the shuffles of a
  // warp always see all its lanes
  if constexpr (sizeof(Acc) == sizeof(float)) {
    if (z_out) store_row(z_out + static_cast<size_t>(row) * D, st.zs, D);
  }
  float* __restrict__ pmix = st.part + 2 * gd + static_cast<size_t>(g) * D;
  float* __restrict__ plmix = pmix + gd;
  for (int d = l; d < D; d += L) {
    pmix[d] = 0.f;
    plmix[d] = 0.f;
  }
  for (int kb = 0; kb < K; kb += G) {
    const int k = kb + g;
    Acc aq = 0, ap = 0;
    if (k < K) {
      const float y = st.ys[k];
      for (int d = l; d < D; d += L) {
        const size_t i = static_cast<size_t>(k) * D + d;
        const Acc z = st.zs[d];
        const Acc lv = clamp_logvar(r.qlv[i]);
        const float plv = clamp_logvar(r.plv[i]);
        const float pm = r.pm[i];
        const Acc dq = z - static_cast<Acc>(r.qm[i]);
        const Acc dp = z - static_cast<Acc>(pm);
        const Acc lvp = plv;
        aq += dq * dq * acc_exp(-lv) + lv + log_2pi<Acc>();
        ap += dp * dp * acc_exp(-lvp) + lvp + log_2pi<Acc>();
        pmix[d] += y * pm;
        plmix[d] += y * plv;
      }
    }
    aq = group_sum(aq, L);
    ap = group_sum(ap, L);
    if (l == 0 && k < K) {
      st.cq[k] = static_cast<Acc>(-0.5) * aq;
      st.cp[k] = static_cast<Acc>(-0.5) * ap + static_cast<Acc>(st.lp[k]);
    }
  }
  __syncthreads();
}

// the prior's y-mixed mean and logvar at d, from row_forward's per-group
// partials (summed in group order)
template <typename Acc>
static __device__ __forceinline__ void prior_mix(const RowState<Acc>& st,
                                                 int D, int G, int d,
                                                 float& pmean,
                                                 float& plogvar) {
  const size_t gd = static_cast<size_t>(G) * D;
  pmean = 0.f;
  plogvar = 0.f;
#pragma unroll 8
  for (int j = 0; j < G; ++j) {
    const size_t i = 2 * gd + static_cast<size_t>(j) * D + d;
    pmean += st.part[i];
    plogvar += st.part[gd + i];
  }
}

// The row's packed scalars after row_forward, four warps at once:
// scal_out[row] = (log_prior_mix, log_q_mix, log_p_cond, log_q_cond,
// kl_cat, 0, 0, 0). Warp 0 the y-interpolated log q(z|x,y), warp 1 the
// prior's mixing and log p(z|y), warps 2 and 3 the two LSEs over K.
static __device__ __forceinline__ void row_scalars(const HeadIn& in,
                                                   const RowState<float>& st,
                                                   int row,
                                                   float* scal_out) {
  const int K = in.K, D = in.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* out = scal_out + static_cast<size_t>(row) * 8;
  if (warp == 0) {
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float lv = clamp_logvar(st.mix[D + d]);
      const float dq = st.zs[d] - st.mix[d];
      sq += dq * dq * expf(-lv) + lv + kLog2Pi;
    }
    sq = warp_sum(sq);
    if (lane == 0) out[3] = -0.5f * sq;
  } else if (warp == 1) {
    const int G = blockDim.x / in.L;
    float sp = 0.f;
    for (int d = lane; d < D; d += 32) {
      float pmean, plogvar;
      prior_mix(st, D, G, d, pmean, plogvar);
      const float plv = clamp_logvar(plogvar);
      const float dp = st.zs[d] - pmean;
      sp += dp * dp * expf(-plv) + plv + kLog2Pi;
    }
    sp = warp_sum(sp);
    if (lane == 0) out[2] = -0.5f * sp;
  } else if (warp == 2) {
    const float v = warp_lse(st.cp, nullptr, K, lane);
    if (lane == 0) out[0] = v;
  } else if (warp == 3) {
    const float v = warp_lse(st.lq, st.cq, K, lane);
    if (lane == 0) {
      out[1] = v;
      out[4] = st.red[0];
      out[5] = 0.f;
      out[6] = 0.f;
      out[7] = 0.f;
    }
  }
}

}  // namespace gmvae
