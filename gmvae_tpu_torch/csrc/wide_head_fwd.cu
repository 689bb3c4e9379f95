// Wide-boundary mixture-ELBO head forward for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_head_boundary.py:_wide_kernel: the
// three posterior-head matmuls fused into the head forward, so the
// boundary tensors k_logits [B,K], q_means and q_logvars [B,K*D] never
// cross device memory on the forward. Per batch row:
//
//   k_logits = feats @ wk + bk,  q_means = feats @ wm + bm,
//   q_logvars = feats @ wlv + blv          (float32 FMA, not tensor cores)
//   then the head of fused_elbo_fwd.cu on them: soft y, threefry noise
//   (the narrow kernel's counters: rows 0..B-1 of the call)
//
// Inputs: feats [B,H], wk [H,K], bk [K], wm/wlv [H,N], bm/blv [N] (N = K*D),
// pi_logits [K], prior means/logvars [N]. Outputs: z [B,D], y [B,K],
// scal [B,8] (fused_elbo_fwd.cu's packing) and k_logits [B,K], all float32.
//
// What bounds it on an H100: operations. The function reads the weights
// once, H*(K+2N)*4 bytes (0.43 MB at H=512, K=10, D=10; 10.5 MB at K=20,
// D=128), and does 2*B*H*(K+2N) float32 operations for the projections
// (27.5 and 674 MFLOP at B=128): ~0.41 and ~10 us at 67 TFLOP/s against
// ~0.2 and ~3.2 us for its bytes at 3.35 TB/s.
//
// Design (simple first; wgmma and TMA are later work). A block takes a
// tile of TB = 4 rows: it stages their feats in shared memory (TB*H*4 B),
// and its threads stride over the K+2N projection columns, each column's
// weights read once per block (consecutive threads, consecutive columns:
// coalesced) and used for the TB rows from registers, with the feats read
// as shared-memory float4 broadcasts (four h a load). Each sum runs over h
// in order. With only B/TB blocks on the card, the projections wait on
// L2's latency, so the loads in flight set their rate: a thread issues 16
// weight loads before their FMAs (PERF.md PR 3 has the times of a first
// version that issued 4). The projections stay in shared memory ((K+2N)*4
// B a row: 0.8 KB and 20.6 KB at the two shapes); k_logits is also written
// out. Then the block runs head_row.cuh's row_forward and row_scalars on
// each of its rows in turn, reading the projections from shared memory
// (nothing to stage) and the prior from device memory.
// The cost of the simple design: every block re-reads the whole weight
// matrix, so the B/TB = 32 blocks of a B=128 call read 32 times 10.5 MB
// at K=20, D=128 (from L2, which holds 50 MB), and 32 blocks leave most of
// the card's 132 SMs idle. Splitting the columns of a row tile over a
// cluster of blocks (distributed shared memory) would read the weights
// once per tile and fill the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_row.cuh"

namespace {

using namespace gmvae;

constexpr int kTileRows = 4;  // TB: rows a block computes
constexpr int kUnroll = 16;   // weight loads a thread issues at once
constexpr int kWideWarps = 8;  // warps per block at most

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

__global__ void wide_head_fwd_kernel(const WideIn w, const HeadIn in,
                                     float* __restrict__ z_out,
                                     float* __restrict__ y_out,
                                     float* __restrict__ scal_out,
                                     float* __restrict__ kl_out) {
  extern __shared__ float smem[];
  const int K = in.K, D = in.D, H = w.H, B = w.B;
  const int N = K * D;
  const int cols = K + 2 * N;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int row0 = blockIdx.x * kTileRows;
  const bool vec4 = (H & 3) == 0;  // feats rows 16-byte aligned
  float* fs = smem;                    // [TB, H] the tile's feats
  float* proj = fs + kTileRows * H;    // [TB, K + 2N] its projections
  const RowState st = row_state(proj + static_cast<size_t>(kTileRows) * cols,
                                K, D, T / in.L);

  // ---- the tile's feats, zero past the batch's end ------------------------
  for (int i = t; i < kTileRows * H; i += T) {
    const int r = row0 + i / H;
    fs[i] = r < B ? w.feats[static_cast<size_t>(r) * H + i % H] : 0.f;
  }
  __syncthreads();

  // ---- the K + 2N projections of each row, float32 FMA in h order ---------
  for (int j = t; j < cols; j += T) {
    const float* wc = w.wk + j;  // column j of [wk | wm | wlv], stride K or N
    int stride = K;
    float bias;
    if (j < K) {
      bias = w.bk[j];
    } else if (j < K + N) {
      wc = w.wm + (j - K);
      stride = N;
      bias = w.bm[j - K];
    } else {
      wc = w.wlv + (j - K - N);
      stride = N;
      bias = w.blv[j - K - N];
    }
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
    // kUnroll weight loads in flight before their FMAs: the loop is bound
    // by L2's latency, not its bandwidth, so loads in flight set its rate
    int h = 0;
    for (; h + kUnroll <= H; h += kUnroll) {
      float wv[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        wv[q] = wc[static_cast<size_t>(h + q) * stride];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float* f = fs + r * H + h;
        if (vec4) {  // feats as float4 broadcasts: four h a load
#pragma unroll
          for (int q = 0; q < kUnroll; q += 4) {
            const float4 v = *reinterpret_cast<const float4*>(f + q);
            acc[r] = fmaf(v.x, wv[q], acc[r]);
            acc[r] = fmaf(v.y, wv[q + 1], acc[r]);
            acc[r] = fmaf(v.z, wv[q + 2], acc[r]);
            acc[r] = fmaf(v.w, wv[q + 3], acc[r]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) acc[r] = fmaf(f[q], wv[q], acc[r]);
        }
      }
    }
    for (; h < H; ++h) {
      const float wv = wc[static_cast<size_t>(h) * stride];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        acc[r] = fmaf(fs[r * H + h], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const float v = acc[r] + bias;
      proj[static_cast<size_t>(r) * cols + j] = v;
      if (j < K && row0 + r < B)
        kl_out[static_cast<size_t>(row0 + r) * K + j] = v;
    }
  }
  __syncthreads();

  // ---- the head on each row, from the projections in shared memory --------
  for (int r = 0; r < kTileRows && row0 + r < B; ++r) {
    const float* p = proj + static_cast<size_t>(r) * cols;
    const RowIn ri{p, p + K, p + K + N, in.p_means, in.p_logvars};
    row_forward(in, ri, st, row0 + r, Staging{nullptr, kStageNone}, y_out,
                z_out);
    row_scalars(in, st, row0 + r, scal_out);
    __syncthreads();  // row_scalars' reads of st before the next row writes it
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel takes for a call, in bytes (the wrapper checks
// it against the card's limit before it launches).
size_t gmvae_wide_head_smem(int H, int K, int D) {
  const int L = group_lanes(D);
  const int G = 32 * block_warps(K, D, kWideWarps) / L;
  const size_t cols = static_cast<size_t>(K) + 2 * static_cast<size_t>(K) * D;
  return (kTileRows * (static_cast<size_t>(H) + cols) +
          row_state_floats(K, D, G)) *
         sizeof(float);
}

// Soft y and in-kernel threefry noise from (k0, k1) only. Returns
// cudaGetLastError() after the launch (0 on success).
int gmvae_wide_head_fwd(const float* feats, const float* wk, const float* bk,
                        const float* wm, const float* bm, const float* wlv,
                        const float* blv, const float* pi_logits,
                        const float* p_means, const float* p_logvars,
                        float* z, float* y, float* scal, float* k_logits,
                        int B, int H, int K, int D, unsigned int k0,
                        unsigned int k1, float tau, void* stream) {
  const int L = group_lanes(D);
  const int W = block_warps(K, D, kWideWarps);
  const size_t smem = gmvae_wide_head_smem(H, K, D);
  const cudaError_t e = allow_smem(wide_head_fwd_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const WideIn w{feats, wk, bk, wm, bm, wlv, blv, B, H};
  const HeadIn in{nullptr, nullptr, nullptr, pi_logits, p_means, p_logvars,
                  nullptr, nullptr, K,       D,         L,       k0,
                  k1,      tau,     0};
  const int blocks = (B + kTileRows - 1) / kTileRows;
  wide_head_fwd_kernel<<<blocks, 32 * W, smem,
                         static_cast<cudaStream_t>(stream)>>>(w, in, z, y,
                                                              scal, k_logits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
