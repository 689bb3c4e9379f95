// Fused mixture-ELBO head forward for Hopper (sm_90a).
//
// Replaces the TPU kernels gmvae_tpu/ops/kernels/fused_elbo.py:_kernel_flat
// and :_kernel (one kernel serves every shape: their split exists only for
// the TPU's 128-lane vector width). It computes, per batch row, what
// gmvae_tpu_torch/elbo.py:head_from_noise computes:
//
//   Gumbel g [K] and normal eps [D] from threefry over the row's counters
//   (or read from g_in/eps_in when streamed)
//   y    = softmax((logits + g) / tau), one-hot of argmax when hard
//   mean = sum_k y_k qm_k,  logvar = sum_k y_k clamp(qlv_k)
//   z    = mean + exp(logvar/2) * eps
//   K log-densities of z under q and under the prior, two LSEs over K,
//   the y-interpolated log p(z|y) and log q(z|x,y), and KL(q(k|x)||pi).
//
// Outputs: z [B,D], y [B,K], scal [B,8] = (log_prior_mix, log_q_mix,
// log_p_cond, log_q_cond, kl_cat, 0, 0, 0), all float32.
//
// What bounds it on an H100: of the two roofline limits, bytes. Each row
// reads 2*K*D + K floats and writes D + K + 8, against about 22*K*D float
// operations, far below the card's ~20 flop/byte balance point for float32
// outside the tensor cores. At the flagship shape (B=128, K=10, D=10) a
// call moves ~120 KB (0.04 us at 3.35 TB/s), so in practice latency sets
// its time: the chain of dependent steps a row goes through.
//
// Design (head_row.cuh has the layout and the steps). One block per row
// stages the row's q tiles and the prior in shared memory by TMA bulk
// copies (or cp.async where unaligned) issued as the block starts, so the
// copies overlap the threefry noise and each input crosses from L2 or
// device memory once per block (at (128,64,256), where the four tiles do
// not fit, the q tiles only, and the prior is read once from L2). The
// K-vector steps (softmax and argmax, the two log-softmaxes) run on three
// warps side by side, the packed scalars on four. z and y are stored as
// float4 where aligned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_row.cuh"

namespace {

using namespace gmvae;

__global__ void __launch_bounds__(32 * kMaxWarps)
    fused_elbo_fwd_kernel(const HeadIn in, const int stage_q,
                                      const int stage_p,
                                      float* __restrict__ z_out,
                                      float* __restrict__ y_out,
                                      float* __restrict__ scal_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* tiles = reinterpret_cast<float*>(smem_raw + kHeaderBytes);
  const int row = blockIdx.x;
  const int K = in.K, D = in.D;
  const int kd = K * D;
  RowIn r = row_in(in, row);
  const Staging staged = stage_row(tiles, kd, stage_q, stage_p, r, bar);
  const RowState<float> st =
      row_state(tiles + static_cast<size_t>(2 * (stage_q + stage_p)) * kd,
                K, D, blockDim.x / in.L);
  row_forward(in, r, st, row, staged, y_out, z_out);
  row_scalars(in, st, row, scal_out);
}

__global__ void threefry_grid_kernel(uint32_t k0, uint32_t k1,
                                     const uint32_t* __restrict__ c0,
                                     const uint32_t* __restrict__ c1,
                                     uint32_t* __restrict__ x0,
                                     uint32_t* __restrict__ x1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) threefry2x32(k0, k1, c0[i], c1[i], x0[i], x1[i]);
}

}  // namespace

extern "C" {

const char* gmvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g_in/eps_in null: in-kernel threefry noise from the key. `key` (two
// words) and `tau` are device pointers, read by the kernel. Returns
// cudaGetLastError() after the launch (0 on success).
int gmvae_fused_elbo_fwd(const float* k_logits, const float* q_means,
                         const float* q_logvars, const float* pi_logits,
                         const float* p_means, const float* p_logvars,
                         const float* g_in, const float* eps_in, float* z,
                         float* y, float* scal, int B, int K, int D,
                         const unsigned int* key, const float* tau, int hard,
                         void* stream) {
  const int L = group_lanes(D);
  const LaunchPlan lp = plan_launch(K, D, 0, false, kMaxWarps);
  const SmemPlan& plan = lp.smem;
  const cudaError_t e = allow_smem(fused_elbo_fwd_kernel, plan.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const HeadIn in{k_logits, q_means, q_logvars, pi_logits, p_means,
                  p_logvars, g_in,     eps_in,    K,         D,
                  L,        key,       tau,       hard};
  fused_elbo_fwd_kernel<<<B, 32 * lp.warps, plan.bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      in, plan.stage_q, plan.stage_p, z, y, scal);
  return static_cast<int>(cudaGetLastError());
}

// Raw threefry words for explicit counters: a check of the device generator
// against the host replay, not part of any model path.
int gmvae_threefry_grid(unsigned int k0, unsigned int k1, const void* c0,
                        const void* c1, void* x0, void* x1, int n,
                        void* stream) {
  const int threads = 256;
  threefry_grid_kernel<<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<const uint32_t*>(c0),
      static_cast<const uint32_t*>(c1), static_cast<uint32_t*>(x0),
      static_cast<uint32_t*>(x1), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
