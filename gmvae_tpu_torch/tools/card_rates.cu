// Two rates of the card that bound the wide kernel (csrc/wide_head_fwd.cu):
//
// 1. mma.sync throughput: 132 blocks of 4, 8 or 16 warps, each warp
//    issuing m16n8k8 TF32 (and m16n8k16 bf16) products on 1, 4 or 8
//    independent accumulators; TFLOP/s and cycles a product per SM
//    sub-partition (at 1.755 GHz), so the latency (1 accumulator) and
//    the issue rate (8) show apart.
// 2. One SM's read rate from L2: 16 or 128 blocks of 8 warps (one an SM),
//    each reading a stripe of 512 rows x 328 columns of a [512, 5140]
//    float32 matrix (the wide kernel's weight stripe at cifar_head), with
//    4 or 16 float4 loads in flight a thread; also a [512, 2560] matrix
//    and a contiguous 512 x 328 block, read by every block.
//
// Built and run by gmvae_tpu_torch/tools/wide_variants.py --rates; alone:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o card_rates card_rates.cu
//   ./card_rates

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

template <int NACC, bool BF16>
__global__ void mma_loop(float* out, int iters) {
  float d[NACC][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint32_t b0 = a0 ^ 9, b1 = a0 ^ 11;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int NACC, bool BF16>
void mma_rate(int warps) {
  float* out;
  cudaMalloc(&out, 132 * 32 * warps * sizeof(float));
  const int iters = 4096;
  mma_loop<NACC, BF16><<<132, 32 * warps>>>(out, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  mma_loop<NACC, BF16><<<132, 32 * warps>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double mmas = 132.0 * warps * iters * NACC;
  const double flop = BF16 ? 4096.0 : 2048.0;
  printf("%s warps/SM %2d accumulators %d: %.1f TFLOP/s, %.2f cycles a "
         "product a sub-partition\n",
         BF16 ? "bf16 m16n8k16" : "tf32 m16n8k8 ", warps, NACC,
         mmas * flop / (ms * 1e-3) / 1e12,
         ms * 1e-3 * 1.755e9 / (mmas / 132 / 4));
  cudaFree(out);
}

// block b reads rows [0, rows) x columns [c0, c0 + width) of a [rows, ld]
// matrix, c0 = (b % ranks) * width, as float4 loads, UNROLL in flight
template <int UNROLL>
__global__ void stripe_read(const float* __restrict__ m, int rows, int ld,
                            int width, int ranks, float* out) {
  const int c0 = (blockIdx.x % ranks) * width;
  const int nq = width / 4;
  const int total = rows * nq;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = threadIdx.x; base < total; base += blockDim.x * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * blockDim.x;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total) {
        const int r = i / nq, j = i - r * nq;
        v[u] = __ldcg(
            reinterpret_cast<const float4*>(m + static_cast<size_t>(r) * ld +
                                            c0) + j);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}

template <int UNROLL>
void read_rate(const char* name, const float* m, int ld, int width,
               int ranks, int blocks, float* out) {
  const int rows = 512, reps = 20;
  for (int i = 0; i < 3; ++i)
    stripe_read<UNROLL><<<blocks, 256>>>(m, rows, ld, width, ranks, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i)
    stripe_read<UNROLL><<<blocks, 256>>>(m, rows, ld, width, ranks, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double us = 1e3 * ms / reps;
  const double bytes = static_cast<double>(rows) * width * 4;
  printf("%-28s blocks %3d, %2d loads in flight: %7.2f us, %5.1f GB/s a "
         "block, %5.2f TB/s\n",
         name, blocks, UNROLL, us, bytes / (us * 1e-6) / 1e9,
         blocks * bytes / (us * 1e-6) / 1e12);
}

int main() {
  for (int warps : {4, 8, 16}) {
    mma_rate<1, false>(warps);
    mma_rate<4, false>(warps);
    mma_rate<8, false>(warps);
    mma_rate<8, true>(warps);
  }
  float *m, *out;
  cudaMalloc(&m, static_cast<size_t>(512) * 5140 * sizeof(float));
  cudaMemset(m, 0, static_cast<size_t>(512) * 5140 * sizeof(float));
  cudaMalloc(&out, 128 * 256 * sizeof(float));
  for (int blocks : {16, 128}) {
    read_rate<4>("stripe 512x328 of [512,5140]", m, 5140, 328, 16, blocks,
                 out);
    read_rate<16>("stripe 512x328 of [512,5140]", m, 5140, 328, 16, blocks,
                  out);
    read_rate<16>("stripe 512x320 of [512,2560]", m, 2560, 320, 8, blocks,
                  out);
    read_rate<16>("contiguous 512x328", m, 328, 328, 1, blocks, out);
  }
  const cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(e));
    return 1;
  }
  return 0;
}
