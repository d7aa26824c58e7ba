// The rate of mma.sync.m16n8k8 TF32 on an H100: the instruction the 3xTF32
// tile (csrc/gemm_3xtf32.cuh) issues, at that tile's occupancy (8 warps a
// block, one block an SM, 16 independent accumulators a warp), with the
// operands in registers, so that nothing but the tensor cores bounds it.
// The tile's own time set against this rate says how much of it is lost to
// staging and fragment loads.  A standalone program, not part of the
// kernel library:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_tf32_peak \
//       mma_tf32_peak.cu && ./mma_tf32_peak
#include <cstdint>
#include <cstdio>

__device__ __forceinline__ float lane() { return (float)threadIdx.x; }

__global__ void __launch_bounds__(256, 1) peak(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = __float_as_uint(1e-3f * (lane() + e));
  for (int e = 0; e < 2; ++e) b[e] = __float_as_uint(1e-3f * (lane() - e));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]), "+f"(acc[t][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int t = 0; t < 16; ++t)
    for (int e = 0; e < 4; ++e) s += acc[t][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;   // keeps the work live
}

int main() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  float* out;
  cudaMalloc(&out, (size_t)sms * 256 * sizeof(float));
  const int iters = 4096;
  peak<<<sms, 256>>>(out, 16);                          // warm-up
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaEventRecord(t0);
  peak<<<sms, 256>>>(out, iters);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  const cudaError_t err = cudaGetLastError();
  // 8 warps x 16 accumulators x 2·16·8·8 flops an mma, per iteration
  const double flops = (double)sms * 8 * 16 * iters * 2.0 * 16 * 8 * 8;
  printf("mma.sync m16n8k8 tf32 on %d SMs: %.1f TFLOP/s (%.3f ms)\n", sms,
         flops / ms / 1e9, ms);
  return err == cudaSuccess ? 0 : 1;
}
