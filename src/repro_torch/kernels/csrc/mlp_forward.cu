// Whole-MLP forward for Hopper (sm_90a) in float32:
//   h = relu(h @ W_l + b_l) for every hidden layer, y = h @ W_L + b_L.
//
// Replaces the Pallas megakernel `_mlp_kernel` (src/repro/kernels/
// fused_mlp.py, driver `_mlp_forward`).  That kernel zero-pads every layer
// onto one (h, h) square and keeps the activations in two VMEM buffers
// across a sequential layer grid axis.  Here each layer keeps its own
// (K_l, N_l) shape, and the ragged edges (input width 16, head widths 29
// or 73) are masked inside the tile loads and the epilogue.
//
// Design: one tiled FP32 GEMM launch per layer, on the caller's stream.
// Each block computes a 64 x 64 output tile over one slice of K; K is
// staged through shared memory 16 at a time (x tile stored k-major, so a
// thread reads its 4 rows as one float4); each thread accumulates a 4 x 4
// register tile with fmaf.  At 64 rows a 2048-wide layer has only 32
// output tiles, so a layer with K >= 512 is split into k / 256 slices
// (at most 8): the slices write partial tiles to a workspace and a second
// small kernel sums them in slice order, adds the bias and applies ReLU
// (except on the last layer).  The split depends on K only, so a row's
// result does not depend on how many rows share the call.  Activations
// ping-pong between two scratch buffers the caller allocates (M x max
// hidden width floats each: 512 KB at M = 64, resident in the 50 MB L2).
// No tensor cores: the reference is full float32.
//
// What bounds it: at M = 64 rows the weights (~169 MB for the im2col G)
// are read once per call, and the FMAs are 2 * M * sum(K_l * N_l) flops;
// on an H100 SXM the float32 FMA rate (67 TFLOP/s) makes the arithmetic the
// larger of the two.  This simple tile reaches a fraction of either peak;
// keeping activations on chip across layers (clusters with distributed
// shared memory, or a persistent grid) and wgmma are later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // output tile rows
constexpr int BN = 64;          // output tile columns
constexpr int BK = 16;          // K staged per shared-memory step
constexpr int TM = 4;           // outputs per thread along rows
constexpr int TN = 4;           // outputs per thread along columns
constexpr int NT = (BM / TM) * (BN / TN);   // 256 threads
constexpr int SPLIT_K = 256;    // K per slice once a layer is split
constexpr int MAX_SPLITS = 8;

// K slices of a layer: a function of K alone (see the header note)
int k_splits(int k) {
  const int s = k / SPLIT_K;
  return s < 2 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
}

// x (m, k) @ w (k, n) over K slice blockIdx.z.  part == nullptr: the full
// K in one slice, bias (+ ReLU) in the epilogue, written to y.  Otherwise
// the raw partial tile goes to part[blockIdx.z] (m, n).
__global__ void __launch_bounds__(NT)
dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y,
                 float* __restrict__ part, int m, int k, int n, int k_len,
                 int relu) {
  constexpr int PAD = 4;  // keeps rows 16-byte aligned, spreads banks
  __shared__ __align__(16) float xs[BK][BM + PAD];  // x tile, k-major
  __shared__ __align__(16) float ws[BK][BN];        // w tile

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_len;
  const int k_end = min(k, k_begin + k_len);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < m && gc < k_end) ? x[(size_t)gr * k + gc] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < k_end && gc < n) ? w[(size_t)gr * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 v = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part ? part + (size_t)blockIdx.z * m * n : y;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= n) continue;
      float v = acc[i][j];
      if (!part) {
        v += b[c];
        if (relu) v = fmaxf(v, 0.f);
      }
      out[(size_t)r * n + c] = v;
    }
  }
}

// y = [relu](sum over slices of part + b), slices summed in order
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ part,
                     const float* __restrict__ b, float* __restrict__ y,
                     int m, int n, int splits, int relu) {
  const size_t total = (size_t)m * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[s * total + i];
    v += b[i % n];
    y[i] = relu ? fmaxf(v, 0.f) : v;
  }
}

}  // namespace

// Workspace (floats) that mlp_forward_f32 needs for these layer widths.
extern "C" long long mlp_forward_f32_workspace(const int* dims, int n_layers,
                                               int m) {
  long long need = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int s = k_splits(dims[l]);
    const long long w = s > 1 ? (long long)s * m * dims[l + 1] : 0;
    need = w > need ? w : need;
  }
  return need;
}

// Runs the whole MLP: layer l maps dims[l] -> dims[l + 1] columns.  x is
// (m, dims[0]), out is (m, dims[n_layers]); act0/act1 hold at least
// m * max(dims[1..n_layers-1]) floats and work holds
// mlp_forward_f32_workspace(dims, n_layers, m) floats.  All buffers
// row-major and contiguous on the current device.  Returns the first CUDA
// error (0 when every launch was accepted).
extern "C" int mlp_forward_f32(const float* x, const float* const* w_ptrs,
                               const float* const* b_ptrs, const int* dims,
                               int n_layers, int m, float* act0, float* act1,
                               float* work, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = x;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    float* dst = last ? out : (l % 2 == 0 ? act0 : act1);
    const int k = dims[l], n = dims[l + 1];
    const int splits = k_splits(k);
    const int k_len = (((k + splits - 1) / splits + BK - 1) / BK) * BK;
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
    dense_f32_kernel<<<grid, NT, 0, st>>>(in, w_ptrs[l], b_ptrs[l], dst,
                                          splits > 1 ? work : nullptr, m, k,
                                          n, k_len, !last);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (splits > 1) {
      const long long total = (long long)m * n;
      const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                          : 4096);
      reduce_splits_kernel<<<blocks, 256, 0, st>>>(work, b_ptrs[l], dst, m, n,
                                                   splits, !last);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    in = dst;
  }
  return 0;
}
