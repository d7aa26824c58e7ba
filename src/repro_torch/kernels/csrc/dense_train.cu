// The dense layer of Algorithm 1's training step for Hopper (sm_90a), in
// float32: its forward and its two backward kernels.
//
//   forward  y  = [relu](x · W + b)            x (M, K), W (K, N), b (N,)
//   dx       dx = g · Wᵀ                       g = dy ⊙ [y > 0] (relu) or dy
//   dW, db   dW = xᵀ · g,  db = Σ_M g
//
// Replaces the Pallas kernels `_fused_dense_kernel`, `_dx_kernel` and
// `_dw_db_kernel` (src/repro/kernels/fused_mlp.py, launched by `_forward` and
// `_backward`, the custom_vjp of `fused_dense`).  Those run a sequential
// reduction grid axis with an accumulator in VMEM; here each is one grid
// that reduces inside the block, on the 128 x 128 tensor-core tile of
// gemm_3xtf32.cuh (mma.sync TF32, each operand split into big + small:
// float32-accurate):
//
// - forward: A = x, B = W, both read as stored; the bias and ReLU in the
//   tile's epilogue, after the full sum over K.
// - dx: under relu, one elementwise pass writes g = dy ⊙ [y > 0] to the
//   workspace; then A = g and B = W read transposed in place (no Wᵀ
//   copy).
// - dW, db: the same mask pass and tile, A = x read transposed in place,
//   B = g; the blocks of the first K tile also sum g's columns over M for
//   db in the same pass, as the TPU kernel's k_blk == 0 sweep does.
//
// Each kernel splits its reduction where the output has too few 128 x 128
// tiles to fill the card (gemm3::splits, from the shape alone: the
// forward at the heads, dx at D's first layer, 1024 x 81, dW at D's first
// layer and at both heads), summing the slices in order, then adding the
// bias and applying ReLU.  No atomics anywhere, so two calls give the
// same bits.
//
// What bounds them: each kernel does 2·M·K·N flops and moves each operand
// once; at a hidden layer that is 8.6 GFLOP against 34-42 MB.  At three
// TF32 products and 495 TFLOP/s that is about 0.052 ms; the bytes take
// about 0.01 ms.  wgmma with TMA is later work (PERF.md).
#include "gemm_3xtf32.cuh"

// Workspace (floats) that dense_forward_f32 (p = M, q = N, r = K) needs.
extern "C" long long dense_train_workspace(int p, int q, int r) {
  return gemm3::workspace(p, q, r);
}

// Workspace (floats) that dense_dx_f32 and dense_dw_db_f32 need at a
// layer x (M, K) -> y (M, N): g = dy ⊙ [y > 0] under relu, then the
// partial tiles of a split reduction (dx: p = M, q = K, r = N; dW: p = K,
// q = N, r = M).
extern "C" long long dense_backward_workspace(int m, int k, int n,
                                              int relu) {
  const long long dx = gemm3::workspace(m, k, n);
  const long long dw = gemm3::workspace(k, n, m);
  return (relu ? (long long)m * n : 0) + (dx > dw ? dx : dw);
}

// y (M, N) = [relu](x (M, K) · w (K, N) + b (N,)).  All row-major and
// contiguous on the current device; work holds dense_train_workspace(m, n,
// k) floats.  Returns the first CUDA error, 0 when every launch was accepted.
extern "C" int dense_forward_f32(const float* x, const float* w,
                                 const float* b, float* y, int m, int k, int n,
                                 int relu, float* work, void* stream) {
  gemm3::Gemm g{x, w, y, m, n, k, gemm3::splits(m, n, k), work, b, relu};
  return gemm3::launch<false, false, gemm3::BIAS>(
      g, static_cast<cudaStream_t>(stream));
}

namespace {

// g = dy ⊙ [y > 0] written to the head of work under relu, else dy itself;
// *rest is the workspace past g.  Returns a CUDA error, 0 on success.
int masked(const float* dy, const float* y, int m, int n, int relu,
           float* work, const float** g, float** rest, cudaStream_t st) {
  *g = dy;
  *rest = work;
  if (!relu) return 0;
  *g = work;
  *rest = work + (size_t)m * n;
  return gemm3::launch_relu_mask(dy, y, work, (long long)m * n, st);
}

}  // namespace

// dx (M, K) = (dy ⊙ [y > 0]) (M, N) · w (K, N)ᵀ; without relu the mask is
// skipped (y may then be null).  work holds dense_backward_workspace(m, k,
// n, relu) floats.
extern "C" int dense_dx_f32(const float* dy, const float* y, const float* w,
                            float* dx, int m, int k, int n, int relu,
                            float* work, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g;
  float* rest;
  const int err = masked(dy, y, m, n, relu, work, &g, &rest, st);
  if (err) return err;
  return gemm3::launch<false, true, gemm3::NONE>(
      gemm3::Gemm{g, w, dx, m, k, n, gemm3::splits(m, k, n), rest}, st);
}

// dw (K, N) = x (M, K)ᵀ · g and db (N,) = Σ_M g, g = dy ⊙ [y > 0] (relu)
// or dy, in one pass.  work holds dense_backward_workspace(m, k, n, relu)
// floats.
extern "C" int dense_dw_db_f32(const float* x, const float* dy, const float* y,
                               float* dw, float* db, int m, int k, int n,
                               int relu, float* work, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g;
  float* rest;
  const int err = masked(dy, y, m, n, relu, work, &g, &rest, st);
  if (err) return err;
  gemm3::Gemm call{x, g, dw, k, n, m, gemm3::splits(k, n, m), rest};
  call.colsum = db;
  return gemm3::launch<true, false, gemm3::COLSUM>(call, st);
}
