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
// reduction grid axis with an accumulator in VMEM; here each is one grid of
// the 64 x 64 float32 tile of dense_tile.cuh, reducing inside the block:
//
// - forward: A = x, B = W, bias and ReLU in the epilogue.
// - dx: A = dy with the mask from y applied as the tile is loaded, B = W
//   read transposed in place (no Wᵀ copy).
// - dW, db: A = x read transposed in place, B = dy masked on load; the
//   blocks of the first K tile also sum g's columns over M for db in the
//   same pass, as the TPU kernel's k_blk == 0 sweep does.  No atomics, so
//   two calls give the same bits.
//
// At Algorithm 1's batch (M = 1024) a 2048 -> 2048 layer has 512 output
// tiles in each of the three, enough for the card.  A call with fewer
// tiles than the card's 132 SMs (the heads, and dx of D's first layer,
// 1024 x 81) splits its reduction into R / 256 slices (at most 8) through
// the caller's workspace; dW never has to (its reduction is M).
//
// What bounds it: each kernel does 2·M·K·N flops and moves each operand
// once; at a hidden layer that is 8.6 GFLOP against 34-42 MB, so the
// float32 FMA rate (67 TFLOP/s on an H100 SXM, about 0.13 ms) bounds it,
// not the bytes (about 0.01 ms).  This SIMT tile reaches a fraction of that
// rate; wgmma with TMA under an explicit precision opt-in is later work.
#include "dense_tile.cuh"

namespace {

constexpr int NUM_SMS = 132;

// R slices for a C (p, q) with reduction r: split only when the output
// tiles alone cannot occupy every SM
int train_splits(int p, int q, int r) {
  const long long tiles = (long long)((p + dense_tile::BM - 1) / dense_tile::BM) *
                          ((q + dense_tile::BN - 1) / dense_tile::BN);
  return tiles >= NUM_SMS ? 1 : dense_tile::r_splits(r);
}

}  // namespace

// Workspace (floats) that dense_forward_f32 (p = M, q = N, r = K) or
// dense_dx_f32 (p = M, q = K, r = N) needs.
extern "C" long long dense_train_workspace(int p, int q, int r) {
  return dense_tile::split_workspace(p, q, train_splits(p, q, r));
}

// y (M, N) = [relu](x (M, K) · w (K, N) + b (N,)).  All row-major and
// contiguous on the current device; work holds dense_train_workspace(m, n,
// k) floats.  Returns the first CUDA error, 0 when every launch was accepted.
extern "C" int dense_forward_f32(const float* x, const float* w,
                                 const float* b, float* y, int m, int k, int n,
                                 int relu, float* work, void* stream) {
  return dense_tile::launch_gemm<false, false>(
      x, nullptr, w, nullptr, b, y, work, nullptr, m, n, k,
      train_splits(m, n, k), relu, static_cast<cudaStream_t>(stream));
}

// dx (M, K) = (dy ⊙ [y > 0]) (M, N) · w (K, N)ᵀ; without relu the mask is
// skipped (y may then be null).  work holds dense_train_workspace(m, k, n)
// floats.
extern "C" int dense_dx_f32(const float* dy, const float* y, const float* w,
                            float* dx, int m, int k, int n, int relu,
                            float* work, void* stream) {
  const int splits = train_splits(m, k, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return relu ? dense_tile::launch_gemm<false, true, true>(
                    dy, y, w, nullptr, nullptr, dx, work, nullptr, m, k, n,
                    splits, 0, st)
              : dense_tile::launch_gemm<false, true>(
                    dy, nullptr, w, nullptr, nullptr, dx, work, nullptr, m, k,
                    n, splits, 0, st);
}

// dw (K, N) = x (M, K)ᵀ · g and db (N,) = Σ_M g, g = dy ⊙ [y > 0] (relu)
// or dy, in one pass.
extern "C" int dense_dw_db_f32(const float* x, const float* dy, const float* y,
                               float* dw, float* db, int m, int k, int n,
                               int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return relu ? dense_tile::launch_gemm<true, false, false, true, true>(
                    x, nullptr, dy, y, nullptr, dw, nullptr, db, k, n, m, 1, 0,
                    st)
              : dense_tile::launch_gemm<true, false, false, false, true>(
                    x, nullptr, dy, nullptr, nullptr, dw, nullptr, db, k, n, m,
                    1, 0, st);
}
