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
// Design: one tiled FP32 GEMM launch per layer, on the caller's stream
// (the tile of dense_tile.cuh, shared with the training kernels).  Each
// block computes a 64 x 64 output tile over one slice of K; K is staged
// through shared memory 16 at a time; each thread accumulates a 4 x 4
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
#include "dense_tile.cuh"

using dense_tile::r_splits;

// Workspace (floats) that mlp_forward_f32 needs for these layer widths.
extern "C" long long mlp_forward_f32_workspace(const int* dims, int n_layers,
                                               int m) {
  long long need = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long w =
        dense_tile::split_workspace(m, dims[l + 1], r_splits(dims[l]));
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
    const int err = dense_tile::launch_gemm<false, false>(
        in, nullptr, w_ptrs[l], nullptr, b_ptrs[l], dst, work, nullptr, m, n,
        k, r_splits(k), !last, st);
    if (err != 0) return err;
    in = dst;
  }
  return 0;
}
