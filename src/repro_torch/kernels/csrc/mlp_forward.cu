// Whole-MLP forward for Hopper (sm_90a) in float32:
//   h = relu(h @ W_l + b_l) for every hidden layer, y = h @ W_L + b_L.
//
// Replaces the Pallas megakernel `_mlp_kernel` (src/repro/kernels/
// fused_mlp.py, driver `_mlp_forward`).  That kernel zero-pads every layer
// onto one (h, h) square and keeps the activations in two VMEM buffers
// across a sequential layer grid axis.  Here each layer keeps its own
// (K_l, N_l) shape, and the ragged edges (input width 16, head widths 29
// or 73) are zero-filled inside the tile loads and masked in the epilogue.
//
// Design: one C call runs every layer, one launch of the tensor-core tile
// of gemm_3xtf32.cuh per layer on the caller's stream (mma.sync TF32 with
// each operand split into big + small, float32-accurate; the bias and the
// ReLU, except on the last layer, in its epilogue).  A layer's K is cut
// into K / 256 slices (at most 8), each summed on its own and added to
// the total in slice order.  The slices depend on K alone, and so do the
// 32-deep stages within them, so a row's result does not depend on how
// many rows share the call.  How the slices are spread depends on the
// shape, and each way does the same float32 operations on a row:
// - at most 64 rows (the serving path's): the tile's 64-row form (4
//   warps; a 128-row tile would leave half its rows empty), the slices
//   split across the grid (a 2048-wide layer has only 16 output tiles),
//   writing partial tiles to a workspace that a second small kernel sums
//   in order before it adds the bias and applies ReLU;
// - more rows, while the 128-row tiles fill less than half the card:
//   the 128-row form, split the same way;
// - more rows still (M = 1024: 128 tiles of a 2048-wide layer): the
//   128-row form, each block folding its slices in order itself, with no
//   partial tiles in device memory.
// Activations ping-pong between two scratch buffers the caller allocates
// (M x max hidden width floats each: 512 KB at M = 64, resident in the
// 50 MB L2).
//
// What bounds it: at M = 64 rows, the bytes: the weights (~169 MB for the
// im2col G, 16.8 MB a hidden layer) are read once per call, against three
// TF32 products of 2 * M * sum(K_l * N_l) flops at 495 TFLOP/s.  At
// M = 1024 the products (about 0.052 ms a hidden layer).  Keeping
// activations on chip across layers (clusters with distributed shared
// memory, or a persistent grid) is later work.
#include "gemm_3xtf32.cuh"

namespace {

constexpr int SPLIT_K = 256;    // K a slice takes once K is split
constexpr int MAX_SPLITS = 8;

// K slices of a layer: a function of K alone (never of M)
int k_splits(int k) {
  const int s = k / SPLIT_K;
  return s < 2 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
}

// One layer, spread by its shape (see the header note)
int launch_layer(const gemm3::Gemm& g, cudaStream_t st) {
  using gemm3::BIAS;
  if (g.p <= gemm3::Block<1>::BM)
    return gemm3::launch<false, false, BIAS, 1>(g, st);
  constexpr int BM = gemm3::Block<2>::BM;
  const long long tiles = (long long)((g.p + BM - 1) / BM) *
                          ((g.q + gemm3::BN - 1) / gemm3::BN);
  if (2 * tiles <= gemm3::NUM_SMS)
    return gemm3::launch<false, false, BIAS, 2>(g, st);
  return gemm3::launch<false, false, BIAS, 2, true>(g, st);
}

}  // namespace

// Workspace (floats) that mlp_forward_f32 needs for these layer widths.
extern "C" long long mlp_forward_f32_workspace(const int* dims, int n_layers,
                                               int m) {
  long long need = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long w =
        gemm3::split_floats(m, dims[l + 1], k_splits(dims[l]));
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
    const gemm3::Gemm g{in, w_ptrs[l], dst, m, n, k, k_splits(k), work,
                        b_ptrs[l], !last};
    const int err = launch_layer(g, st);
    if (err != 0) return err;
    in = dst;
  }
  return 0;
}
