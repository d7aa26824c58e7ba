// The float32 SIMT GEMM tile of the port's forward kernels (mlp_forward.cu,
// dense_train.cu's dense_forward_f32), for Hopper (sm_90a); its
// reduce_splits_kernel also sums the split slices of gemm_3xtf32.cuh, the
// tensor-core tile of the backward kernels.
//
//   C (P, Q) = sum over r of A(p, r) * B(r, q)
//
// A and B are read in either layout (the transposed, masked and COLSUM
// options have no caller since the backward kernels moved to
// gemm_3xtf32.cuh; they go when the forward pair moves too):
//   A_T false: A is stored (P, R) row-major;  A_T true: stored (R, P).
//   B_T false: B is stored (R, Q) row-major;  B_T true: stored (Q, R).
// An operand may carry a ReLU mask (MASK_A, MASK_B): a tensor of its own
// layout whose entries > 0 keep the operand's value and others zero it
// (g = dy ⊙ [y > 0], applied while the tile is loaded, as the TPU kernels
// apply it).  COLSUM also sums B's columns over R.  Each option is a
// template parameter, so an instantiation without it carries no code for
// it in its loads or its inner loop.
//
// Each block computes a 64 x 64 tile of C over one slice of R (blockIdx.z),
// staging R 16 at a time through shared memory (both tiles stored r-major,
// so a thread reads its 4 rows and 4 columns as one float4 each); each of
// the 256 threads accumulates a 4 x 4 register tile with fmaf, in R order.
// Loads run along the operand's contiguous axis and are masked at the
// ragged edges (widths 16/37/81 in, 2/29/73 out).  With a split, slices
// write raw partial tiles to a workspace and reduce_splits_kernel sums
// them in slice order.  No tensor cores and no atomics: full float32, and
// two calls give the same bits.
#pragma once
#include <cuda_runtime.h>

namespace dense_tile {

constexpr int BM = 64;          // C tile rows
constexpr int BN = 64;          // C tile columns
constexpr int BK = 16;          // R staged per shared-memory step
constexpr int TM = 4;           // outputs per thread along rows
constexpr int TN = 4;           // outputs per thread along columns
constexpr int NT = (BM / TM) * (BN / TN);   // 256 threads
constexpr int PAD = 4;          // keeps rows 16-byte aligned, spreads banks
constexpr int SPLIT_R = 256;    // R per slice once the reduction is split
constexpr int MAX_SPLITS = 8;

// R slices when a call splits its reduction: a function of R alone
inline int r_splits(int r) {
  const int s = r / SPLIT_R;
  return s < 2 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
}

template <bool MASK>
__device__ __forceinline__ float load(const float* __restrict__ v,
                                      const float* __restrict__ mask,
                                      size_t i) {
  // dy * [y > 0] as the reference writes it (a product, not a select)
  if constexpr (MASK) return v[i] * (mask[i] > 0.f ? 1.f : 0.f);
  return v[i];
}

// One slice of C = A · B (see the header note).  part == nullptr: the full
// R in one slice; the epilogue adds bias (if any), applies ReLU (if relu)
// and writes c.  Otherwise the raw partial tile goes to part[blockIdx.z].
// COLSUM: the blocks of the first row tile also sum B's column over r
// (db = Σ_M g, in r order) and write it to colsum.
template <bool A_T, bool B_T, bool MASK_A, bool MASK_B, bool COLSUM>
__global__ void __launch_bounds__(NT)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ a_mask,
                const float* __restrict__ b, const float* __restrict__ b_mask,
                const float* __restrict__ bias, float* __restrict__ c,
                float* __restrict__ part, float* __restrict__ colsum,
                int p, int q, int r, int r_len, int relu) {
  __shared__ __align__(16) float as[BK][BM + PAD];  // A tile, r-major
  __shared__ __align__(16) float bs[BK][BN + PAD];  // B tile, r-major

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int r_begin = blockIdx.z * r_len;
  const int r_end = min(r, r_begin + r_len);
  const bool sum_cols = COLSUM && blockIdx.y == 0 && ty == 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float csum[TN] = {0.f, 0.f, 0.f, 0.f};

  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      // contiguous axis fastest across threads
      const int rr = A_T ? i / BM : i % BK;
      const int pp = A_T ? i % BM : i / BK;
      const int gp = row0 + pp, gr = r0 + rr;
      as[rr][pp] = (gp < p && gr < r_end)
          ? load<MASK_A>(a, a_mask,
                         A_T ? (size_t)gr * p + gp : (size_t)gp * r + gr)
          : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int rr = B_T ? i % BK : i / BN;
      const int qq = B_T ? i / BK : i % BN;
      const int gr = r0 + rr, gq = col0 + qq;
      bs[rr][qq] = (gr < r_end && gq < q)
          ? load<MASK_B>(b, b_mask,
                         B_T ? (size_t)gq * r + gr : (size_t)gr * q + gq)
          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av4 = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&bs[kk][tx * TN]);
      const float av[TM] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[TN] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if constexpr (COLSUM) {
        if (sum_cols) {
#pragma unroll
          for (int j = 0; j < TN; ++j) csum[j] += bv[j];
        }
      }
    }
    __syncthreads();
  }

  if constexpr (COLSUM) {
    if (sum_cols) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int cc = col0 + tx * TN + j;
        if (cc < q) colsum[cc] = csum[j];
      }
    }
  }
  float* out = part ? part + (size_t)blockIdx.z * p * q : c;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rr = row0 + ty * TM + i;
    if (rr >= p) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + tx * TN + j;
      if (cc >= q) continue;
      float v = acc[i][j];
      if (!part) {
        if (bias) v += bias[cc];
        if (relu) v = fmaxf(v, 0.f);
      }
      out[(size_t)rr * q + cc] = v;
    }
  }
}

// c = [relu](sum over slices of part [+ bias]), slices summed in order
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ part,
                     const float* __restrict__ bias, float* __restrict__ c,
                     int p, int q, int splits, int relu) {
  const size_t total = (size_t)p * q;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[s * total + i];
    if (bias) v += bias[i % q];
    c[i] = relu ? fmaxf(v, 0.f) : v;
  }
}

// Floats of workspace a call with `splits` slices needs.
inline long long split_workspace(int p, int q, int splits) {
  return splits > 1 ? (long long)splits * p * q : 0;
}

// C = A · B [+ bias] [relu] over `splits` slices of R (work holds
// split_workspace(p, q, splits) floats when splits > 1), on stream st.
// Returns the first CUDA launch error, 0 when every launch was accepted.
template <bool A_T, bool B_T, bool MASK_A = false, bool MASK_B = false,
          bool COLSUM = false>
int launch_gemm(const float* a, const float* a_mask, const float* b,
                const float* b_mask, const float* bias, float* c, float* work,
                float* colsum, int p, int q, int r, int splits, int relu,
                cudaStream_t st) {
  const int r_len = (((r + splits - 1) / splits + BK - 1) / BK) * BK;
  const dim3 grid((q + BN - 1) / BN, (p + BM - 1) / BM, splits);
  gemm_f32_kernel<A_T, B_T, MASK_A, MASK_B, COLSUM><<<grid, NT, 0, st>>>(
      a, a_mask, b, b_mask, bias, c, splits > 1 ? work : nullptr, colsum, p,
      q, r, r_len, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const long long total = (long long)p * q;
    const int blocks =
        (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    reduce_splits_kernel<<<blocks, 256, 0, st>>>(work, bias, c, p, q, splits,
                                                 relu);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace dense_tile
