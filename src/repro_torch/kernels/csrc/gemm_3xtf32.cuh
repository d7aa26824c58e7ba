// The tensor-core GEMM tile of the dense layer's two backward kernels
// (dense_train.cu: dense_dx_f32, dense_dw_db_f32), for Hopper (sm_90a),
// float32-accurate through a 3xTF32 split.
//
//   C (P, Q) = sum over r of A(p, r) * B(r, q)
//
// Replaces, with dense_train.cu, the Pallas kernels `_dx_kernel` and
// `_dw_db_kernel` (src/repro/kernels/fused_mlp.py:121 and :143):
//   dx (M, K) = g · Wᵀ:   A = g, stored (P, R) = (M, N); B(r, q) = W(q, r)
//   dW (K, N) = xᵀ · g:   A(p, r) = x(r, p), stored (R, P); B = g (R, Q);
//                         db (N) = Σ_M g summed in the same pass (COLSUM)
// with g = dy ⊙ [y > 0] under relu, else g = dy (relu_mask_kernel).
//
// Why 3xTF32.  A TF32 tensor-core product keeps 10 mantissa bits of each
// operand, which misses the port's float32 contract (1e-4·max(1,
// max|y_ref|) from the plain version).  Each operand a is split in
// registers into big = a rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32 rounds) and small = a - big (exact in float32; the
// tensor cores read its top 19 bits, a truncation worth ~2^-21 of a), and
// three products are accumulated in float32, small terms first, as
// CUTLASS's OpMultiplyAddFastF32 does: small·big, big·small, big·big
// (small·small, ~2^-22 relative, is dropped).  Emulated on the CPU with
// dx-shaped float32 operands (M = 256, K = N = 2048, seed 0; the split's
// tests in tests/test_torch_kernels.py), max error over max(1, max|ref|)
// from a float64 product:
//   float32 (numpy matmul)  3.1e-7
//   1xTF32                  3.0e-4   (fails the 1e-4 tolerance)
//   3xTF32                  8.0e-8
// So the split is held to the same tolerance as a float32 kernel; it is
// not a precision opt-in.  Special values: with an inf operand, a - big
// is NaN, so the product is NaN where the plain one is ±inf (training
// feeds no inf; chip_smoke.py asserts finite outputs).
//
// What bounds it: operations.  Three TF32 products of 2·P·Q·R flops each
// at the card's 495 TFLOP/s: a hidden layer of Algorithm 1 (1024 x 2048 x
// 2048, 8.6 GFLOP a product) takes at least 0.052 ms, against 0.013 ms to
// move its ~42 MB once (the narrow layers are bound by their bytes).
//
// Design.  mma.sync.m16n8k8 tf32 (wgmma reads B only from shared memory,
// so a split B would be staged twice, and tf32 wgmma takes only K-major
// operands: both of dW's are M-major).  A block computes a 128 x 128 tile
// of C with 8 warps of 64 x 32; R is staged 32 at a time through a
// 3-stage cp.async ring, so the next two slices are in flight while one is
// multiplied.  Each operand tile is stored in its global layout: rows
// along R padded to 36 floats, rows along P or Q padded to 136, which
// makes every fragment read conflict-free.  The tensor cores round toward
// zero as they add into their float32 accumulator, so one chain of mma's
// over R = 2048 drifts one way (1e-5 of scale on the card, 10x the float32
// product's error); each stage's 12 mma's run in a fresh chain that is
// added to the accumulators with round-to-nearest float32 adds, which
// brings the error back to the float32 product's.  Copies are 16 bytes
// where the operand's rows are 16-byte aligned (VEC_A / VEC_B, chosen by
// the launcher from the widths and pointers), else 4 bytes; the ragged
// edge is zero-filled through cp.async's src-size operand, with no branch
// in the inner loop.  The ReLU mask cannot ride a cp.async, and staging
// y's tile beside dy's (a third more bytes through L2, and a masking pass
// over shared memory before each barrier) was slower than one elementwise
// pass: relu_mask_kernel writes g = dy ⊙ [y > 0] to the caller's
// workspace and the GEMM reads g.  Each dy element is multiplied once by
// 1.0 or 0.0.
// db is summed from the raw g fragments by the warps of the first row of
// warps in the blocks of the first row tile, then across the 4 lanes that
// share a column: a fixed order.  A call whose output has too few tiles
// to fill the card splits R into slices (a function of the shape alone);
// the slices write partial tiles (and partial db) to the caller's
// workspace and dense_tile::reduce_splits_kernel sums them in slice order.
// No atomics: two calls give the same bits.
//
// Left for later: wgmma + TMA for the K-major case (dx), a persistent grid
// that overlaps one tile's epilogue with the next one's loads, and the
// forward pair (dense_forward_f32, mlp_forward_f32) on this tile.
#pragma once
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "dense_tile.cuh"

namespace gemm3 {

constexpr int BMN = 128;        // C tile rows and columns
constexpr int BK = 32;          // R staged per pipeline stage
constexpr int STAGES = 3;       // cp.async ring depth
constexpr int WARPS_M = 2;      // warps along P
constexpr int WARPS_N = 4;      // warps along Q
constexpr int NT = 32 * WARPS_M * WARPS_N;  // 256 threads
constexpr int WM = BMN / WARPS_M;           // 64 rows a warp
constexpr int WN = BMN / WARPS_N;           // 32 columns a warp
constexpr int MI = WM / 16;                 // m16 fragments a warp
constexpr int NJ = WN / 8;                  // n8 fragments a warp
constexpr int NUM_SMS = 132;
constexpr int SPLIT_R = 128;    // least R a slice takes once R is split
constexpr int MAX_SPLITS = 16;

// An operand's tile in shared memory, stored as it is in global memory:
// R_CONTIG (rows along P or Q, R contiguous) or rows along R.
template <bool R_CONTIG>
struct Tile {
  static constexpr int ROWS = R_CONTIG ? BMN : BK;
  static constexpr int COLS = R_CONTIG ? BK : BMN;
  static constexpr int LD = R_CONTIG ? BK + 4 : BMN + 8;   // bank padding
  static constexpr int FLOATS = ROWS * LD;
};

// R slices for a C (p, q) with reduction r: as many as keep one wave of
// blocks on the card, each at least SPLIT_R long.  Shapes alone decide.
inline int splits(int p, int q, int r) {
  const long long tiles =
      (long long)((p + BMN - 1) / BMN) * ((q + BMN - 1) / BMN);
  long long s = NUM_SMS / tiles;
  s = s < r / SPLIT_R ? s : r / SPLIT_R;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  return s < 1 ? 1 : (int)s;
}

// Floats of workspace a call needs: partial tiles and partial column sums.
inline long long workspace(int p, int q, int r) {
  const int s = splits(p, q, r);
  return s > 1 ? (long long)s * ((long long)p * q + q) : 0;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The copies of one tile that this thread issues: copy i covers W floats
// at (row, col) of the tile.
template <bool R_CONTIG, bool VEC>
struct Copies {
  static constexpr int W = VEC ? 4 : 1;
  static constexpr int PER_ROW = Tile<R_CONTIG>::COLS / W;
  static constexpr int N = Tile<R_CONTIG>::ROWS * PER_ROW / NT;
  __device__ static void at(int i, int& row, int& col) {
    const int c = threadIdx.x + i * NT;
    row = c / PER_ROW;
    col = (c % PER_ROW) * W;
  }
};

// Copy i of this thread's share of a tile (see stage_tile).
template <bool R_CONTIG, bool VEC>
__device__ __forceinline__ void stage_copy(float* s,
                                           const float* __restrict__ g,
                                           int pq_n, int r_n, int pq0, int r0,
                                           int r_end, int i) {
  int row, col;
  Copies<R_CONTIG, VEC>::at(i, row, col);
  const int gpq = pq0 + (R_CONTIG ? row : col);
  const int gr = r0 + (R_CONTIG ? col : row);
  const bool ok = gpq < pq_n && gr < r_end;
  const float* src =
      ok ? g + (R_CONTIG ? (size_t)gpq * r_n + gr : (size_t)gr * pq_n + gpq)
         : g;
  cp_async(s + row * Tile<R_CONTIG>::LD + col, src, VEC, ok);
}

// Stage the tile at (pq0, r0) of an operand that is pq_n wide along P or
// Q and r_n along R, zero past pq_n and past r_end.  R_CONTIG: stored
// (pq_n, r_n) row-major; else stored (r_n, pq_n).  The 4 copies of a
// 16-byte tile are unrolled; the 16 of a 4-byte tile are not (unrolled,
// their source addresses would stay live across the whole reduction loop
// and push the kernel past 255 registers).
template <bool R_CONTIG, bool VEC>
__device__ __forceinline__ void stage_tile(float* s,
                                           const float* __restrict__ g,
                                           int pq_n, int r_n, int pq0, int r0,
                                           int r_end) {
  constexpr int N = Copies<R_CONTIG, VEC>::N;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      stage_copy<R_CONTIG, VEC>(s, g, pq_n, r_n, pq0, r0, r_end, i);
  } else {
#pragma unroll 1
    for (int i = 0; i < N; ++i)
      stage_copy<R_CONTIG, VEC>(s, g, pq_n, r_n, pq0, r0, r_end, i);
  }
}

// x = big + small: big is x rounded to TF32, to nearest with ties away
// from zero on the magnitude bits (what cvt.rna.tf32.f32 gives, in two
// integer ops: the cvt costs more issue slots, and this loop is bound by
// them); small = x - big, exact, passed whole (the tensor cores ignore its
// low 13 bits)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool A_T, bool B_T>
__host__ __device__ constexpr int stage_floats() {
  return Tile<!A_T>::FLOATS + Tile<B_T>::FLOATS;
}

// One slice of C = A · B (see the header note).  A_T false: A stored
// (P, R); true: stored (R, P).  B_T false: B stored (R, Q); true: stored
// (Q, R).  part == nullptr: the full R in one slice, written to c (and the
// column sums to colsum); otherwise to part[blockIdx.z] (and
// colsum_part[blockIdx.z]).
template <bool A_T, bool B_T, bool COLSUM, bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(NT, 1)
gemm_3xtf32_kernel(const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ c,
                   float* __restrict__ colsum, float* __restrict__ part,
                   float* __restrict__ colsum_part, int p, int q, int r,
                   int r_len) {
  extern __shared__ __align__(16) float smem[];
  using TA = Tile<!A_T>;
  using TB = Tile<B_T>;
  constexpr int STAGE = stage_floats<A_T, B_T>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * BMN, col0 = blockIdx.x * BMN;
  const int r_begin = blockIdx.z * r_len;
  const int r_end = min(r, r_begin + r_len);
  const int ktiles = r_end > r_begin ? (r_end - r_begin + BK - 1) / BK : 0;
  const bool sum_cols = COLSUM && blockIdx.y == 0 && wm == 0;

  auto load = [&](int stage, int r0) {
    float* s = smem + stage * STAGE;
    stage_tile<!A_T, VEC_A>(s, a, p, r, row0, r0, r_end);
    stage_tile<B_T, VEC_B>(s + TA::FLOATS, b, q, r, col0, r0, r_end);
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float csum[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) csum[j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, r_begin + s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();         // this thread's copies of kt landed
    __syncthreads();                     // stage kt published; kt-1 is free
    const float* as = smem + (kt % STAGES) * STAGE;
    const float* bs = as + TA::FLOATS;
    const int next = kt + STAGES - 1;
    if (next < ktiles) load(next % STAGES, r_begin + next * BK);
    cp_async_commit();

    // this stage's products in a fresh chain (see the header note)
    float stage_acc[MI][NJ][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) stage_acc[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t a_big[MI][4], a_small[MI][4], b_big[NJ][2], b_small[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 both
          const int pr = wm * WM + i * 16 + gid + (e & 1) * 8;
          const int kc = kk + tig + (e >> 1) * 4;
          split(A_T ? as[kc * TA::LD + pr] : as[pr * TA::LD + kc],
                a_big[i][e], a_small[i][e]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
          const int qc = wn * WN + j * 8 + gid;
          const int kc = kk + tig + e * 4;
          const float v = B_T ? bs[qc * TB::LD + kc] : bs[kc * TB::LD + qc];
          if constexpr (COLSUM) {
            if (sum_cols) csum[j] += v;
          }
          split(v, b_big[j][e], b_small[j][e]);
        }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma(stage_acc[i][j], a_small[i], b_big[j]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma(stage_acc[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma(stage_acc[i][j], a_big[i], b_big[j]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += stage_acc[i][j][e];
  }

  if constexpr (COLSUM) {
    if (sum_cols) {                      // warp-uniform
      float* out = part ? colsum_part + (size_t)blockIdx.z * q : colsum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float v = csum[j];               // lanes tig 0..3 share a column
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int cc = col0 + wn * WN + j * 8 + gid;
        if (tig == 0 && cc < q) out[cc] = v;
      }
    }
  }

  float* out = part ? part + (size_t)blockIdx.z * p * q : c;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2, c3 at row gid + 8
        const int rr = row0 + wm * WM + i * 16 + gid + (e >> 1) * 8;
        const int cc = col0 + wn * WN + j * 8 + 2 * tig + (e & 1);
        if (rr < p && cc < q) out[(size_t)rr * q + cc] = acc[i][j][e];
      }
}

// Allow `kernel` its dynamic shared memory on the current device, once
// per device (`done` is the instantiation's own bit set of devices).
inline int allow_smem(const void* kernel, int bytes,
                      std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 32 && (done.load() >> dev & 1u)) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 32) done.fetch_or(1u << dev);
  return 0;
}

template <bool A_T, bool B_T, bool COLSUM, bool VEC_A, bool VEC_B>
int launch_fixed(const float* a, const float* b, float* c, float* colsum,
                 float* work, int p, int q, int r, cudaStream_t st) {
  auto kernel = gemm_3xtf32_kernel<A_T, B_T, COLSUM, VEC_A, VEC_B>;
  constexpr int smem = STAGES * stage_floats<A_T, B_T>() * (int)sizeof(float);
  static std::atomic<unsigned> smem_set{0};
  int err = allow_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err) return err;
  const int s = splits(p, q, r);
  const int r_len = (((r + s - 1) / s + BK - 1) / BK) * BK;
  const dim3 grid((q + BMN - 1) / BMN, (p + BMN - 1) / BMN, s);
  float* part = s > 1 ? work : nullptr;
  float* colsum_part = s > 1 ? work + (size_t)s * p * q : nullptr;
  kernel<<<grid, NT, smem, st>>>(a, b, c, colsum, part, colsum_part, p, q,
                                 r, r_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (s > 1) {
    const long long total = (long long)p * q;
    const int blocks =
        (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    dense_tile::reduce_splits_kernel<<<blocks, 256, 0, st>>>(
        part, nullptr, c, p, q, s, 0);
    if (COLSUM)
      dense_tile::reduce_splits_kernel<<<(q + 255) / 256, 256, 0, st>>>(
          colsum_part, nullptr, colsum, 1, q, s, 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

inline bool aligned16(const void* v) {
  return (reinterpret_cast<uintptr_t>(v) & 15u) == 0;
}

// C (p, q) = A · B over R = r, on stream st, with the column sums of B
// (db) when COLSUM.  work holds workspace(p, q, r) floats.  Copies are 16
// bytes on an operand whose rows are a multiple of 4 floats and whose
// pointer is 16-byte aligned.  Returns the first CUDA error, 0 when every
// launch was accepted.
template <bool A_T, bool B_T, bool COLSUM>
int launch(const float* a, const float* b, float* c, float* colsum,
           float* work, int p, int q, int r, cudaStream_t st) {
  const bool va = (A_T ? p : r) % 4 == 0 && aligned16(a);
  const bool vb = (B_T ? r : q) % 4 == 0 && aligned16(b);
  auto go = [&](auto fixed) {
    return fixed(a, b, c, colsum, work, p, q, r, st);
  };
  if (va && vb) return go(launch_fixed<A_T, B_T, COLSUM, true, true>);
  if (va) return go(launch_fixed<A_T, B_T, COLSUM, true, false>);
  if (vb) return go(launch_fixed<A_T, B_T, COLSUM, false, true>);
  return go(launch_fixed<A_T, B_T, COLSUM, false, false>);
}

// g = dy ⊙ [y > 0] (a product, not a select, as the reference writes it)
__global__ void __launch_bounds__(256)
relu_mask_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                 float* __restrict__ g, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    g[i] = dy[i] * (y[i] > 0.f ? 1.f : 0.f);
}

// relu_mask_kernel over n floats on stream st
inline int launch_relu_mask(const float* dy, const float* y, float* g,
                            long long n, cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  relu_mask_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      dy, y, g, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm3
