// The tensor-core GEMM tile of every dense kernel of the port, for Hopper
// (sm_90a), float32-accurate through a 3xTF32 split: the dense layer's
// forward and its two backward kernels (dense_train.cu: dense_forward_f32,
// dense_dx_f32, dense_dw_db_f32) and the whole-MLP forward
// (mlp_forward.cu: mlp_forward_f32).
//
//   C (P, Q) = sum over r of A(p, r) * B(r, q)
//
// Replaces, with those two sources, the Pallas kernels of
// src/repro/kernels/fused_mlp.py:
//   forward (`_fused_dense_kernel`, :71; `_mlp_kernel`, :273, a layer at a
//   time): y = [relu](x · W + b): A = x, stored (P, R) = (M, K); B = W,
//   stored (R, Q) = (K, N); + b and ReLU in the epilogue (BIAS)
//   dx (`_dx_kernel`, :121) = g · Wᵀ: A = g, stored (P, R) = (M, N);
//                         B(r, q) = W(q, r)
//   dW (`_dw_db_kernel`, :143) = xᵀ · g: A(p, r) = x(r, p), stored (R, P);
//                         B = g (R, Q); db (N) = Σ_M g summed in the same
//                         pass (COLSUM)
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
// is NaN, so the product is NaN where the plain one is ±inf, and the
// epilogue's ReLU keeps a NaN as torch.relu does (G's and D's inputs are
// finite; chip_smoke.py asserts finite outputs).
//
// What bounds it: operations at the wide layers.  Three TF32 products of
// 2·P·Q·R flops each at the card's 495 TFLOP/s: a hidden layer of
// Algorithm 1 (1024 x 2048 x 2048, 8.6 GFLOP a product) takes at least
// 0.052 ms, against 0.013 ms to move its ~42 MB once.  The narrow layers,
// and the whole MLP at 64 rows (16.8 MB of W a hidden layer), are bound
// by their bytes.
//
// Design.  mma.sync.m16n8k8 tf32 (wgmma reads B only from shared memory,
// so a split B would be staged twice, and tf32 wgmma takes only K-major
// operands: both of dW's are M-major, and the forward's W is N-major).  A
// block computes a BM x 128 tile of C with warps of 64 x 32: 8 warps at
// BM = 128, 4 at BM = 64 (WARPS_M = 1, for the whole MLP at 64 rows,
// where a 128-row tile would leave half its rows empty).  R is staged 32
// at a time through a 3-stage cp.async ring, so the next two slices are in
// flight while one is multiplied.  Each operand tile is stored in its
// global layout: rows along R padded to 36 floats, rows along P or Q
// padded to the tile's width + 8, which makes every fragment read
// conflict-free.  The tensor cores round toward zero as they add into
// their float32 accumulator, so one chain of mma's over R = 2048 drifts
// one way (1e-5 of scale on the card, 10x the float32 product's error);
// each stage's 12 mma's run in a fresh chain that is added to the
// accumulators with round-to-nearest float32 adds, which brings the error
// back to the float32 product's.  A row of C is computed the same way
// whatever tile, block or batch it is in: its bits depend only on the
// R slices, which the caller fixes.  Copies are 16 bytes where the
// operand's rows are 16-byte aligned (VEC_A / VEC_B, chosen by the
// launcher from the widths and pointers), else 4 bytes; the ragged edge
// is zero-filled through cp.async's src-size operand, with no branch in
// the inner loop.  The ReLU mask cannot ride a cp.async, and staging y's
// tile beside dy's (a third more bytes through L2, and a masking pass
// over shared memory before each barrier) was slower than one elementwise
// pass: relu_mask_kernel writes g = dy ⊙ [y > 0] to the caller's
// workspace and the GEMM reads g.  Each dy element is multiplied once by
// 1.0 or 0.0.
// db is summed from the raw g fragments by the warps of the first row of
// warps in the blocks of the first row tile, then across the 4 lanes that
// share a column: a fixed order.  A call may split R into slices (the
// caller's count: splits() for the dense kernels, from the shape; the
// whole MLP's from R alone); the slices write partial tiles (and partial
// db) to the caller's workspace and reduce_splits_kernel sums them in
// slice order, then adds the bias and applies ReLU (BIAS).  Or (FOLD)
// one block walks every slice of R itself, sums each on its own and adds
// it to a running total kept in shared memory, in slice order: the same
// float32 operations as the split and its reduction, so the same bits,
// without the partial tiles' round trip through device memory (the whole
// MLP at a batch whose tiles fill the card).  Unsplit, the tile's
// epilogue adds the bias to the full sum and applies ReLU, in the order
// of `_fused_dense_kernel`'s epilogue.  No atomics: two calls give the
// same bits.  Everything here has internal linkage, so each library that
// includes it keeps its own copy (a template's static, such as
// launch_fixed's record of the devices it has set up, would otherwise be
// one object across the libraries a process loads).
//
// Left for later: wgmma + TMA for the K-major case (dx; the forward's W
// would need a K-major staging), and a persistent grid that overlaps one
// tile's epilogue with the next one's loads.
#pragma once
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace gemm3 {
namespace {

constexpr int BN = 128;         // C tile columns
constexpr int BK = 32;          // R staged per pipeline stage
constexpr int STAGES = 3;       // cp.async ring depth
constexpr int WARPS_N = 4;      // warps along Q
constexpr int WM = 64;          // rows a warp
constexpr int WN = BN / WARPS_N;            // 32 columns a warp
constexpr int MI = WM / 16;                 // m16 fragments a warp
constexpr int NJ = WN / 8;                  // n8 fragments a warp
constexpr int NUM_SMS = 132;
constexpr int SPLIT_R = 128;    // least R a slice takes once R is split
constexpr int MAX_SPLITS = 16;

// What a call computes besides C = A · B: nothing, B's column sums
// (db), or c = [relu](A · B + bias) (the forward)
enum Extra { NONE, COLSUM, BIAS };

// The block of WARPS_M x WARPS_N warps: BM = 64·WARPS_M rows, NT threads
template <int WARPS_M>
struct Block {
  static constexpr int BM = WM * WARPS_M;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
};

// An operand's tile in shared memory, PQ wide along P or Q, stored as it
// is in global memory: R_CONTIG (rows along P or Q, R contiguous) or rows
// along R.
template <bool R_CONTIG, int PQ>
struct Tile {
  static constexpr int ROWS = R_CONTIG ? PQ : BK;
  static constexpr int COLS = R_CONTIG ? BK : PQ;
  static constexpr int LD = R_CONTIG ? BK + 4 : PQ + 8;   // bank padding
  static constexpr int FLOATS = ROWS * LD;
};

// R slices for a C (p, q) with reduction r, at BM = 128: as many as keep
// one wave of blocks on the card, each at least SPLIT_R long.  Shapes
// alone decide.
inline int splits(int p, int q, int r) {
  constexpr int BM = Block<2>::BM;
  const long long tiles = (long long)((p + BM - 1) / BM) * ((q + BN - 1) / BN);
  long long s = NUM_SMS / tiles;
  s = s < r / SPLIT_R ? s : r / SPLIT_R;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  return s < 1 ? 1 : (int)s;
}

// Floats of workspace a call with s slices needs: partial tiles and
// partial column sums.
inline long long split_floats(int p, int q, int s) {
  return s > 1 ? (long long)s * ((long long)p * q + q) : 0;
}

// Workspace of a call split by splits(p, q, r)
inline long long workspace(int p, int q, int r) {
  return split_floats(p, q, splits(p, q, r));
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

// The copies of one tile that each of NT threads makes: copy i covers W
// floats at (row, col) of the tile.
template <bool R_CONTIG, int PQ, bool VEC, int NT>
struct Copies {
  static constexpr int W = VEC ? 4 : 1;
  static constexpr int PER_ROW = Tile<R_CONTIG, PQ>::COLS / W;
  static constexpr int N = Tile<R_CONTIG, PQ>::ROWS * PER_ROW / NT;
  __device__ static void at(int i, int& row, int& col) {
    const int c = threadIdx.x + i * NT;
    row = c / PER_ROW;
    col = (c % PER_ROW) * W;
  }
};

// Copy i of this thread's share of a tile (see stage_tile).
template <bool R_CONTIG, int PQ, bool VEC, int NT>
__device__ __forceinline__ void stage_copy(float* s,
                                           const float* __restrict__ g,
                                           int pq_n, int r_n, int pq0, int r0,
                                           int r_end, int i) {
  int row, col;
  Copies<R_CONTIG, PQ, VEC, NT>::at(i, row, col);
  const int gpq = pq0 + (R_CONTIG ? row : col);
  const int gr = r0 + (R_CONTIG ? col : row);
  const bool ok = gpq < pq_n && gr < r_end;
  const float* src =
      ok ? g + (R_CONTIG ? (size_t)gpq * r_n + gr : (size_t)gr * pq_n + gpq)
         : g;
  cp_async(s + row * Tile<R_CONTIG, PQ>::LD + col, src, VEC, ok);
}

// Stage the tile at (pq0, r0) of an operand that is pq_n wide along P or
// Q and r_n along R, zero past pq_n and past r_end.  R_CONTIG: stored
// (pq_n, r_n) row-major; else stored (r_n, pq_n).  The copies of a
// 16-byte tile are unrolled; those of a 4-byte tile are not (unrolled,
// their source addresses would stay live across the whole reduction loop
// and push the kernel past 255 registers).
template <bool R_CONTIG, int PQ, bool VEC, int NT>
__device__ __forceinline__ void stage_tile(float* s,
                                           const float* __restrict__ g,
                                           int pq_n, int r_n, int pq0, int r0,
                                           int r_end) {
  constexpr int N = Copies<R_CONTIG, PQ, VEC, NT>::N;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      stage_copy<R_CONTIG, PQ, VEC, NT>(s, g, pq_n, r_n, pq0, r0, r_end, i);
  } else {
#pragma unroll 1
    for (int i = 0; i < N; ++i)
      stage_copy<R_CONTIG, PQ, VEC, NT>(s, g, pq_n, r_n, pq0, r0, r_end, i);
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

// ReLU that keeps a NaN, as torch.relu and jnp.maximum(·, 0) do
__device__ __forceinline__ float relu_f(float v) { return v < 0.f ? 0.f : v; }

template <bool A_T, bool B_T, int WARPS_M>
__host__ __device__ constexpr int stage_floats() {
  return Tile<!A_T, Block<WARPS_M>::BM>::FLOATS + Tile<B_T, BN>::FLOATS;
}

// Floats of dynamic shared memory: the ring, and under FOLD each
// thread's running total
template <bool A_T, bool B_T, int WARPS_M, bool FOLD>
constexpr int smem_floats() {
  return STAGES * stage_floats<A_T, B_T, WARPS_M>() +
         (FOLD ? MI * NJ * 4 * Block<WARPS_M>::NT : 0);
}

// One slice of C = A · B (see the header note).  A_T false: A stored
// (P, R); true: stored (R, P).  B_T false: B stored (R, Q); true: stored
// (Q, R).  part == nullptr: the full R in one slice (FOLD: every slice of
// r_len, folded in order), written to c (BIAS: [relu](sum + bias);
// COLSUM: the column sums to colsum); otherwise the raw sums to
// part[blockIdx.z] (and colsum_part[blockIdx.z]).
template <bool A_T, bool B_T, Extra X, int WARPS_M, bool FOLD, bool VEC_A,
          bool VEC_B>
__global__ void __launch_bounds__(Block<WARPS_M>::NT, 1)
gemm_3xtf32_kernel(const float* __restrict__ a,
                   const float* __restrict__ b,
                   const float* __restrict__ bias, float* __restrict__ c,
                   float* __restrict__ colsum, float* __restrict__ part,
                   float* __restrict__ colsum_part, int p, int q, int r,
                   int r_len, int relu) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = Block<WARPS_M>::BM;
  constexpr int NT = Block<WARPS_M>::NT;
  using TA = Tile<!A_T, BM>;
  using TB = Tile<B_T, BN>;
  constexpr int STAGE = stage_floats<A_T, B_T, WARPS_M>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int r_begin = FOLD ? 0 : blockIdx.z * r_len;
  const int r_end = FOLD ? r : min(r, r_begin + r_len);
  const int ktiles = r_end > r_begin ? (r_end - r_begin + BK - 1) / BK : 0;
  const bool sum_cols = X == COLSUM && blockIdx.y == 0 && wm == 0;

  auto load = [&](int stage, int r0) {
    float* s = smem + stage * STAGE;
    stage_tile<!A_T, BM, VEC_A, NT>(s, a, p, r, row0, r0, r_end);
    stage_tile<B_T, BN, VEC_B, NT>(s + TA::FLOATS, b, q, r, col0, r0, r_end);
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

  // FOLD: this thread's running total over the slices done, value v at
  // tot[v * NT] (a thread's own words, so no barrier guards them)
  float* tot = smem + STAGES * STAGE + threadIdx.x;
  const int slice_tiles = r_len / BK;
  auto fold = [&](bool first) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& t = tot[((i * NJ + j) * 4 + e) * NT];
          t = first ? acc[i][j][e] : t + acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
  };

  for (int kt = 0; kt < ktiles; ++kt) {
    if constexpr (FOLD) {
      if (kt > 0 && kt % slice_tiles == 0) fold(kt == slice_tiles);
    }
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
          if constexpr (X == COLSUM) {
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
  if constexpr (FOLD) {                  // the last slice onto the total
    if (ktiles > slice_tiles) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += tot[((i * NJ + j) * 4 + e) * NT];
    }
  }

  if constexpr (X == COLSUM) {
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
        if (rr >= p || cc >= q) continue;
        float v = acc[i][j][e];
        if constexpr (X == BIAS) {
          if (!part) {
            v += bias[cc];
            if (relu) v = relu_f(v);
          }
        }
        out[(size_t)rr * q + cc] = v;
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
    c[i] = relu ? relu_f(v) : v;
  }
}

// reduce_splits_kernel over a (p, q) output on stream st
inline void launch_reduce(const float* part, const float* bias, float* c,
                          int p, int q, int splits, int relu,
                          cudaStream_t st) {
  const long long blocks = ((long long)p * q + 255) / 256;
  reduce_splits_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      part, bias, c, p, q, splits, relu);
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

// One call of the tile: C (p, q) = A · B over R = r in `splits` slices,
// work holding split_floats(p, q, splits) floats when splits > 1 (and
// the slices are not folded in the block).
struct Gemm {
  const float* a;
  const float* b;
  float* c;
  int p, q, r;
  int splits;
  float* work;
  const float* bias = nullptr;  // BIAS: c = [relu](A · B + bias)
  int relu = 0;
  float* colsum = nullptr;      // COLSUM: colsum (q) = Σ_r B(r, q)
};

template <bool A_T, bool B_T, Extra X, int WARPS_M, bool FOLD, bool VEC_A,
          bool VEC_B>
int launch_fixed(const Gemm& g, cudaStream_t st) {
  auto kernel =
      gemm_3xtf32_kernel<A_T, B_T, X, WARPS_M, FOLD, VEC_A, VEC_B>;
  constexpr int smem =
      smem_floats<A_T, B_T, WARPS_M, FOLD>() * (int)sizeof(float);
  static std::atomic<unsigned> smem_set{0};
  int err = allow_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err) return err;
  const int s = g.splits;
  const int r_len = (((g.r + s - 1) / s + BK - 1) / BK) * BK;
  const bool in_grid = !FOLD && s > 1;   // slices split across the grid
  constexpr int BM = Block<WARPS_M>::BM;
  const dim3 grid((g.q + BN - 1) / BN, (g.p + BM - 1) / BM, in_grid ? s : 1);
  float* part = in_grid ? g.work : nullptr;
  float* colsum_part = in_grid ? g.work + (size_t)s * g.p * g.q : nullptr;
  kernel<<<grid, Block<WARPS_M>::NT, smem, st>>>(
      g.a, g.b, g.bias, g.c, g.colsum, part, colsum_part, g.p, g.q, g.r,
      r_len, g.relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (in_grid) {
    launch_reduce(part, g.bias, g.c, g.p, g.q, s, g.relu, st);
    if (X == COLSUM)
      launch_reduce(colsum_part, nullptr, g.colsum, 1, g.q, s, 0, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

inline bool aligned16(const void* v) {
  return (reinterpret_cast<uintptr_t>(v) & 15u) == 0;
}

// Launch one call on stream st: a grid of BM x 128 tiles (WARPS_M), its
// R slices split across the grid or folded in each block (FOLD).  Copies
// are 16 bytes on an operand whose rows are a multiple of 4 floats and
// whose pointer is 16-byte aligned.  Returns the first CUDA error, 0 when
// every launch was accepted.
template <bool A_T, bool B_T, Extra X, int WARPS_M = 2, bool FOLD = false>
int launch(const Gemm& g, cudaStream_t st) {
  const bool va = (A_T ? g.p : g.r) % 4 == 0 && aligned16(g.a);
  const bool vb = (B_T ? g.r : g.q) % 4 == 0 && aligned16(g.b);
  if (va && vb)
    return launch_fixed<A_T, B_T, X, WARPS_M, FOLD, true, true>(g, st);
  if (va) return launch_fixed<A_T, B_T, X, WARPS_M, FOLD, true, false>(g, st);
  if (vb) return launch_fixed<A_T, B_T, X, WARPS_M, FOLD, false, true>(g, st);
  return launch_fixed<A_T, B_T, X, WARPS_M, FOLD, false, false>(g, st);
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

}  // namespace
}  // namespace gemm3
