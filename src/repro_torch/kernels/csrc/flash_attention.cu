// GQA flash-attention forward for Hopper (sm_90a) on the tensor cores,
// float32 or bf16 in, float32-accurate arithmetic, output in q's type:
//
//   o[b, h, i] = softmax_j(q[b, h, i] · k[b, h / g, j] * scale + mask) · v[b, h / g]
//
// With a non-null `lse` (the LSE instantiations) it also writes each
// row's log-sum-exp of its scaled, masked scores, m + log(max(l, 1e-30)):
// the residual the reference's custom VJP keeps from `_flash_fwd_impl`
// (src/repro/nn/attention.py:180) for its backward, which the port's
// autograd Function (nn/attention.py) runs in torch ops.
//
// Replaces the Pallas kernel `_flash_kernel` (src/repro/kernels/
// flash_attention.py:32, public `flash_attention`).  Its grid (batch, q
// head, q block, kv block) runs the kv axis in order on one TPU core and
// carries the online-softmax state (acc, m, l) in VMEM scratch from one
// grid step to the next; it upcasts q, k and v to float32 and takes P·V in
// float32.  Here one block owns one 64-row q tile of one q head and walks
// the kv axis itself, keeping m, l and the output rows in registers; kv
// head h / g is read in place (no replicated K/V).
//
// Masks, exactly as the TPU kernel writes them: query row i sits at
// absolute position q_offset + i; a key at kpos is kept when
// (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window), and a
// masked score is the finite -1e30 (with -inf a fully masked row of a tile
// would give inf - inf = NaN; with -1e30 its p = exp(0) = 1 is washed out
// by alpha = exp(-1e30 - m) = 0 at the next unmasked tile).  Key tiles
// outside the band (k_lo > q_hi when causal, k_hi <= q_lo - window) are
// never visited.  Lengths no tile divides are masked at the edges: rows
// past Sq are not written, keys past Sk get p = 0 and zero K/V.  The q
// tiles with the most causal work are scheduled first.
//
// Design (FlashAttention-2's layout on mma.sync).  A block holds 64 q
// rows in 4 row blocks of 16; a warp computes S = Q·Kᵀ for its 16 rows
// and a tile of BK keys in registers (mma accumulator fragments: a thread
// holds rows gid and gid + 8, keys 2·tig and 2·tig + 1 of each 8-key
// n-tile), scales and masks it there (tiles inside the band for the
// warp's rows skip the mask), takes the row max and sum across the 4
// lanes of a quad (__shfl_xor 1, 2) and forms P = exp(S - m) with expf, in
// registers.  O += P·V then reads P straight from those registers as the
// A operand, with no shuffle and no trip through shared memory:
//   - float32 in, m16n8k8 TF32: an A fragment wants k = tig and tig + 4,
//     the accumulator holds keys 2·tig and 2·tig + 1.  The sum over keys
//     may take them in any order, so logical k = t stands for key 2t (t <
//     4) or 2(t - 4) + 1, and V's B fragment is read in that same order
//     (rows 2·tig and 2·tig + 1 of the tile).
//   - bf16 in, m16n8k16: the accumulator of two 8-key n-tiles is already
//     the A fragment of one 16-key k-step; V's B fragment comes from
//     ldmatrix .trans, K's and Q's from ldmatrix.
// Precision, the reference's float32 contract:
//   - float32: every product is 3xTF32 through gemm_3xtf32.cuh's split
//     (big = x rounded to TF32, small = x - big; small·big, big·small,
//     big·big, small·small dropped), for Q·Kᵀ and for P·V.  The tensor
//     cores round toward zero as they add into their accumulator, so no
//     chain of mma's runs long: S is summed in 32-wide d stages, each a
//     fresh chain added to S with a float32 add, and each 8 output columns
//     of P·V over one key tile are a fresh chain added to O the same way.
//   - bf16: products of bf16 values are exact, so S = Q·Kᵀ accumulates in
//     float32 directly.  P is not rounded to bf16 once (that would be a
//     precision opt-in): it is split into bf16 hi + lo, ~16 bits, and
//     P·V is lo·V + hi·V with V exact in bf16, in the same short chains.
//   The softmax, alpha, l and the final divide are float32 as before.
// K and V are staged by cp.async into one buffer each, in turn: V_j loads
// while S_j is computed and K_{j+1} while P_j·V_j is, so each load hides
// behind the other product.  In float32 each thread splits the K and V
// elements it copied into TF32 big and small once, in shared memory
// (every warp would otherwise split every element again); Q's fragments
// are split as they are read.  Rows are padded (4 floats, 8 bf16) so
// every fragment read is free of bank conflicts.  No atomics: two calls
// give the same bits.  Head dims 16, 32, 64, 128, 256 (a template
// parameter).
//
// Registers (255 a thread; chip_smoke.py asserts no spills in any of the
// 20 instantiations, 10 with the lse store and 10 without).  At D = 256 the output rows alone are 16 x 256 / 32 =
// 128 floats a thread:
//   - float32 at D = 256 splits D across 2 warps per row block (DS = 2, 8
//     warps): each keeps 128 output columns and sums Q·Kᵀ over its half of
//     d; the two halves of S meet in shared memory (XS), both warps add
//     them in the same order and run the same softmax.  One warp holding
//     all 256 columns needs every register and ran 1.5x slower.
//   - bf16 at D = 256 keeps one warp per row block (DS = 1): the exchange
//     cost more than it saved (1.01 against 0.77 ms at gemma3's global
//     layer).  32-key tiles (S and the split P 16 registers each; 64-key
//     tiles run no faster), and Q·Kᵀ's 16 k-steps unrolled 8 at a time
//     (fully unrolled, the loads hoisted ahead of their use have spilled
//     in builds of this source that differed only slightly).
//   - O is rescaled only when some row's max moved; that branch also
//     decides whether ptxas fits bf16 at D = 256 into 255 registers.
// Shared memory: float32 at D = 256 64 x 260 floats of Q, 4 x 32 x 260 of
// split K and V, 16 KB of XS: 211 KB, one block an SM; bf16 at D = 256 66
// KB, two blocks (by registers).
//
// What bounds it: the tensor cores.  Per kept (query, key) pair it does
// 4·D flops of products; three TF32 products of each (float32: 12·D at
// 495 TFLOP/s) or one for Q·Kᵀ and two for P·V (bf16: 6·D at 989
// TFLOP/s).  At gemma3's global layer (2 x 4 heads x 4096·4097/2 kept
// pairs, D = 256) that is 0.417 ms (float32) and 0.104 ms (bf16), against
// 25 MB of q, k, v and o (~8 us at 3.35 TB/s).  mma.sync reaches only
// part of those rates (wgmma with TMA is later work, for the reasons
// gemm_3xtf32.cuh gives); with 8 warps an SM the kernel is bound by
// latency more than by either pipe (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "gemm_3xtf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// The tiles of one (T, D): BQ q rows a block in RB row blocks of 16; DS
// warps share each row block, each taking DH = D / DS output columns and
// D / DS of Q·Kᵀ's sum (the partial sums are exchanged through XS floats
// of shared memory); BK keys a tile; P·V in independent chains of JG
// 8-column n-tiles; a shared row pitch of LD elements; float32 keeps K
// and V split into TF32 big and small (KV = 2 copies)
template <typename T, int D>
struct Geo {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BQ = 64;
  static constexpr int DS = (F32 && D == 256) ? 2 : 1;
  static constexpr int BK = D >= 128 ? 32 : 64;
  static constexpr int JG = (F32 || D == 16) ? 2 : 4;
  static constexpr int RB = BQ / 16;
  static constexpr int NW = RB * DS;
  static constexpr int NT = 32 * NW;
  static constexpr int DH = D / DS;
  static constexpr int LD = D + (F32 ? 4 : 8);
  static constexpr int CHUNK = 16 / static_cast<int>(sizeof(T));
  static constexpr int KV = F32 ? 2 : 1;
  static constexpr int XS = DS > 1 ? NW * BK * 16 : 0;
  static constexpr int BYTES =
      (BQ + 2 * KV * BK) * LD * static_cast<int>(sizeof(T)) + 4 * XS;
};

struct Strides {                  // element strides; the last dim is contiguous
  long long b, h, s;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// A thread's share of a ROWS x D tile: 16-byte copies at rows row0 + i·R
// (i < N), column col, for every thread the same
template <typename T, int D, int ROWS>
struct Copies {
  using G = Geo<T, D>;
  static constexpr int C = D / G::CHUNK;      // copies a row
  static_assert(G::NT % C == 0 && ROWS % (G::NT / C) == 0,
                "copies must divide among the threads");
  static constexpr int R = G::NT / C;         // rows apart
  static constexpr int N = ROWS / R;          // copies a thread
  int row0, col;
  __device__ Copies()
      : row0(threadIdx.x / C), col(threadIdx.x % C * G::CHUNK) {}
};

// ROWS rows of D from src (row stride rs) into dst[row][LD]; rows at or
// past n_valid are zero-filled
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      long long rs, int n_valid) {
  using CP = Copies<T, D, ROWS>;
  const CP cp;
  T* d = dst + cp.row0 * Geo<T, D>::LD + cp.col;
  const T* g = src + cp.row0 * rs + cp.col;
#pragma unroll
  for (int i = 0; i < CP::N; ++i) {
    const bool ok = cp.row0 + i * CP::R < n_valid;
    cp_async16(d + i * CP::R * Geo<T, D>::LD, ok ? g : src, ok);
    g += CP::R * rs;
  }
}

// float32: split this thread's own copies of a staged tile (visible to it
// once its cp.async group has completed) into TF32 big, in place, and
// small, at the same offset of `small`
template <int D, int ROWS>
__device__ __forceinline__ void split_tile(float* big, float* small) {
  using CP = Copies<float, D, ROWS>;
  const CP cp;
  const int off0 = cp.row0 * Geo<float, D>::LD + cp.col;
#pragma unroll
  for (int i = 0; i < CP::N; ++i) {
    const int off = off0 + i * CP::R * Geo<float, D>::LD;
    const float4 x = *reinterpret_cast<const float4*>(big + off);
    uint32_t b[4], s[4];
    gemm3::split(x.x, b[0], s[0]);
    gemm3::split(x.y, b[1], s[1]);
    gemm3::split(x.z, b[2], s[2]);
    gemm3::split(x.w, b[3], s[3]);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) =
        make_uint4(s[0], s[1], s[2], s[3]);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) = hi + lo, each a packed bf16 pair (x0 in the low half)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// S (16 rows from row_w, BK keys) over d in [d0, d0 + DH), float32:
// 3xTF32 in 32-wide d stages, each a fresh mma chain added to S in
// float32; K comes split (k_big, k_small)
template <int D, int BK, int DH>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const float* q_s, const float* k_big,
                                       const float* k_small, int row_w,
                                       int d0, int lane) {
  constexpr int LD = Geo<float, D>::LD;
  const int gid = lane >> 2, tig = lane & 3;
  zero(s);
#pragma unroll
  for (int ds = 0; ds < DH; ds += 32) {
    float st[BK / 8][4];
    zero(st);
#pragma unroll
    for (int kk = 0; kk < (DH < 32 ? DH : 32); kk += 8) {
      const int dc = d0 + ds + kk;
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)         // a (gid | gid + 8, tig | tig + 4)
        gemm3::split(q_s[(row_w + gid + (e & 1) * 8) * LD + dc + tig +
                         (e >> 1) * 4],
                     ab[e], as[e]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {  // b (k = tig | tig + 4, n = gid)
        const int off = (8 * j + gid) * LD + dc + tig;
        const uint32_t bb[2] = {bits(k_big[off]), bits(k_big[off + 4])};
        const uint32_t bs[2] = {bits(k_small[off]), bits(k_small[off + 4])};
        gemm3::mma(st[j], as, bb);
        gemm3::mma(st[j], ab, bs);
        gemm3::mma(st[j], ab, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += st[j][e];
  }
}

// S over d in [d0, d0 + DH), bf16: exact products accumulated in float32
template <int D, int BK, int DH>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const __nv_bfloat16* q_s,
                                       const __nv_bfloat16* k_s,
                                       const __nv_bfloat16*, int row_w,
                                       int d0, int lane) {
  constexpr int LD = Geo<__nv_bfloat16, D>::LD;
  const int r = lane & 7, mi = lane >> 3;
  zero(s);
#pragma unroll 8  // bf16 k-steps
  for (int kk = 0; kk < DH; kk += 16) {
    uint32_t a[4];                        // rows +0 | +8, d +0 | +8
    ldsm_x4(a, q_s + (row_w + r + (mi & 1) * 8) * LD + d0 + kk +
                   (mi >> 1) * 8);
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {
      uint32_t b[4];                      // keys 8j | 8j + 8, d +0 | +8
      ldsm_x4(b, k_s + (8 * j + r + (mi >> 1) * 8) * LD + d0 + kk +
                     (mi & 1) * 8);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

// O (DH columns from d0) += P·V over one key tile, float32: 3xTF32 with
// V split (v_big, v_small); logical k = t is key 2t (t < 4) or 2(t - 4) +
// 1 of each 8-key step, so the A fragment is the S accumulator as it
// stands; each 8 columns a fresh chain
template <int D, int BK, int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 8][4],
                                   const float (&p)[BK / 8][4],
                                   const float* v_big, const float* v_small,
                                   int d0, int lane) {
  constexpr int LD = Geo<float, D>::LD;
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    // a0 (gid, key 2tig), a1 (gid + 8, 2tig), a2 (gid, 2tig + 1), a3
    gemm3::split(p[kk][0], pb[kk][0], ps[kk][0]);
    gemm3::split(p[kk][2], pb[kk][1], ps[kk][1]);
    gemm3::split(p[kk][1], pb[kk][2], ps[kk][2]);
    gemm3::split(p[kk][3], pb[kk][3], ps[kk][3]);
  }
  constexpr int JG = Geo<float, D>::JG;
#pragma unroll
  for (int jd = 0; jd < DH / 8; jd += JG) {
    float t[JG][4];
    zero(t);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        // b (key 2tig | 2tig + 1, n = gid)
        const int off = (8 * kk + 2 * tig) * LD + d0 + 8 * (jd + jj) + gid;
        const uint32_t bb[2] = {bits(v_big[off]), bits(v_big[off + LD])};
        const uint32_t bs[2] = {bits(v_small[off]), bits(v_small[off + LD])};
        gemm3::mma(t[jj], ps[kk], bb);
        gemm3::mma(t[jj], pb[kk], bs);
        gemm3::mma(t[jj], pb[kk], bb);
      }
#pragma unroll
    for (int jj = 0; jj < JG; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd + jj][e] += t[jj][e];
  }
}

// O += P·V over one key tile, bf16: P = hi + lo, lo·V then hi·V; V's B
// fragments by ldmatrix .trans, two 8-column n-tiles at a time, each a
// fresh chain
template <int D, int BK, int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 8][4],
                                   const float (&p)[BK / 8][4],
                                   const __nv_bfloat16* v_s,
                                   const __nv_bfloat16*, int d0, int lane) {
  constexpr int LD = Geo<__nv_bfloat16, D>::LD;
  const int r = lane & 7, mi = lane >> 3;
  uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // a0 = n-tile 2kk rows gid, a1 its rows gid + 8, a2 and a3 n-tile 2kk + 1
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[kk][0], lo[kk][0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[kk][1], lo[kk][1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
  constexpr int JG = Geo<__nv_bfloat16, D>::JG;
#pragma unroll
  for (int jd = 0; jd < DH / 8; jd += JG) {
    float t[JG][4];
    zero(t);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < JG; jj += 2) {
        uint32_t b[4];                    // keys +0 | +8, columns +0 | +8
        ldsm_x4_t(b, v_s + (16 * kk + r + (mi & 1) * 8) * LD + d0 +
                         8 * (jd + jj) + (mi >> 1) * 8);
        mma_bf16(t[jj], lo[kk], b[0], b[1]);
        mma_bf16(t[jj], hi[kk], b[0], b[1]);
        mma_bf16(t[jj + 1], lo[kk], b[2], b[3]);
        mma_bf16(t[jj + 1], hi[kk], b[2], b[3]);
      }
#pragma unroll
    for (int jj = 0; jj < JG; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd + jj][e] += t[jj][e];
  }
}

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(Geo<T, D>::NT, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int g, int sq, int sk, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal, int window,
                 int q_offset, float scale) {
  using G = Geo<T, D>;
  constexpr int BQ = G::BQ, BK = G::BK, NS = BK / 8, DH = G::DH;
  constexpr bool F32 = G::F32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);    // [BQ][LD]
  T* k_s = q_s + BQ * G::LD;                  // [BK][LD] (float32: big)
  T* v_s = k_s + G::KV * BK * G::LD;          // [BK][LD] (float32: big)
  T* k_lo = k_s + BK * G::LD;                 // float32: small
  T* v_lo = v_s + BK * G::LD;
  float* xs = reinterpret_cast<float*>(v_s + G::KV * BK * G::LD);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rb = warp % G::RB;                // row block
  const int d0 = (warp / G::RB) * DH;         // this warp's columns
  // the heaviest causal tiles (largest q) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z, hk = hh / g;
  const T* qb = q + bb * qs.b + hh * qs.h;
  const T* kb = k + bb * ks.b + hk * ks.h;
  const T* vb = v + bb * vs.b + hk * vs.h;
  T* ob = o + bb * os.b + hh * os.h;

  // the band of key tiles this q tile can see
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, sq) - 1;
  int j_begin = 0, j_end = (sk + BK - 1) / BK;
  if (causal) j_end = min(j_end, q_hi / BK + 1);            // k_lo <= q_hi
  if (window > 0 && q_lo - window + 1 > 0)                  // k_hi > q_lo - w
    j_begin = (q_lo - window + 1) / BK;

  stage<T, D, BQ>(q_s, qb + q0 * qs.s, qs.s, sq - q0);
  if (j_begin < j_end)
    stage<T, D, BK>(k_s, kb + j_begin * BK * ks.s, ks.s, sk - j_begin * BK);
  gemm3::cp_async_commit();

  const int row_w = rb * 16;                  // the warp's rows in the tile
  const int w_lo = q_lo + row_w;              // their first position
  const int qpos0 = w_lo + gid;               // this thread's: +0 and +8
  float acc[DH / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  zero(acc);

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    gemm3::cp_async_wait<0>();                // this thread's K_j landed
    if constexpr (F32) split_tile<D, BK>(k_s, k_lo);
    __syncthreads();                          // K_j in; V_{j-1} read by all
    stage<T, D, BK>(v_s, vb + k0 * vs.s, vs.s, sk - k0);
    gemm3::cp_async_commit();

    float s[NS][4];
    scores<D, BK, DH>(s, q_s, k_s, k_lo, row_w, d0, lane);
    if constexpr (G::DS > 1) {                // S = the row block's parts
      float4* x4 = reinterpret_cast<float4*>(xs) + lane;
#pragma unroll
      for (int jn = 0; jn < NS; ++jn)
        x4[(warp * NS + jn) * 32] =
            make_float4(s[jn][0], s[jn][1], s[jn][2], s[jn][3]);
      __syncthreads();
#pragma unroll
      for (int jn = 0; jn < NS; ++jn) {
        float4 t = x4[(rb * NS + jn) * 32];
#pragma unroll
        for (int h = 1; h < G::DS; ++h) {     // in order of the parts
          const float4 u = x4[((rb + h * G::RB) * NS + jn) * 32];
          t = make_float4(t.x + u.x, t.y + u.y, t.z + u.z, t.w + u.w);
        }
        s[jn][0] = t.x, s[jn][1] = t.y, s[jn][2] = t.z, s[jn][3] = t.w;
      }
    }

    // scale, mask (tiles that cross the band's or Sk's edge for this
    // warp's rows), online softmax over the quad that shares a row
    const bool inner = k0 + BK <= sk && (!causal || k0 + BK - 1 <= w_lo) &&
                       (window <= 0 || w_lo + 15 - k0 < window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int jn = 0; jn < NS; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qpos0 + (e >> 1) * 8;
        const int kpos = k0 + 8 * jn + 2 * tig + (e & 1);
        const bool keep = inner || (kpos < sk && (!causal || qpos >= kpos) &&
                                    (window <= 0 || qpos - kpos < window));
        s[jn][e] = keep ? s[jn][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = expf(m[hf] - m_new);
      m[hf] = m_new;
    }
#pragma unroll
    for (int jn = 0; jn < NS; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * jn + 2 * tig + (e & 1);
        s[jn][e] = inner || kpos < sk ? expf(s[jn][e] - m[e >> 1]) : 0.f;
        psum[e >> 1] += s[jn][e];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + psum[hf];
    // O rescales only when a row's max moved (alpha = 1 leaves it as is)
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int jd = 0; jd < DH / 8; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
    }

    __syncthreads();                          // every warp is done with K_j
    if (j + 1 < j_end)
      stage<T, D, BK>(k_s, kb + (k0 + BK) * ks.s, ks.s, sk - k0 - BK);
    gemm3::cp_async_commit();
    gemm3::cp_async_wait<1>();                // this thread's V_j landed
    if constexpr (F32) split_tile<D, BK>(v_s, v_lo);
    __syncthreads();
    pv<D, BK, DH>(acc, s, v_s, v_lo, d0, lane);
  }
  gemm3::cp_async_wait<0>();

  // epilogue: l over the quad, o = acc / max(l, 1e-30); with LSE also
  // lse = m + log(max(l, 1e-30)), written once a row (the quad's first
  // lane of the warp holding columns from 0)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int row = q0 + row_w + gid + hf * 8;
    if (row >= sq) continue;
    if constexpr (LSE) {
      if (tig == 0 && d0 == 0)
        lse[(static_cast<long long>(bb) * gridDim.y + hh) * sq + row] =
            m[hf] + logf(lt);
    }
    T* orow = ob + row * os.s + d0 + 2 * tig;
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd)
      store2(orow + 8 * jd, acc[jd][2 * hf] / lt, acc[jd][2 * hf + 1] / lt);
  }
}

template <typename T, int D, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int h, int hkv, int sq, int sk, const long long* st,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D, LSE>;
  constexpr int bytes = Geo<T, D>::BYTES;
  static std::atomic<unsigned> smem_set{0};
  int err = gemm3::allow_smem(reinterpret_cast<const void*>(kern), bytes,
                              smem_set);
  if (err) return err;
  constexpr int BQ = Geo<T, D>::BQ;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, Geo<T, D>::NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h / hkv, sq, sk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LSE>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int h, int hkv, int sq, int sk, int d,
               const long long* st, int causal, int window, int q_offset,
               float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    case 32: return launch<T, 32, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    case 64: return launch<T, 64, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    case 128: return launch<T, 128, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    case 256: return launch<T, 256, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    default: return -1;
  }
}

// the lse store is a template parameter: the instantiations without it
// compile the epilogue they had before it existed
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int h, int hkv, int sq, int sk, int d, const long long* st,
             int causal, int window, int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return l ? dispatch_d<T, true>(q, k, v, o, l, b, h, hkv, sq, sk, d, st,
                                 causal, window, q_offset, scale, s)
           : dispatch_d<T, false>(q, k, v, o, l, b, h, hkv, sq, sk, d, st,
                                  causal, window, q_offset, scale, s);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D), each given by
// its base pointer and element strides of b, h and s in `strides` (q, k,
// v, o in turn; the last dim contiguous, every row 16-byte aligned).  lse
// is null, or a contiguous float32 (B, H, Sq) that receives each row's
// log-sum-exp of its scaled, masked scores (m + log(max(l, 1e-30)), in the
// units of the reference's _flash_fwd_impl).  window <= 0 means none.
// Returns the CUDA error of the launch, or -1 for a head dim the kernel is
// not built for.  Sq > 0.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int h, int hkv, int sq, int sk, int d,
                                   const long long* strides, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, lse, b, h, hkv, sq, sk, d, strides,
                         causal, window, q_offset, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int b,
                                    int h, int hkv, int sq, int sk, int d,
                                    const long long* strides, int causal,
                                    int window, int q_offset, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, b, h, hkv, sq, sk, d,
                                 strides, causal, window, q_offset, scale,
                                 stream);
}
