// GQA flash-attention forward for Hopper (sm_90a), float32 or bf16 in,
// float32 arithmetic, output in q's type:
//
//   o[b, h, i] = softmax_j(q[b, h, i] · k[b, h / g, j] * scale + mask) · v[b, h / g]
//
// Replaces the Pallas kernel `_flash_kernel` (src/repro/kernels/
// flash_attention.py, public `flash_attention`).  Its grid (batch, q head,
// q block, kv block) runs the kv axis in order on one TPU core and carries
// the online-softmax state (acc, m, l) in VMEM scratch from one grid step
// to the next.  Here one block owns one 64-row q tile of one q head and
// walks the kv axis itself, keeping m and l in registers; kv head h / g is
// read in place (no replicated K/V).
//
// Masks, exactly as the TPU kernel writes them: query row i sits at
// absolute position q_offset + i; a key at kpos is kept when
// (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window), and a
// masked score is the finite -1e30 (with -inf a fully masked row of a tile
// would give inf - inf = NaN; with -1e30 its p = exp(0) = 1 is washed out
// by alpha = exp(-1e30 - m) = 0 at the next unmasked tile).  Key tiles
// outside the band (k_lo > q_hi when causal, k_hi <= q_lo - window) are
// never visited.  Lengths no tile divides are masked at the edges: rows
// past Sq are not written, keys past Sk get p = 0 and zero K/V.
//
// Design: 256 threads; the 64-row Q tile stays in shared memory, K and V
// tiles of 64 keys take turns in one buffer (all rows padded by 4 floats,
// so the float4 reads below hit distinct banks).  Thread (ty, tx) owns
// rows 4ty..4ty+3: for S = Q Kᵀ it computes keys tx + 16c (c < 4), summing
// over d in order with fmaf; the 16 threads of a row reduce its maximum
// with warp shuffles; p goes to shared memory key-major; for O += P V the
// thread owns D / 16 columns of its rows (float4 groups 64 apart for
// D >= 64).  The row sum l is kept per thread over its own keys and summed
// across the 16 threads once, in the epilogue (alpha is the same for all
// 16, so the sum is the same l).  expf, not __expf; no atomics: two calls
// give the same bits.  Head dims 16, 32, 64, 128, 256 (a template
// parameter); shared memory is 27.6 KB at D = 16 and 147 KB at D = 256,
// so the kernel opts in to dynamic shared memory above 48 KB.
//
// What bounds it: the arithmetic.  For each kept (query, key) pair it does
// 4·D flops (QKᵀ and PV); at gemma3's global layer (2 x 4 heads x 4096²/2
// causal pairs, D = 256) that is 69 GFLOP, ~1.03 ms at the H100's float32
// rate (67 TFLOP/s), against 25 MB of q, k, v and o (~8 us at 3.35 TB/s).
// This SIMT kernel reads both operands of every FMA pair from shared
// memory as float4 (2 loads per 16 FMAs in S, 1 + D / 64 per D / 4 in PV)
// with one block per SM at D = 256; tensor cores (wgmma) under an explicit
// precision opt-in, and K/V double-buffered with TMA, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads
constexpr int TM = 4;           // rows per thread
constexpr int TN = 4;           // keys per thread per tile
constexpr int PAD = 4;          // floats after each shared row
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr int smem_bytes() {
  return 4 * (BQ * (D + PAD) + BK * (D + PAD) + BK * (BQ + PAD));
}

struct Strides {                // element strides; the last dim is contiguous
  long long b, h, s;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 64 rows of D from src (row stride rs) into dst[row][D + PAD] as float32;
// rows at or past n_valid are zero.  Reads run along d, 4 elements a thread.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long rs, int n_valid) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < 64 * C4; idx += NT) {
    const int row = idx / C4, c = (idx % C4) * 4;
    const float4 x = row < n_valid ? load4(src + row * rs + c)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + row * (D + PAD) + c, x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int g, int sq,
                 int sk, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, int q_offset, float scale) {
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // [BQ][D + PAD]
  float* kv_s = q_s + BQ * (D + PAD);         // [BK][D + PAD]: K, then V
  float* p_s = kv_s + BK * (D + PAD);         // [BK][BQ + PAD], key-major

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the heaviest causal tiles (largest q) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z, hk = hh / g;
  const T* qb = q + bb * qs.b + hh * qs.h;
  const T* kb = k + bb * ks.b + hk * ks.h;
  const T* vb = v + bb * vs.b + hk * vs.h;
  T* ob = o + bb * os.b + hh * os.h;

  load_tile<T, D>(q_s, qb + q0 * qs.s, qs.s, sq - q0);

  // the band of key tiles this q tile can see
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, sq) - 1;
  int j_begin = 0, j_end = (sk + BK - 1) / BK;
  if (causal) j_end = min(j_end, q_hi / BK + 1);            // k_lo <= q_hi
  if (window > 0 && q_lo - window + 1 > 0)                  // k_hi > q_lo - w
    j_begin = (q_lo - window + 1) / BK;

  float m[TM], l[TM], acc[TM][CPT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    __syncthreads();            // Q is in; the last tile's V and P are read
    load_tile<T, D>(kv_s, kb + k0 * ks.s, ks.s, sk - k0);
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            q_s + (ty * TM + i) * (D + PAD) + d);
#pragma unroll
      for (int c = 0; c < TN; ++c)
        b[c] = *reinterpret_cast<const float4*>(
            kv_s + (tx + 16 * c) * (D + PAD) + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          float t = s[i][c];
          t = fmaf(a[i].x, b[c].x, t);
          t = fmaf(a[i].y, b[c].y, t);
          t = fmaf(a[i].z, b[c].z, t);
          t = fmaf(a[i].w, b[c].w, t);
          s[i][c] = t;
        }
    }

    // scale, mask, online softmax (m over the row's 16 threads)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q_lo + ty * TM + i;
      float tile_max = NEG_INF;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const bool keep = kpos < sk && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][c] = keep ? s[i][c] * scale : NEG_INF;
        tile_max = fmaxf(tile_max, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max,
                         __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int kpos = k0 + tx + 16 * c;
        s[i][c] = kpos < sk ? expf(s[i][c] - m_new) : 0.f;
        psum += s[i][c];
      }
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();            // every thread is done with K
#pragma unroll
    for (int c = 0; c < TN; ++c)
      store4(p_s + (tx + 16 * c) * (BQ + PAD) + ty * TM,
             make_float4(s[0][c], s[1][c], s[2][c], s[3][c]));
    load_tile<T, D>(kv_s, vb + k0 * vs.s, vs.s, sk - k0);
    __syncthreads();

#pragma unroll 2
    for (int jk = 0; jk < BK; ++jk) {
      const float4 p = *reinterpret_cast<const float4*>(
          p_s + jk * (BQ + PAD) + ty * TM);
      const float pr[TM] = {p.x, p.y, p.z, p.w};
      const float* vrow = kv_s + jk * (D + PAD);
      if constexpr (D >= 64) {
#pragma unroll
        for (int c4 = 0; c4 < D / 64; ++c4) {
          const float4 x =
              *reinterpret_cast<const float4*>(vrow + c4 * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][c4 * 4 + 0] = fmaf(pr[i], x.x, acc[i][c4 * 4 + 0]);
            acc[i][c4 * 4 + 1] = fmaf(pr[i], x.y, acc[i][c4 * 4 + 1]);
            acc[i][c4 * 4 + 2] = fmaf(pr[i], x.z, acc[i][c4 * 4 + 2]);
            acc[i][c4 * 4 + 3] = fmaf(pr[i], x.w, acc[i][c4 * 4 + 3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float x = vrow[tx + 16 * c];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][c] = fmaf(pr[i], x, acc[i][c]);
        }
      }
    }
  }

  // epilogue: l over the row's 16 threads, o = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int row = q0 + ty * TM + i;
    if (row >= sq) continue;
    T* orow = ob + row * os.s;
    if constexpr (D >= 64) {
#pragma unroll
      for (int c4 = 0; c4 < D / 64; ++c4)
        store4(orow + c4 * 64 + tx * 4,
               make_float4(acc[i][c4 * 4 + 0] / lt, acc[i][c4 * 4 + 1] / lt,
                           acc[i][c4 * 4 + 2] / lt, acc[i][c4 * 4 + 3] / lt));
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) store1(orow + tx + 16 * c, acc[i][c] / lt);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h,
           int hkv, int sq, int sk, const long long* st, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h / hkv, sq, sk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int h, int hkv, int sq, int sk, int d, const long long* st,
             int causal, int window, int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, b, h, hkv, sq, sk, st, causal, window, q_offset, scale, s);
    default: return -1;
  }
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D), each given by
// its base pointer and element strides of b, h and s in `strides` (q, k,
// v, o in turn; the last dim contiguous, every row 16-byte aligned for
// float32 and 8-byte aligned for bf16).  window <= 0 means none.  Returns
// the CUDA error of the launch, or -1 for a head dim the kernel is not
// built for.  Sq > 0.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int b, int h,
                                   int hkv, int sq, int sk, int d,
                                   const long long* strides, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, b, h, hkv, sq, sk, d, strides, causal,
                         window, q_offset, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int h,
                                    int hkv, int sq, int sk, int d,
                                    const long long* strides, int causal,
                                    int window, int q_offset, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, h, hkv, sq, sk, d, strides,
                                 causal, window, q_offset, scale, stream);
}
