// Selective scan of the hymba SSM branch for Hopper (sm_90a), float32:
// the forward and its backward.
//
//   h[b, t, d, n] = exp(dt[b, t, d] · a[d, n]) · h[b, t-1, d, n]
//                   + dt[b, t, d] · bmat[b, t, n] · x[b, t, d]
//   ys[b, t, d]   = Σ_n h[b, t, d, n] · cmat[b, t, n]
//
// from h[b, -1] = h0[b], with the last state written to h_out and, for
// the backward, the state entering every chunk of CHUNK steps to h_chunks.
//
// Replaces no Pallas kernel: the reference runs this recurrence as the
// inner `lax.scan` of `ssm_scan` (src/repro/nn/ssm.py:ssm_scan, its `step`
// under a `jax.checkpoint`-ed scan over 64-step chunks), which XLA
// compiles and differentiates.  Eager torch would take one or more
// launches a time step and layer; this is one launch a layer each way.
//
// Forward.  Bound: each input is read once and each output written once:
// dt, x and ys are (B, S, Di) and dominate (at hymba's prefill, 2 x 4096 x
// 3200, three of them are 315 MB: 0.094 ms at 3.35 TB/s).  The arithmetic
// is B·S·Di·N of each of: one product dt·a, one expf, two products
// dt·b·x, one fused multiply-add, one product and one add for the sum over
// n (419 M expf at that shape, on the SFUs).
//
// Design.  The (B, Di, N) state stays in registers over one pass of S: a
// thread owns one (b, d, n) and a channel's N states sit in N neighbouring
// lanes, so a 256-thread block holds 256 / N channels of one batch row
// (at N = 16: 16 channels, and 400 blocks of 8 warps at 2 x 3200, every
// block resident at once; one thread per (b, d) with the N states in its
// registers would give 6,400 threads, 1.5 warps an SM, too few to hide the
// latency of the serial chain).  The time axis is walked in tiles of
// T_TILE steps: the block stages the tile's bmat and cmat rows (shared by
// every channel of the batch row) and its channels' dt and x into shared
// memory with coalesced loads, runs the tile's steps from there, collects
// each step's ys in shared memory and writes them back as rows.  y's sum
// over n is a butterfly of __shfl_xor over the channel's N lanes, always
// in the same order, so the same inputs give the same bits on every run
// (and every lane of a channel holds the same sum: the product h·c is
// rounded before it is summed, never contracted into the add).  expf, not
// __expf: the accurate exponential, as the plain version's.  The update is
// one fmaf(da, h, (dt·b)·x).  A CHUNK is two tiles; with h_chunks given,
// the state entering each chunk is stored (nothing else changes, so ys and
// h_out keep their bits).
//
// Backward (ssm_scan_bwd_kernel), the adjoint recurrence
//
//   g_t = dys_t · c_t + exp(dt_{t+1} · a) · g_{t+1},   g_S = dh_last
//
// with d_c_t = Σ_d dys_t·h_t, d_b_t = Σ_d g_t·dt_t·x_t, d_x_t = dt_t·Σ_n
// g_t·b_t, d_dt_t = Σ_n g_t·(a·exp(dt_t·a)·h_{t-1} + b_t·x_t), d_a =
// Σ_{b,t} g_t·dt_t·exp(dt_t·a)·h_{t-1} and d_h0 = exp(dt_0·a)·g_0.  The
// forward's layout: a thread a (b, d, n), g in a register.  The tiles are
// walked from the last: each tile's states are recomputed from its
// chunk's saved state (through the chunk's first tile when the tile is its
// second) with the forward's own expression, so they are its bits, into
// shared memory (T_TILE x 256 floats), then the tile's steps run backward.
// The sums over n (d_x, d_dt) are the forward's butterfly.  The sums over
// d (d_b, d_c) cross blocks: each block adds its channels in channel order
// from shared memory and writes its partial; a second kernel
// (sum_parts_kernel) adds the partials in block order, and sums d_a's
// per-batch-row partials in row order.  No atomics: the same inputs give
// the same bits.  Bound: dt, x, dys, d_dt and d_x (B, S, Di) read or
// written once dominate (262 MB at 2 x 2048 x 3200: 0.078 ms); the partials
// add 2 x B x Di/(256/N) x S x N floats written and read again.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int T_TILE = 32;
constexpr int CHUNK = 2 * T_TILE;               // steps between saved states

template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bmat,
                const float* __restrict__ cmat, const float* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ ys, float* __restrict__ h_out,
                float* __restrict__ h_chunks, int S, int Di) {
  constexpr int CH = THREADS / N;               // channels of the block
  __shared__ float s_b[T_TILE][N];
  __shared__ float s_c[T_TILE][N];
  __shared__ float s_dt[T_TILE][CH];
  __shared__ float s_x[T_TILE][CH];
  __shared__ float s_y[T_TILE][CH];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int ch = threadIdx.x / N;
  const int n = threadIdx.x % N;
  const int d = d0 + ch;
  const bool live = d < Di;
  const size_t state = (static_cast<size_t>(b) * Di + d) * N + n;
  const float av = live ? a[static_cast<size_t>(d) * N + n] : 0.f;
  float h = live ? h0[state] : 0.f;
  const size_t base_d = static_cast<size_t>(b) * S * Di;   // dt, x, ys
  const size_t base_n = static_cast<size_t>(b) * S * N;    // bmat, cmat

  const int n_chunks = (S + CHUNK - 1) / CHUNK;

  for (int t0 = 0; t0 < S; t0 += T_TILE) {
    const int steps = min(T_TILE, S - t0);
    if (h_chunks != nullptr && live && t0 % CHUNK == 0)
      h_chunks[((static_cast<size_t>(b) * n_chunks + t0 / CHUNK) * Di + d) * N
               + n] = h;
    for (int i = threadIdx.x; i < T_TILE * N; i += THREADS) {
      const int tt = i / N, nn = i % N;
      float bv = 0.f, cv = 0.f;
      if (tt < steps) {
        const size_t o = base_n + static_cast<size_t>(t0 + tt) * N + nn;
        bv = bmat[o];
        cv = cmat[o];
      }
      s_b[tt][nn] = bv;
      s_c[tt][nn] = cv;
    }
    for (int i = threadIdx.x; i < T_TILE * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      float dv = 0.f, xv = 0.f;
      if (tt < steps && d0 + cc < Di) {
        const size_t o = base_d + static_cast<size_t>(t0 + tt) * Di + d0 + cc;
        dv = dt[o];
        xv = x[o];
      }
      s_dt[tt][cc] = dv;
      s_x[tt][cc] = xv;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {     // uniform over the block
      const float dtv = s_dt[tt][ch];
      const float da = expf(dtv * av);
      h = fmaf(da, h, dtv * s_b[tt][n] * s_x[tt][ch]);
      float p = __fmul_rn(h, s_c[tt][n]);   // never contracted into the sum
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off, N);
      if (n == 0) s_y[tt][ch] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T_TILE * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      if (tt < steps && d0 + cc < Di)
        ys[base_d + static_cast<size_t>(t0 + tt) * Di + d0 + cc] = s_y[tt][cc];
    }
    // the next tile's staging writes s_b .. s_x, which this tile's steps
    // have finished reading (the __syncthreads above); s_y is next
    // written after the next tile's first __syncthreads
  }
  if (live) h_out[state] = h;
}

template <int N>
int launch(const float* dt, const float* bmat, const float* cmat,
           const float* x, const float* a, const float* h0, float* ys,
           float* h_out, float* h_chunks, int B, int S, int Di,
           cudaStream_t stream) {
  constexpr int CH = THREADS / N;
  const dim3 grid((Di + CH - 1) / CH, B);
  ssm_scan_kernel<N><<<grid, THREADS, 0, stream>>>(dt, bmat, cmat, x, a, h0,
                                                   ys, h_out, h_chunks, S,
                                                   Di);
  return static_cast<int>(cudaGetLastError());
}

// The backward's shared memory, in floats: the tile's states (then its
// g·dt·x products) and dys·h products, T_TILE x THREADS each; the tile's
// bmat and cmat rows; its channels' dt, x, dys, d_dt and d_x.
template <int N>
constexpr int bwd_smem_floats() {
  return 2 * T_TILE * THREADS + 2 * T_TILE * N + 5 * T_TILE * (THREADS / N);
}

// Stages `steps` rows from t0 of one batch row (base_n into bmat and cmat,
// base_d into dt, x and dys): bmat and the block's channels' dt and x,
// and with cmat and dys given also those (zeros past S and past Di).
template <int N>
__device__ __forceinline__ void stage_rows(
    float (*s_b)[N], float (*s_c)[N], float (*s_dt)[THREADS / N],
    float (*s_x)[THREADS / N], float (*s_dy)[THREADS / N],
    const float* __restrict__ bmat, const float* __restrict__ cmat,
    const float* __restrict__ dt, const float* __restrict__ x,
    const float* __restrict__ dys, size_t base_n, size_t base_d, int t0,
    int steps, int d0, int Di) {
  constexpr int CH = THREADS / N;
  for (int i = threadIdx.x; i < T_TILE * N; i += THREADS) {
    const int tt = i / N, nn = i % N;
    const size_t o = base_n + static_cast<size_t>(t0 + tt) * N + nn;
    s_b[tt][nn] = tt < steps ? bmat[o] : 0.f;
    if (cmat != nullptr) s_c[tt][nn] = tt < steps ? cmat[o] : 0.f;
  }
  for (int i = threadIdx.x; i < T_TILE * CH; i += THREADS) {
    const int tt = i / CH, cc = i % CH;
    const bool in = tt < steps && d0 + cc < Di;
    const size_t o = base_d + static_cast<size_t>(t0 + tt) * Di + d0 + cc;
    s_dt[tt][cc] = in ? dt[o] : 0.f;
    s_x[tt][cc] = in ? x[o] : 0.f;
    if (dys != nullptr) s_dy[tt][cc] = in ? dys[o] : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_bwd_kernel(const float* __restrict__ dt,
                    const float* __restrict__ bmat,
                    const float* __restrict__ cmat,
                    const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ h_chunks,
                    const float* __restrict__ dys,
                    const float* __restrict__ dh_last,
                    float* __restrict__ d_dt, float* __restrict__ d_x,
                    float* __restrict__ d_h0, float* __restrict__ part_b,
                    float* __restrict__ part_c, float* __restrict__ part_a,
                    int S, int Di) {
  constexpr int CH = THREADS / N;
  extern __shared__ float smem[];
  auto s_h = reinterpret_cast<float (*)[THREADS]>(smem);
  auto s_pc = reinterpret_cast<float (*)[THREADS]>(smem + T_TILE * THREADS);
  auto s_b = reinterpret_cast<float (*)[N]>(smem + 2 * T_TILE * THREADS);
  auto s_c = s_b + T_TILE;
  auto s_dt = reinterpret_cast<float (*)[CH]>(s_c + T_TILE);
  auto s_x = s_dt + T_TILE;
  auto s_dy = s_x + T_TILE;
  auto s_ddt = s_dy + T_TILE;
  auto s_dx = s_ddt + T_TILE;

  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int d0 = blk * CH;
  const int ch = threadIdx.x / N;
  const int n = threadIdx.x % N;
  const int d = d0 + ch;
  const bool live = d < Di;
  const int live_ch = min(CH, Di - d0);
  const size_t state = (static_cast<size_t>(b) * Di + d) * N + n;
  const float av = live ? a[static_cast<size_t>(d) * N + n] : 0.f;
  const size_t base_d = static_cast<size_t>(b) * S * Di;   // dt, x, dys
  const size_t base_n = static_cast<size_t>(b) * S * N;    // bmat, cmat
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  float g_next = live && dh_last != nullptr ? dh_last[state] : 0.f;
  float acc_a = 0.f;


  for (int t0 = (S - 1) / T_TILE * T_TILE; S > 0 && t0 >= 0; t0 -= T_TILE) {
    const int steps = min(T_TILE, S - t0);
    const int k = t0 / CHUNK;
    float h = live ? h_chunks[((static_cast<size_t>(b) * n_chunks + k) * Di
                               + d) * N + n] : 0.f;
    // a chunk's second tile starts from its state through the first tile
    for (int t1 = k * CHUNK; t1 < t0; t1 += T_TILE) {
      stage_rows<N>(s_b, s_c, s_dt, s_x, s_dy, bmat, nullptr, dt, x, nullptr,
                    base_n, base_d, t1, T_TILE, d0, Di);
      __syncthreads();
      for (int tt = 0; tt < T_TILE; ++tt) {
        const float dtv = s_dt[tt][ch];
        h = fmaf(expf(dtv * av), h, dtv * s_b[tt][n] * s_x[tt][ch]);
      }
      __syncthreads();
    }
    stage_rows<N>(s_b, s_c, s_dt, s_x, s_dy, bmat, cmat, dt, x, dys, base_n,
                  base_d, t0, steps, d0, Di);
    __syncthreads();
    const float h_enter = h;
    for (int tt = 0; tt < steps; ++tt) {       // the forward's states
      const float dtv = s_dt[tt][ch];
      h = fmaf(expf(dtv * av), h, dtv * s_b[tt][n] * s_x[tt][ch]);
      s_h[tt][threadIdx.x] = h;
    }
    // backward over the tile; a thread reads and writes only its own
    // column of s_h and s_pc here, so no barrier until the sums below
    for (int tt = steps - 1; tt >= 0; --tt) {
      const float dtv = s_dt[tt][ch], xv = s_x[tt][ch], dy = s_dy[tt][ch];
      const float bv = s_b[tt][n];
      const float ht = s_h[tt][threadIdx.x];
      const float hp = tt > 0 ? s_h[tt - 1][threadIdx.x] : h_enter;
      const float g = fmaf(dy, s_c[tt][n], g_next);
      const float da = expf(dtv * av);
      const float dah = da * hp;
      const float gdt = g * dtv;
      acc_a = fmaf(gdt, dah, acc_a);
      float p_dt = g * fmaf(av, dah, bv * xv);
      float p_x = g * bv;
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) {
        p_dt += __shfl_xor_sync(0xffffffffu, p_dt, off, N);
        p_x += __shfl_xor_sync(0xffffffffu, p_x, off, N);
      }
      if (n == 0) {
        s_ddt[tt][ch] = p_dt;
        s_dx[tt][ch] = p_x * dtv;
      }
      s_h[tt][threadIdx.x] = gdt * xv;        // h_t is read no more
      s_pc[tt][threadIdx.x] = dy * ht;
      g_next = da * g;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T_TILE * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      if (tt < steps && d0 + cc < Di) {
        const size_t o = base_d + static_cast<size_t>(t0 + tt) * Di + d0 + cc;
        d_dt[o] = s_ddt[tt][cc];
        d_x[o] = s_dx[tt][cc];
      }
    }
    // the block's sums over its live channels, in channel order
    for (int i = threadIdx.x; i < T_TILE * N; i += THREADS) {
      const int tt = i / N, nn = i % N;
      if (tt < steps) {
        float sb = 0.f, sc = 0.f;
        for (int cc = 0; cc < live_ch; ++cc) {
          sb += s_h[tt][cc * N + nn];
          sc += s_pc[tt][cc * N + nn];
        }
        const size_t o = ((static_cast<size_t>(b) * gridDim.x + blk) * S + t0
                          + tt) * N + nn;
        part_b[o] = sb;
        part_c[o] = sc;
      }
    }
    __syncthreads();    // the next tile's staging overwrites every buffer
  }
  if (live) {
    part_a[state] = acc_a;
    d_h0[state] = g_next;
  }
}

// out[q, m] = Σ_{p < P} parts[(q·P + p)·M + m], p ascending: the fixed
// order of the partial sums.
__global__ void sum_parts_kernel(const float* __restrict__ parts,
                                 float* __restrict__ out, long long Q, int P,
                                 long long M) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= Q * M) return;
  const float* src = parts + (i / M) * P * M + i % M;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += src[static_cast<long long>(p) * M];
  out[i] = s;
}

int sum_parts(const float* parts, float* out, long long Q, int P,
              long long M, cudaStream_t stream) {
  if (Q * M == 0) return 0;
  const long long blocks = (Q * M + THREADS - 1) / THREADS;
  sum_parts_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      parts, out, Q, P, M);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
long long bwd_blocks(int Di) {
  constexpr int CH = THREADS / N;
  return (Di + CH - 1) / CH;
}

long long blocks_of(int Di, int N) {
  switch (N) {
    case 4: return bwd_blocks<4>(Di);
    case 8: return bwd_blocks<8>(Di);
    case 16: return bwd_blocks<16>(Di);
    case 32: return bwd_blocks<32>(Di);
    default: return -1;
  }
}

template <int N>
int launch_bwd(const float* dt, const float* bmat, const float* cmat,
               const float* x, const float* a, const float* h_chunks,
               const float* dys, const float* dh_last, float* d_dt,
               float* d_bmat, float* d_cmat, float* d_x, float* d_a,
               float* d_h0, float* work, int B, int S, int Di,
               cudaStream_t stream) {
  const long long nblk = bwd_blocks<N>(Di);
  float* part_b = work;
  float* part_c = part_b + B * nblk * S * N;
  float* part_a = part_c + B * nblk * S * N;
  const int smem = bwd_smem_floats<N>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nblk), B);
  ssm_scan_bwd_kernel<N><<<grid, THREADS, smem, stream>>>(
      dt, bmat, cmat, x, a, h_chunks, dys, dh_last, d_dt, d_x, d_h0, part_b,
      part_c, part_a, S, Di);
  int e = static_cast<int>(cudaGetLastError());
  if (e == 0) e = sum_parts(part_b, d_bmat, B, nblk, 1LL * S * N, stream);
  if (e == 0) e = sum_parts(part_c, d_cmat, B, nblk, 1LL * S * N, stream);
  if (e == 0) e = sum_parts(part_a, d_a, 1, B, 1LL * Di * N, stream);
  return e;
}

}  // namespace

// dt, x, ys (B, S, Di); bmat, cmat (B, S, N); a (Di, N); h0, h_out
// (B, Di, N); h_chunks (B, ceil(S / 64), Di, N) or null (none stored):
// contiguous float32 on the device.  N is 4, 8, 16 or 32.  Returns the
// CUDA error of the launch (B or Di of 0 is a grid the launch refuses), or
// -1 for an N the kernel is not built for.  S = 0 copies h0.
extern "C" int ssm_scan_f32(const void* dt, const void* bmat,
                            const void* cmat, const void* x, const void* a,
                            const void* h0, void* ys, void* h_out,
                            void* h_chunks, int B, int S, int Di, int N,
                            void* stream) {
  auto f = [&](auto launcher) {
    return launcher(static_cast<const float*>(dt),
                    static_cast<const float*>(bmat),
                    static_cast<const float*>(cmat),
                    static_cast<const float*>(x),
                    static_cast<const float*>(a),
                    static_cast<const float*>(h0), static_cast<float*>(ys),
                    static_cast<float*>(h_out),
                    static_cast<float*>(h_chunks), B, S, Di,
                    static_cast<cudaStream_t>(stream));
  };
  switch (N) {
    case 4: return f(launch<4>);
    case 8: return f(launch<8>);
    case 16: return f(launch<16>);
    case 32: return f(launch<32>);
    default: return -1;
  }
}

// Floats of scratch the backward needs (its partial sums), or -1 for an N
// the kernel is not built for.
extern "C" long long ssm_scan_bwd_workspace(int B, int S, int Di, int N) {
  const long long nblk = blocks_of(Di, N);
  if (nblk < 0) return -1;
  return 2LL * B * nblk * S * N + 1LL * B * Di * N;
}

// The backward: the forward's inputs (h0 replaced by the h_chunks
// ssm_scan_f32 stored), dys (B, S, Di) and dh_last (B, Di, N, or null for
// zeros) -> d_dt, d_x (B, S, Di), d_bmat, d_cmat (B, S, N), d_a (Di, N)
// and d_h0 (B, Di, N), through `work`
// (ssm_scan_bwd_workspace floats).  Contiguous float32 on the device.
// Returns the first CUDA error of its launches, or -1 for an unsupported N.
extern "C" int ssm_scan_bwd_f32(const void* dt, const void* bmat,
                                const void* cmat, const void* x,
                                const void* a, const void* h_chunks,
                                const void* dys, const void* dh_last,
                                void* d_dt, void* d_bmat, void* d_cmat,
                                void* d_x, void* d_a, void* d_h0, void* work,
                                int B, int S, int Di, int N, void* stream) {
  auto f = [&](auto launcher) {
    return launcher(
        static_cast<const float*>(dt), static_cast<const float*>(bmat),
        static_cast<const float*>(cmat), static_cast<const float*>(x),
        static_cast<const float*>(a), static_cast<const float*>(h_chunks),
        static_cast<const float*>(dys), static_cast<const float*>(dh_last),
        static_cast<float*>(d_dt), static_cast<float*>(d_bmat),
        static_cast<float*>(d_cmat), static_cast<float*>(d_x),
        static_cast<float*>(d_a), static_cast<float*>(d_h0),
        static_cast<float*>(work), B, S, Di,
        static_cast<cudaStream_t>(stream));
  };
  switch (N) {
    case 4: return f(launch_bwd<4>);
    case 8: return f(launch_bwd<8>);
    case 16: return f(launch_bwd<16>);
    case 32: return f(launch_bwd<32>);
    default: return -1;
  }
}
