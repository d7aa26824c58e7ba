// Selective scan of the hymba SSM branch for Hopper (sm_90a), float32,
// forward only:
//
//   h[b, t, d, n] = exp(dt[b, t, d] · a[d, n]) · h[b, t-1, d, n]
//                   + dt[b, t, d] · bmat[b, t, n] · x[b, t, d]
//   ys[b, t, d]   = Σ_n h[b, t, d, n] · cmat[b, t, n]
//
// from h[b, -1] = h0[b], with the last state written to h_out.
//
// Replaces no Pallas kernel: the reference runs this recurrence as the
// inner `lax.scan` of `ssm_scan` (src/repro/nn/ssm.py:ssm_scan, its `step`
// under a `jax.checkpoint`-ed scan over 64-step chunks), which XLA
// compiles.  Eager torch would take one or more launches a time step and
// layer; this is one launch a layer.
//
// Bound.  Each input is read once and each output written once: dt, x and
// ys are (B, S, Di) and dominate (at hymba's prefill, 2 x 4096 x 3200,
// three of them are 315 MB: 0.094 ms at 3.35 TB/s).  The arithmetic is
// B·S·Di·N of each of: one product dt·a, one expf, two products dt·b·x,
// one fused multiply-add, one product and one add for the sum over n
// (419 M expf at that shape, on the SFUs).
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
// one fmaf(da, h, (dt·b)·x).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int T_TILE = 32;

template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bmat,
                const float* __restrict__ cmat, const float* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ ys, float* __restrict__ h_out, int S,
                int Di) {
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

  for (int t0 = 0; t0 < S; t0 += T_TILE) {
    const int steps = min(T_TILE, S - t0);
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
           float* h_out, int B, int S, int Di, cudaStream_t stream) {
  constexpr int CH = THREADS / N;
  const dim3 grid((Di + CH - 1) / CH, B);
  ssm_scan_kernel<N><<<grid, THREADS, 0, stream>>>(dt, bmat, cmat, x, a, h0,
                                                   ys, h_out, S, Di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt, x, ys (B, S, Di); bmat, cmat (B, S, N); a (Di, N); h0, h_out
// (B, Di, N): contiguous float32 on the device.  N is 4, 8, 16 or 32.
// Returns the CUDA error of the launch (B or Di of 0 is a grid the launch
// refuses), or -1 for an N the kernel is not built for.  S = 0 copies h0.
extern "C" int ssm_scan_f32(const void* dt, const void* bmat,
                            const void* cmat, const void* x, const void* a,
                            const void* h0, void* ys, void* h_out, int B,
                            int S, int Di, int N, void* stream) {
  auto f = [&](auto launcher) {
    return launcher(static_cast<const float*>(dt),
                    static_cast<const float*>(bmat),
                    static_cast<const float*>(cmat),
                    static_cast<const float*>(x),
                    static_cast<const float*>(a),
                    static_cast<const float*>(h0), static_cast<float*>(ys),
                    static_cast<float*>(h_out), B, S, Di,
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
