// The sLSTM recurrence of xLSTM for Hopper (sm_90a), float32: one launch
// runs a layer's whole sequence.
//
//   rec[b, col] = Σ_i h[b, t-1, k·dh + i] · rh[k, i, e],  k = col / (4dh),
//                                                        e = col % (4dh)
//   pre = (wx[b, t] + rec) + bias                          (4D columns)
//   z = tanh(pre_z), o = sigmoid(pre_o), logf = -softplus(-pre_f)
//   m' = max(logf + m, pre_i), i = exp(pre_i - m'), f = exp(logf + m - m')
//   c = f·c + i·z, n = f·n + i, h = (o·c) / max(n, 1e-6)
//
// with gate g's column of channel j at col = g·D + j, from the state (c0,
// n0, m0, h0) (B, D) each; hs (B, S, D) and the final state out.  Head k's
// 4·dh outputs fill columns [k·4dh, (k+1)·4dh) (the reference flattens
// its per-head einsum so), so at H = 4 head k alone feeds gate k of every
// channel.
//
// Replaces no Pallas kernel: the reference runs this recurrence as the
// `cell` of `slstm_apply` (src/repro/nn/xlstm.py:209-228) under its
// `_chunked_scan`/`lax.scan`, which XLA compiles.  Eager torch would take
// ~15 launches a step; this is one launch a layer for the whole sequence,
// and the same kernel serves decode at S = 1.
//
// Bound.  Bytes: wx read once, hs written once, rh, bias and the states
// (at xlstm-1.3b's prefill, 2 x 4096 x 2048, H 4: wx 268 MB, hs 67 MB, rh
// 17 MB, 352 MB in all: 0.105 ms at 3.35 TB/s).  Operations: the
// recurrent products, 2·B·S·4D·dh (68.7 GFLOP there: 1.03 ms at the 67
// TFLOP/s float32 SIMT peak), so the operations bound it.  Latency: the
// S steps depend on one another and every channel's h_t feeds every block
// at step t+1, so each step pays a grid-wide exchange (a grid barrier and
// a read of B·D floats from L2) on top of its share of the products: a
// floor of S times that latency, which no bound above counts.
//
// Design.  A persistent grid, launched cooperatively (the occupancy API
// checks that every block is co-resident; the launch fails otherwise).
// Block b owns CH = 16 channels j and all four gate columns of each (64
// columns, each from head col / (4dh)), so D = 2048 takes 128 blocks, one
// an SM.  4 threads share each column's dot product over dh, and each
// keeps its dh/4 weights of that column of rh in registers for the whole
// sequence (128 at dh 512: LEN is a template parameter).  A step: the
// block reads h_{t-1} of every row and channel (hs's row t-1 through L2 in
// 16-byte loads, h0 at t = 0) into shared memory; each thread walks its
// dh/4 inputs in order, four at a time from one 16-byte shared load per
// batch row (a broadcast: a warp reads two heads' rows), fmaf into one sum
// a row; the 4 partials of a column are added in part order, so the same
// inputs give the same bits on every run; then one thread per (row,
// channel) forms its four pre-activations in the reference's order,
// updates c, n, m in registers, writes h_t to hs, loads the next step's
// wx and waits at the grid barrier.  expf, tanhf and log1pf, no fast
// math.  B (1-8) and dh / 4 are template parameters.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CH = 16;                  // channels a block
constexpr int COLS = 4 * CH;            // their gate columns (z, i, f, o)
constexpr int PARTS = THREADS / COLS;   // threads sharing one column's sum
constexpr int MAX_B = 8;
constexpr size_t SMEM_LIMIT = 232448;   // a block's shared memory on sm_90

// Dynamic shared memory: h_{t-1} of every row (B x D) and the partial
// sums (PARTS x B x COLS), in floats.
size_t smem_bytes(int B, int D) {
  return sizeof(float) * (static_cast<size_t>(B) * D
                          + static_cast<size_t>(PARTS) * B * COLS);
}

template <int NB, int LEN>
__global__ void __launch_bounds__(THREADS, 1)
slstm_scan_kernel(const float* __restrict__ wx, const float* __restrict__ rh,
                  const float* __restrict__ bias,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ m0, const float* __restrict__ h0,
                  float* hs, float* __restrict__ c_out,
                  float* __restrict__ n_out, float* __restrict__ m_out,
                  float* __restrict__ h_out, int S, int D) {
  constexpr int DH = LEN * PARTS;
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);        // [NB][D]
  float* red = h_s + static_cast<size_t>(NB) * D;      // [PARTS][NB][COLS]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * CH;
  // this thread's share of the products: column `col`, inputs
  // [part·LEN, (part+1)·LEN) of its head, their weights in registers
  const int col = tid % COLS;
  const int part = tid / COLS;
  const int gcol = (col / CH) * D + j0 + col % CH;
  const int hoff = (gcol / (4 * DH)) * DH + part * LEN;
  float r[LEN];
  {
    const float* w = rh + (static_cast<size_t>(gcol / (4 * DH)) * DH
                           + part * LEN) * (4 * DH) + gcol % (4 * DH);
#pragma unroll
    for (int i = 0; i < LEN; ++i) r[i] = w[static_cast<size_t>(i) * 4 * DH];
  }

  // the pointwise update: thread tid < NB·CH owns (row ob, channel oj)
  const bool owner = tid < NB * CH;
  const int ob = tid / CH;
  const int oc = tid % CH;
  const int oj = j0 + oc;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;
  float bs[4] = {0.f, 0.f, 0.f, 0.f};
  float xs[4] = {0.f, 0.f, 0.f, 0.f};
  if (owner) {
    const size_t st = static_cast<size_t>(ob) * D + oj;
    c = c0[st];
    n = n0[st];
    m = m0[st];
    h = h0[st];
    const float* w = wx + static_cast<size_t>(ob) * S * 4 * D + oj;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      bs[g] = bias[g * D + oj];
      xs[g] = w[g * D];
    }
  }

  const int d4 = D / 4;
  for (int t = 0; t < S; ++t) {
    // h_{t-1} of every row: h0 at t = 0, else the row the grid wrote
    // before the last barrier (through L2: other SMs wrote it)
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      const float4* src = reinterpret_cast<const float4*>(
          t == 0 ? h0 + static_cast<size_t>(bb) * D
                 : hs + (static_cast<size_t>(bb) * S + t - 1) * D);
      for (int q = tid; q < d4; q += THREADS)
        smem4[bb * d4 + q] = t == 0 ? src[q] : __ldcg(src + q);
    }
    __syncthreads();
    float acc[NB];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) acc[bb] = 0.f;
#pragma unroll
    for (int i = 0; i < LEN; i += 4) {
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const float4 hv =
            *reinterpret_cast<const float4*>(h_s + bb * D + hoff + i);
        acc[bb] = fmaf(hv.x, r[i], acc[bb]);
        acc[bb] = fmaf(hv.y, r[i + 1], acc[bb]);
        acc[bb] = fmaf(hv.z, r[i + 2], acc[bb]);
        acc[bb] = fmaf(hv.w, r[i + 3], acc[bb]);
      }
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) red[(part * NB + bb) * COLS + col] = acc[bb];
    __syncthreads();
    if (owner) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int lc = g * CH + oc;
        float rec = red[ob * COLS + lc];
#pragma unroll
        for (int p = 1; p < PARTS; ++p) rec += red[(p * NB + ob) * COLS + lc];
        pre[g] = (xs[g] + rec) + bs[g];
      }
      const float z = tanhf(pre[0]);
      const float o = 1.f / (1.f + expf(-pre[3]));
      const float logf_ = -(fmaxf(-pre[2], 0.f)
                            + log1pf(expf(-fabsf(pre[2]))));
      const float m_new = fmaxf(logf_ + m, pre[1]);
      const float ig = expf(pre[1] - m_new);
      const float fg = expf((logf_ + m) - m_new);
      c = fg * c + ig * z;
      n = fg * n + ig;
      m = m_new;
      h = (o * c) / fmaxf(n, 1e-6f);
      hs[(static_cast<size_t>(ob) * S + t) * D + oj] = h;
      if (t + 1 < S) {      // the next step's inputs, in flight over the barrier
        const float* w = wx + (static_cast<size_t>(ob) * S + t + 1) * 4 * D
                         + oj;
#pragma unroll
        for (int g = 0; g < 4; ++g) xs[g] = w[g * D];
      }
    }
    grid.sync();
  }
  if (owner) {
    const size_t st = static_cast<size_t>(ob) * D + oj;
    c_out[st] = c;
    n_out[st] = n;
    m_out[st] = m;
    h_out[st] = h;
  }
}

template <int NB, int LEN>
int launch(const float* wx, const float* rh, const float* bias,
           const float* c0, const float* n0, const float* m0,
           const float* h0, float* hs, float* c_out, float* n_out,
           float* m_out, float* h_out, int S, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes(NB, D);
  const void* kernel =
      reinterpret_cast<const void*>(slstm_scan_kernel<NB, LEN>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = D / CH;
  if (blocks > per_sm * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&wx, &rh, &bias, &c0, &n0, &m0, &h0, &hs,
                  &c_out, &n_out, &m_out, &h_out, &S, &D};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS),
                                    args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_dh(int dh, const float* wx, const float* rh, const float* bias,
              const float* c0, const float* n0, const float* m0,
              const float* h0, float* hs, float* c_out, float* n_out,
              float* m_out, float* h_out, int S, int D,
              cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<NB, 4>(wx, rh, bias, c0, n0, m0, h0, hs, c_out,
                                  n_out, m_out, h_out, S, D, stream);
    case 32: return launch<NB, 8>(wx, rh, bias, c0, n0, m0, h0, hs, c_out,
                                  n_out, m_out, h_out, S, D, stream);
    case 64: return launch<NB, 16>(wx, rh, bias, c0, n0, m0, h0, hs, c_out,
                                   n_out, m_out, h_out, S, D, stream);
    case 128: return launch<NB, 32>(wx, rh, bias, c0, n0, m0, h0, hs, c_out,
                                    n_out, m_out, h_out, S, D, stream);
    case 256: return launch<NB, 64>(wx, rh, bias, c0, n0, m0, h0, hs, c_out,
                                    n_out, m_out, h_out, S, D, stream);
    case 512: return launch<NB, 128>(wx, rh, bias, c0, n0, m0, h0, hs,
                                     c_out, n_out, m_out, h_out, S, D,
                                     stream);
    default: return -1;
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch at (B, D, H) takes, or -1 for a
// shape the kernel does not take (B outside 1..MAX_B, D not a multiple of
// CH or of H, dh = D / H not one of 16, 32, 64, 128, 256, 512).
extern "C" long long slstm_scan_smem_bytes(int B, int D, int H) {
  if (B < 1 || B > MAX_B || H < 1 || D < CH || D % CH != 0 || D % H != 0)
    return -1;
  const int dh = D / H;
  if (dh < 16 || dh > 512 || (dh & (dh - 1)) != 0) return -1;
  return static_cast<long long>(smem_bytes(B, D));
}

// The recurrence over S steps: wx (B, S, 4D), rh (H, D/H, 4D/H), bias
// (4D), the state c0, n0, m0, h0 (B, D) -> hs (B, S, D) and the final
// c, n, m, h (B, D).  Contiguous float32 on the device; the outputs must
// not alias the inputs.  Returns 0 or the CUDA error of the launch (82,
// cudaErrorCooperativeLaunchTooLarge, when the grid cannot be
// co-resident), -1 for a shape the kernel does not take and -2 when its
// shared memory exceeds a block's.
extern "C" int slstm_scan_f32(const void* wx, const void* rh,
                              const void* bias, const void* c0,
                              const void* n0, const void* m0, const void* h0,
                              void* hs, void* c_out, void* n_out, void* m_out,
                              void* h_out, int B, int S, int D, int H,
                              void* stream) {
  const long long smem = slstm_scan_smem_bytes(B, D, H);
  if (smem < 0 || S < 1) return -1;
  if (static_cast<size_t>(smem) > SMEM_LIMIT) return -2;
  auto f = [&](auto launcher) {
    return launcher(
        D / H, static_cast<const float*>(wx), static_cast<const float*>(rh),
        static_cast<const float*>(bias), static_cast<const float*>(c0),
        static_cast<const float*>(n0), static_cast<const float*>(m0),
        static_cast<const float*>(h0), static_cast<float*>(hs),
        static_cast<float*>(c_out), static_cast<float*>(n_out),
        static_cast<float*>(m_out), static_cast<float*>(h_out), S, D,
        static_cast<cudaStream_t>(stream));
  };
  switch (B) {
    case 1: return f(launch_dh<1>);
    case 2: return f(launch_dh<2>);
    case 3: return f(launch_dh<3>);
    case 4: return f(launch_dh<4>);
    case 5: return f(launch_dh<5>);
    case 6: return f(launch_dh<6>);
    case 7: return f(launch_dh<7>);
    case 8: return f(launch_dh<8>);
    default: return -1;
  }
}
