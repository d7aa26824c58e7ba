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
// math.  B (1-8) and dh / 4 are template parameters.  Asked, the forward
// also keeps the state (c, n, m) entering every 64-step chunk, as the
// reference's jax.checkpoint-ed chunks keep their carry
// (src/repro/nn/xlstm.py:20-34): the backward's restart points.
//
// The backward (slstm_scan_bwd_kernel, below) replaces XLA's autodiff of
// that scan.  Its recurrent adjoint needs, each step, d_pre_t of a whole
// head (4·dh columns, from every block), so it keeps the forward's
// design: one persistent cooperative launch, a grid barrier a step, the
// sequence walked from the end a chunk at a time, each chunk's
// pre-activations and states recomputed first (block-locally, no
// barrier).  Bound at xlstm-1.3b's train step (2 x 2048 x 2048, H 4):
// the products, 2·B·S·4D·dh for the recompute and as many for the
// adjoint (68.7 GFLOP: 1.03 ms at 67 TFLOP/s), over the bytes of wx, hs,
// dys, d_wx and rh (~0.1 ms), and the S barriers' latency on top.
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
constexpr int CHUNK = 64;               // steps between kept chunk states
constexpr int KEPT = 10;                // floats the backward keeps a step

// Dynamic shared memory: h_{t-1} of every row (B x D) and the partial
// sums (PARTS x B x COLS), in floats.
size_t smem_bytes(int B, int D) {
  return sizeof(float) * (static_cast<size_t>(B) * D
                          + static_cast<size_t>(PARTS) * B * COLS);
}

// The gates of one step and what the adjoint reuses of them.
struct Gates {
  float z, o, sp, lm, ig, fg;   // sp = softplus(-pre_f), lm = logf + m
};

// One step's pointwise update of (c, n, m, h) from its four
// pre-activations, in the reference's order; the forward and the
// backward's recompute share it, so both make the same bits.
__device__ __forceinline__ Gates slstm_step(const float pre[4], float& c,
                                            float& n, float& m, float& h) {
  Gates g;
  g.z = tanhf(pre[0]);
  g.o = 1.f / (1.f + expf(-pre[3]));
  g.sp = fmaxf(-pre[2], 0.f) + log1pf(expf(-fabsf(pre[2])));
  const float logf_ = -g.sp;
  g.lm = logf_ + m;
  const float m_new = fmaxf(g.lm, pre[1]);
  g.ig = expf(pre[1] - m_new);
  g.fg = expf(g.lm - m_new);
  c = g.fg * c + g.ig * g.z;
  n = g.fg * n + g.ig;
  m = m_new;
  h = (g.o * c) / fmaxf(n, 1e-6f);
  return g;
}

// Thread (col, part)'s weights of the forward's products: column `gcol`'s
// inputs [part·LEN, (part+1)·LEN) of its head.
template <int LEN>
__device__ __forceinline__ void load_column(float (&r)[LEN], const float* rh,
                                            int gcol, int part) {
  constexpr int DH = LEN * PARTS;
  const float* w = rh + (static_cast<size_t>(gcol / (4 * DH)) * DH
                         + part * LEN) * (4 * DH) + gcol % (4 * DH);
#pragma unroll
  for (int i = 0; i < LEN; ++i) r[i] = w[static_cast<size_t>(i) * 4 * DH];
}

// Thread (col, part)'s share of every row's product for its column, from
// h_{t-1} staged in shared memory (h_s, NB x D), into red.
template <int NB, int LEN>
__device__ __forceinline__ void column_partials(const float (&r)[LEN],
                                                const float* h_s, float* red,
                                                int D, int hoff, int col,
                                                int part) {
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
}

// Owner (ob, oc)'s four pre-activations from the partial sums in red,
// added in part order, then (wx + rec) + bias.
template <int NB>
__device__ __forceinline__ void form_pre(float pre[4], const float* red,
                                         const float xs[4], const float bs[4],
                                         int ob, int oc) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int lc = g * CH + oc;
    float rec = red[ob * COLS + lc];
#pragma unroll
    for (int p = 1; p < PARTS; ++p) rec += red[(p * NB + ob) * COLS + lc];
    pre[g] = (xs[g] + rec) + bs[g];
  }
}

template <int NB, int LEN>
__global__ void __launch_bounds__(THREADS, 1)
slstm_scan_kernel(const float* __restrict__ wx, const float* __restrict__ rh,
                  const float* __restrict__ bias,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ m0, const float* __restrict__ h0,
                  float* hs, float* __restrict__ c_out,
                  float* __restrict__ n_out, float* __restrict__ m_out,
                  float* __restrict__ h_out, float* __restrict__ c_ch,
                  float* __restrict__ n_ch, float* __restrict__ m_ch,
                  int S, int D) {
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
  load_column(r, rh, gcol, part);

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
    column_partials<NB, LEN>(r, h_s, red, D, hoff, col, part);
    __syncthreads();
    if (owner) {
      if (c_ch != nullptr && t % CHUNK == 0) {   // the state entering a chunk
        const size_t at = (static_cast<size_t>(ob) * ((S + CHUNK - 1) / CHUNK)
                           + t / CHUNK) * D + oj;
        c_ch[at] = c;
        n_ch[at] = n;
        m_ch[at] = m;
      }
      float pre[4];
      form_pre<NB>(pre, red, xs, bs, ob, oc);
      slstm_step(pre, c, n, m, h);
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

// The backward: the sequence walked from the end, a chunk of CHUNK steps
// at a time, by the forward's grid (block b owns channels j0..j0+15).
//
// Per chunk, block-locally (no grid barrier): (1) its pre-activations
// again, every step of the chunk from h_{t-1} (hs, h0 at t = 0), by the
// forward's threads, weights and summation order, so with the forward's
// bits; an owner keeps its four in d_wx (the output, overwritten below);
// (2) each owner its states again from the chunk's start state (c_ch,
// n_ch, m_ch), keeping in `work` (B, CHUNK, KEPT, D) what the adjoint of
// each step reads: the state entering it, its gates, the new c and n,
// the max's tie share and logf's derivative (so the walk holds no
// transcendental and few registers beside the weights).  Then the walk,
// t from the chunk's end: (3) each owner (row, channel) forms d_pre_t
// for its four gate columns from g_h = dys_t + the recurrent adjoint and
// the carried adjoints of (c, n, m), as autodiff differentiates the
// reference's cell (m's path in, jax's 0.5 at a tie of either max,
// logaddexp's derivative exp(y - softplus(y)) for logf), and writes it to
// d_wx; (4) grid barrier; (5) the block reads its head's
// 4·dh columns of d_pre_t for every row into shared memory and forms the
// recurrent adjoint of its 16 channels' h_{t-1}:
//
//   d_h[b, k·dh + i] = Σ_e rh[k, i, e] · d_pre_t[b, k·4dh + e]
//
// thread (channel r, part p) over e = q·64 + p·4 + {0..3}, its dh/4 weights
// of row i of rh in registers (reloaded each phase: the forward's column
// slice for (1), this row slice for (5)), the 16 parts added in order: the
// same inputs give the same bits on every run.  At t = 0 the carried
// adjoints are the initial state's (dc0, dn0, dm0) and the recurrent one
// its dh0.  d_rh and d_bias are plain products of hs and d_wx outside.
template <int NB, int LEN>
__global__ void __launch_bounds__(THREADS, 1)
slstm_scan_bwd_kernel(const float* __restrict__ wx,
                      const float* rh,  // not restrict: see below
                      const float* __restrict__ bias,
                      const float* __restrict__ h0,
                      const float* __restrict__ hs,
                      const float* __restrict__ c_ch,
                      const float* __restrict__ n_ch,
                      const float* __restrict__ m_ch,
                      const float* __restrict__ dys,
                      const float* __restrict__ dc,
                      const float* __restrict__ dn,
                      const float* __restrict__ dm,
                      const float* __restrict__ dh, float* d_wx,
                      float* __restrict__ dc0, float* __restrict__ dn0,
                      float* __restrict__ dm0, float* __restrict__ dh0,
                      float* __restrict__ work, int S, int D) {
  constexpr int DH = LEN * PARTS;
  constexpr int RPARTS = THREADS / CH;      // threads sharing a row of rh
  extern __shared__ float4 smem4[];
  const int span = D > 4 * DH ? D : 4 * DH;
  float* buf = reinterpret_cast<float*>(smem4);        // [NB][D] or [NB][4DH]
  float* red = buf + static_cast<size_t>(NB) * span;   // [PARTS][NB][COLS]
  float* red2 = red + PARTS * NB * COLS;               // [RPARTS][NB][CH]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * CH;
  const int head = j0 / DH;                 // every channel of the block's
  // (1): column `col`, inputs [part·LEN, (part+1)·LEN), as the forward
  const int col = tid % COLS;
  const int part = tid / COLS;
  const int gcol = (col / CH) * D + j0 + col % CH;
  const int hoff = (gcol / (4 * DH)) * DH + part * LEN;
  // (5): row j0 + rr of rh's head, columns q·64 + rp·4 + {0..3}
  const int rr = tid / RPARTS;
  const int rp = tid % RPARTS;
  // one set of weights in registers at a time, reloaded each phase (rh is
  // not declared restrict, so the compiler cannot hoist both loads out of
  // the chunk loop and keep 2·LEN weights live)
  float w[LEN];

  const bool owner = tid < NB * CH;
  const int ob = tid / CH;
  const int oc = tid % CH;
  const int oj = j0 + oc;
  const size_t st = static_cast<size_t>(ob) * D + oj;
  float g_c = 0.f, g_n = 0.f, g_m = 0.f, g_h = 0.f;
  if (owner) {
    if (dc != nullptr) g_c = dc[st];
    if (dn != nullptr) g_n = dn[st];
    if (dm != nullptr) g_m = dm[st];
    if (dh != nullptr) g_h = dh[st];
  }
  const int nc = (S + CHUNK - 1) / CHUNK;
  const int d4 = D / 4;
  const int e4 = DH;                        // 4·dh floats in float4s
  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * CHUNK;
    const int t1 = t0 + CHUNK < S ? t0 + CHUNK : S;
    // (1) the chunk's pre-activations, in the forward's order
    load_column(w, rh, gcol, part);
    for (int t = t0; t < t1; ++t) {
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const float4* src = reinterpret_cast<const float4*>(
            t == 0 ? h0 + static_cast<size_t>(bb) * D
                   : hs + (static_cast<size_t>(bb) * S + t - 1) * D);
        for (int q = tid; q < d4; q += THREADS) smem4[bb * d4 + q] = src[q];
      }
      __syncthreads();
      column_partials<NB, LEN>(w, buf, red, D, hoff, col, part);
      __syncthreads();
      if (owner) {
        const size_t row = (static_cast<size_t>(ob) * S + t) * 4 * D + oj;
        float xs[4], bs[4], pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          xs[g] = wx[row + g * D];
          bs[g] = bias[g * D + oj];
        }
        form_pre<NB>(pre, red, xs, bs, ob, oc);
#pragma unroll
        for (int g = 0; g < 4; ++g) d_wx[row + g * D] = pre[g];
      }
    }
    // (2) the chunk's states from its start, and what each step's adjoint
    // reads of them
    if (owner) {
      const size_t at = (static_cast<size_t>(ob) * nc + k) * D + oj;
      float c = c_ch[at], n = n_ch[at], m = m_ch[at], h;
      for (int t = t0; t < t1; ++t) {
        float* kept = work
            + (static_cast<size_t>(ob) * CHUNK + t - t0) * KEPT * D + oj;
        kept[0] = c;
        kept[D] = n;
        const size_t row = (static_cast<size_t>(ob) * S + t) * 4 * D + oj;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] = d_wx[row + g * D];
        const Gates gt = slstm_step(pre, c, n, m, h);
        kept[2 * D] = gt.z;
        kept[3 * D] = gt.o;
        kept[4 * D] = gt.ig;
        kept[5 * D] = gt.fg;
        kept[6 * D] = c;
        kept[7 * D] = n;
        // jax's share of max(logf + m, i)'s gradient that goes to logf + m
        kept[8 * D] = gt.lm > pre[1] ? 1.f : (gt.lm == pre[1] ? 0.5f : 0.f);
        // d logf / d f = exp(y - softplus(y)) at y = -f (logaddexp's)
        kept[9 * D] = expf(-pre[2] - gt.sp);
      }
    }
    __syncthreads();
    // this thread's weights of (5): row j0 + rr of rh, its columns
    {
      const float4* src = reinterpret_cast<const float4*>(
          rh + (static_cast<size_t>(head) * DH + (j0 - head * DH) + rr)
                   * (4 * DH));
#pragma unroll
      for (int q = 0; q < LEN / 4; ++q) {
        const float4 v = src[q * RPARTS + rp];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    }
    // the walk back
    for (int t = t1 - 1; t >= t0; --t) {
      if (owner) {                                              // (3)
        const size_t row = (static_cast<size_t>(ob) * S + t) * 4 * D + oj;
        const float* kept = work
            + (static_cast<size_t>(ob) * CHUNK + t - t0) * KEPT * D + oj;
        const float cp = kept[0], np = kept[D], z = kept[2 * D];
        const float o = kept[3 * D], ig = kept[4 * D], fg = kept[5 * D];
        const float c = kept[6 * D], n = kept[7 * D], sel = kept[8 * D];
        const float gh = g_h + dys[(static_cast<size_t>(ob) * S + t) * D + oj];
        const float den = fmaxf(n, 1e-6f);
        const float num = o * c;
        const float d_num = gh / den;
        const float gc = g_c + d_num * o;
        const float tie_n = n > 1e-6f ? 1.f : (n == 1e-6f ? 0.5f : 0.f);
        const float gn = g_n + (-gh * num / (den * den)) * tie_n;
        const float u_f = (gc * cp + gn * np) * fg;
        const float u_i = (gc * z + gn) * ig;
        const float d_m_new = g_m - u_i - u_f;
        const float d_lm = u_f + sel * d_m_new;
        d_wx[row] = gc * ig * (1.f - z * z);
        d_wx[row + D] = u_i + (1.f - sel) * d_m_new;
        d_wx[row + 2 * D] = d_lm * kept[9 * D];
        d_wx[row + 3 * D] = d_num * c * o * (1.f - o);
        g_c = gc * fg;
        g_n = gn * fg;
        g_m = d_lm;
      }
      grid.sync();                                              // (4)
#pragma unroll                                                  // (5)
      for (int bb = 0; bb < NB; ++bb) {
        const float4* src = reinterpret_cast<const float4*>(
            d_wx + (static_cast<size_t>(bb) * S + t) * 4 * D + head * 4 * DH);
        for (int q = tid; q < e4; q += THREADS)
          smem4[bb * e4 + q] = __ldcg(src + q);
      }
      __syncthreads();
      float acc[NB];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) acc[bb] = 0.f;
#pragma unroll
      for (int q = 0; q < LEN / 4; ++q) {
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          const float4 dv = smem4[bb * e4 + q * RPARTS + rp];
          acc[bb] = fmaf(dv.x, w[4 * q], acc[bb]);
          acc[bb] = fmaf(dv.y, w[4 * q + 1], acc[bb]);
          acc[bb] = fmaf(dv.z, w[4 * q + 2], acc[bb]);
          acc[bb] = fmaf(dv.w, w[4 * q + 3], acc[bb]);
        }
      }
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) red2[(rp * NB + bb) * CH + rr] = acc[bb];
      __syncthreads();
      if (owner) {
        float sum = red2[ob * CH + oc];
#pragma unroll
        for (int p = 1; p < RPARTS; ++p) sum += red2[(p * NB + ob) * CH + oc];
        g_h = sum;
      }
    }
    __syncthreads();
  }
  if (owner) {
    dc0[st] = g_c;
    dn0[st] = g_n;
    dm0[st] = g_m;
    dh0[st] = g_h;
  }
}

// The kernels by batch rows and head width (template parameters).
struct Forward {
  template <int NB, int LEN>
  static const void* get() {
    return reinterpret_cast<const void*>(slstm_scan_kernel<NB, LEN>);
  }
};
struct Backward {
  template <int NB, int LEN>
  static const void* get() {
    return reinterpret_cast<const void*>(slstm_scan_bwd_kernel<NB, LEN>);
  }
};

template <class K, int NB>
const void* pick_dh(int dh) {
  switch (dh) {
    case 16: return K::template get<NB, 4>();
    case 32: return K::template get<NB, 8>();
    case 64: return K::template get<NB, 16>();
    case 128: return K::template get<NB, 32>();
    case 256: return K::template get<NB, 64>();
    case 512: return K::template get<NB, 128>();
    default: return nullptr;
  }
}

template <class K>
const void* pick(int B, int dh) {
  switch (B) {
    case 1: return pick_dh<K, 1>(dh);
    case 2: return pick_dh<K, 2>(dh);
    case 3: return pick_dh<K, 3>(dh);
    case 4: return pick_dh<K, 4>(dh);
    case 5: return pick_dh<K, 5>(dh);
    case 6: return pick_dh<K, 6>(dh);
    case 7: return pick_dh<K, 7>(dh);
    case 8: return pick_dh<K, 8>(dh);
    default: return nullptr;
  }
}

// A cooperative launch of D / CH blocks, checked to be co-resident.
int cooperative(const void* kernel, int D, size_t smem, void** args,
                cudaStream_t stream) {
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
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS),
                                    args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The backward's dynamic shared memory: h_{t-1} of every row (B x D) or,
// in the walk, the head's d_pre_t of every row (B x 4dh), whichever is
// larger, then the two phases' partial sums, in floats.
size_t bwd_smem_bytes(int B, int D, int dh) {
  const size_t span = D > 4 * dh ? D : 4 * dh;
  return sizeof(float) * (static_cast<size_t>(B) * span
                          + static_cast<size_t>(PARTS) * B * COLS
                          + static_cast<size_t>(THREADS / CH) * B * CH);
}

// -1 for a shape the kernels do not take (B outside 1..MAX_B, D not a
// multiple of CH or of H, dh = D / H not one of 16, 32, 64, 128, 256,
// 512), else dh.
int head_dim(int B, int D, int H) {
  if (B < 1 || B > MAX_B || H < 1 || D < CH || D % CH != 0 || D % H != 0)
    return -1;
  const int dh = D / H;
  if (dh < 16 || dh > 512 || (dh & (dh - 1)) != 0) return -1;
  return dh;
}

}  // namespace

// Bytes of dynamic shared memory a forward launch at (B, D, H) takes, or
// -1 for a shape the kernel does not take.
extern "C" long long slstm_scan_smem_bytes(int B, int D, int H) {
  if (head_dim(B, D, H) < 0) return -1;
  return static_cast<long long>(smem_bytes(B, D));
}

// The same for the backward.
extern "C" long long slstm_scan_bwd_smem_bytes(int B, int D, int H) {
  const int dh = head_dim(B, D, H);
  if (dh < 0) return -1;
  return static_cast<long long>(bwd_smem_bytes(B, D, dh));
}

// The recurrence over S steps: wx (B, S, 4D), rh (H, D/H, 4D/H), bias
// (4D), the state c0, n0, m0, h0 (B, D) -> hs (B, S, D) and the final
// c, n, m, h (B, D); with c_ch, n_ch, m_ch not null also the state
// entering every chunk of 64 steps, (B, ⌈S/64⌉, D) each (the initial
// state first).  Contiguous float32 on the device; the outputs must not
// alias the inputs.  Returns 0 or the CUDA error of the launch (82,
// cudaErrorCooperativeLaunchTooLarge, when the grid cannot be
// co-resident), -1 for a shape the kernel does not take and -2 when its
// shared memory exceeds a block's.
extern "C" int slstm_scan_f32(const void* wx, const void* rh,
                              const void* bias, const void* c0,
                              const void* n0, const void* m0, const void* h0,
                              void* hs, void* c_out, void* n_out, void* m_out,
                              void* h_out, void* c_ch, void* n_ch,
                              void* m_ch, int B, int S, int D, int H,
                              void* stream) {
  const long long smem = slstm_scan_smem_bytes(B, D, H);
  if (smem < 0 || S < 1) return -1;
  if (static_cast<size_t>(smem) > SMEM_LIMIT) return -2;
  void* args[] = {&wx, &rh, &bias, &c0, &n0, &m0, &h0, &hs, &c_out,
                  &n_out, &m_out, &h_out, &c_ch, &n_ch, &m_ch, &S, &D};
  return cooperative(pick<Forward>(B, D / H), D, static_cast<size_t>(smem),
                     args, static_cast<cudaStream_t>(stream));
}

// The backward from the forward's inputs wx, rh, bias, h0, its hs and
// chunk states (c_ch, n_ch, m_ch), and the cotangents of hs (dys, (B, S,
// D)) and of the final c, n, m, h (each may be null: zeros) -> d_wx (B, S,
// 4D), the cotangents of the initial c, n, m, h (B, D) each.  `work` holds
// B x 64 x 10 x D floats.  Contiguous float32 on the device, no aliasing.
// Returns as slstm_scan_f32 does.
extern "C" int slstm_scan_bwd_f32(
    const void* wx, const void* rh, const void* bias, const void* h0,
    const void* hs, const void* c_ch, const void* n_ch, const void* m_ch,
    const void* dys, const void* dc, const void* dn, const void* dm,
    const void* dh, void* d_wx, void* dc0, void* dn0, void* dm0, void* dh0,
    void* work, int B, int S, int D, int H, void* stream) {
  const long long smem = slstm_scan_bwd_smem_bytes(B, D, H);
  if (smem < 0 || S < 1) return -1;
  if (static_cast<size_t>(smem) > SMEM_LIMIT) return -2;
  void* args[] = {&wx, &rh, &bias, &h0, &hs, &c_ch, &n_ch, &m_ch, &dys,
                  &dc, &dn, &dm, &dh, &d_wx, &dc0, &dn0, &dm0, &dh0, &work,
                  &S, &D};
  return cooperative(pick<Backward>(B, D / H), D, static_cast<size_t>(smem),
                     args, static_cast<cudaStream_t>(stream));
}
