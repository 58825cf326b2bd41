// RWKV6 wkv backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package takes this gradient by
// autodiff of its plain chunked form wkv_chunked (repro/models/rwkv6.py:56;
// its Pallas _wkv_kernel, repro/kernels/rwkv_scan.py:21, has no backward).
// The forward it differentiates is rwkv_scan.cu: per (batch b, head h),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   w_t = exp(logw_t).
// Given do [B, S, H, dv] and dsT [B, H, dk, dv] it writes dr, dk, dlogw
// [B, S, H, dk], dv [B, S, H, dv], ds0 [B, H, dk, dv] and du [H, dk],
// summed over the batch.  kernels/ref.py's wkv_chunked_bwd_ref is its
// plain version (the formulas there), wkv_bwd_chunks_emulated its plan
// (wkv_grad_states_ref the state pass).
//
// The design: the chunk-parallel backward of gated linear attention, in
// steps of L tokens (the forward's step: the largest divisor of the chunk
// up to 16), with only the gradient of the state on a chain.  Three
// launches on the caller's stream:
//   1. the state pass (rwkv_scan_bwd_state_kernel): per (b, h) and 32
//      rows of G (the rows of G are independent), a block walks the
//      steps in reverse with G alone: G <- 2^cum[L-1] G + (r 2^cx)^T dO,
//      from G = dsT; a thread holds one 4-column quad of 4 rows in
//      registers, a warp stores whole rows of G after each step to gs
//      [B, H, S / L, dk, dv] (entry S / L - 1 unwritten: that G is dsT)
//      and ds0; the block's last warp takes the next step's cumulative
//      log2-decays meanwhile (one barrier a step); a 4-slot cp.async ring
//      keeps three steps of rows in flight.
//   2. the chunk pass (rwkv_scan_bwd_chunk_kernel): one 256-thread block
//      per (b, h, step), none waiting on another, from the step's rows,
//      its starting state S0 (the forward's states variant,
//      rwkv_scan_states_f32) and G after the step (pass 1):
//        * cumulative log2-decays as double-floats (4 lanes a key column,
//          a shuffle scan); every exponent is a difference of two of
//          them, <= 0 (masked pairs are never formed), so exps never
//          overflow and no decay is divided by;
//        * the scores A[t][s] = sum_i r k 2^(cx[t] - cum[s]) (s < t), a
//          lane pair a pair (the key columns in two interleaved halves),
//          A[t][t] = r u k, and dP = dO V^T, a thread an entry;
//        * dV = [A^T | k~] [dO ; G], dr' = 2^cx (dO S0^T) and
//          dk' = 2^(cum[L-1] - cum) (V G^T): at 64 x 64 and steps of 8 or
//          16 on the tensor cores as 3xTF32 mma.sync (tf32_mma.cuh, f32
//          accuracy; warp w the 8 columns 8w.. of each product, S0's rows
//          read from global straight into B fragments), else 4 x 4
//          register tiles of f32 FMAs;
//        * the pair sums dr'[t] += sum_{s<t} dP k D, dk'[s] += sum_{t>s}
//          dP r D, D = 2^(cx[t] - cum[s]), 256 / dk threads a key column
//          (their dk' shares summed by shuffles);
//        * dlogw by the identity of gated linear attention, with no
//          division: dcum[t] = r[t+1] dr'[t+1] - k[t] dk'[t], plus at the
//          step's last token rho = rowsum(S_end * G) with S_end =
//          2^cum[L-1] S0 + k~^T V, so rho = 2^cum[L-1] rowsum(S0 * G) +
//          sum_t k dk'_state (the state after the step is never read);
//          dlogw the suffix sum, one thread a column walking the step
//          backwards, which also writes dr, dk and the step's du share.
//      Blocks are numbered step-major, so the gradient states the state
//      pass wrote last (the first steps) are read first, from L2.
//   3. du (rwkv_scan_bwd_du_kernel): the (b, h, step) shares summed in a
//      fixed order, each (b, h)'s steps from the last back, then the batch
//      in order: no float atomics, so two runs are bit-equal.
// Bound on this card (the function's own I/O and operations, whatever
// computes it): bytes, about 0.39 GB of r/k/v/logw/dO in and
// dr/dk/dv/dlogw out at rwkv6-3b's B = 8, S = 512, H = 40, dk = dv = 64
// (0.117 ms at 3.35 TB/s) against 6.8 GFLOP of f32 (0.102 ms at 67
// TFLOP/s); chip_smoke.py computes both.  The design adds scratch bytes:
// the forward's step states read once (84 MB at B = 4), the gradient
// states written and read once (2 x 81 MB).
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/redesign_check.py
// wkv-bwd, in turns with the first design, a block a (b, h) walking every
// step's whole work, kept in scripts/csrc/rwkv_scan_bwd_pr25.cu): 0.342
// ms at B = 4 (first design 0.701), 0.681 at B = 8 (1.382), 5.8x the byte
// bound.  What bounds it now (scripts/wkv_bwd_sweep.py at B = 4): the
// chunk pass, 0.28 ms of it, three blocks an SM (70 KB of shared memory,
// 80 registers) issuing about one instruction a cycle of four: a block's
// 36,600 cycles split loads and cumulative sums 31%, scores and dP 21%,
// products 17%, pair sums 25%, column pass 6%; the state pass 0.063 ms
// (its G stores and the byte traffic of gs); du 0.010.
//
// Layouts (row-major, contiguous, 16-byte aligned, f32): as rwkv_scan.cu,
// states and gs [B, H, S / L, dk, dv], ws [B, H, S / L, dk] (the du
// shares).  dk, dv multiples of 4; L divides S.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;         // chunk pass
constexpr int kMaxStep = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x - y for double-floats, rounded to f32
__device__ __forceinline__ float df_sub(float xh, float xl, float yh, float yl) {
  return __fadd_rn(__fsub_rn(xh, yh), __fsub_rn(xl, yl));
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float x, float y, float z, float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}

// acc[a][n] += sum_{kk in [k0, k1)} X(m0 + a, kk) Y(kk, n0 + n), k0 and k1
// multiples of 4.  X(m, kk) = x[kk * ldx + m] when XK (stored k-major),
// else x[m * ldx + kk]; Y(kk, n) = y[kk * ldy + n] when YK, else
// y[n * ldy + kk].  Eight 16-byte loads a 64 FMAs.
template <bool XK, bool YK>
__device__ __forceinline__ void tile(float (*acc)[4], const float* x, int ldx,
                                     const float* y, int ldy, int m0, int n0,
                                     int k0, int k1) {
  for (int kk = k0; kk < k1; kk += 4) {
    float xs[4][4], ys[4][4];           // xs[a][c] = X(m0+a, kk+c), ys[c][n]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (XK) {
        const float4 t = ld4(x + (kk + q) * ldx + m0);
        xs[0][q] = t.x; xs[1][q] = t.y; xs[2][q] = t.z; xs[3][q] = t.w;
      } else {
        const float4 t = ld4(x + (m0 + q) * ldx + kk);
        xs[q][0] = t.x; xs[q][1] = t.y; xs[q][2] = t.z; xs[q][3] = t.w;
      }
      if (YK) {
        const float4 t = ld4(y + (kk + q) * ldy + n0);
        ys[q][0] = t.x; ys[q][1] = t.y; ys[q][2] = t.z; ys[q][3] = t.w;
      } else {
        const float4 t = ld4(y + (n0 + q) * ldy + kk);
        ys[0][q] = t.x; ys[1][q] = t.y; ys[2][q] = t.z; ys[3][q] = t.w;
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[a][n] = fmaf(xs[a][c], ys[c][n], acc[a][n]);
  }
}

// Threads a key column in the pair sums: a power of two up to 16, as many
// as 256 threads hold.
__host__ __device__ constexpr int q_cols(int dk) {
  int q = 1;
  while (q < 16 && 2 * q * dk <= kThreads) q <<= 1;
  return q;
}

// f(std::integral_constant<int, m>) for m = 0..N-1, unrolled
template <int N, class F, int... M>
__device__ __forceinline__ void unrolled(F&& f, std::integer_sequence<int, M...>) {
  (f(std::integral_constant<int, M>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void unrolled(F&& f) {
  unrolled<N>(f, std::make_integer_sequence<int, N>{});
}

// a (lane pair, or thread) index p into the pair (t, s) of a step: the
// pairs s < t when !DIAG (p < L (L - 1) / 2), s <= t when DIAG
template <bool DIAG>
__device__ __forceinline__ void pair_of(int p, int& t, int& s) {
  const int d = DIAG ? 1 : 0;        // t's row holds t + d pairs
  t = (int)((sqrtf(8.f * (float)p + 1.f) + (DIAG ? -1.f : 1.f)) * 0.5f);
  while (t * (t - 1 + 2 * d) / 2 > p) --t;
  while ((t + 1) * (t + 2 * d) / 2 <= p) ++t;
  s = p - t * (t - 1 + 2 * d) / 2;
}

struct Args {
  const float *r, *k, *v, *logw, *u, *states, *d_o, *dsT;
  float *g_r, *g_k, *g_v, *g_w, *g_u, *g_s0, *gs, *ws;  // dr dk dv dlogw du ds0
  int b, seq, h, dk, dv, step;
};

// ---------------------------------------------------------------------------
// 1. the state pass
// ---------------------------------------------------------------------------

// A block holds kRows rows of G (every value column) of one (b, h): thread
// (row group, quad) owns a 4-column quad of 4 rows in registers (a token's
// dO quad and r~ of 4 rows, two 16-byte loads, feed 16 FMAs), and a warp's
// stores of G after each step are whole rows, contiguous.  The block's
// last warp takes its rows' key columns (a lane each) one step ahead: the
// cumulative log2-decays as double-floats, r~ = r 2^cx and 2^cum[L-1]
// into a double buffer, so one barrier a step orders both.  Shared memory,
// in floats: a ring of kStages slots, each a step's dO rows [L][dv] and
// its r and logw columns [L][kRows]; then r~ [2][L][kRows] and 2^cum[L-1]
// [2][kRows].
constexpr int kRows = 32;
constexpr int kStages = 4;

__host__ __device__ inline int state_threads(int dv) { return kRows / 4 * (dv / 4) + 32; }

__host__ __device__ inline int state_slot(int l, int dv) { return l * dv + 2 * l * kRows; }

__host__ __device__ inline int state_smem_floats(int l, int dv) {
  return kStages * state_slot(l, dv) + 2 * l * kRows + 2 * kRows;
}

// (hi, lo) += y as double-float: hi + lo keeps the sum to about 2^-44 of
// its size (a two-sum, the error folded into lo)
__device__ __forceinline__ void df_add(float& hi, float& lo, float yh, float yl = 0.f) {
  const float s = __fadd_rn(hi, yh);
  const float bp = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bp)), __fsub_rn(yh, bp));
  const float l = __fadd_rn(__fadd_rn(lo, yl), e);
  hi = __fadd_rn(s, l);
  lo = __fsub_rn(l, __fsub_rn(hi, s));
}

template <int DV>
__global__ void __launch_bounds__(DV ? kRows / 4 * (DV / 4) + 32 : 1024)
rwkv_scan_bwd_state_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dk = a.dk, dv = DV ? DV : a.dv, L = a.step, h = a.h;
  const int dv4 = dv / 4, n_threads = state_threads(dv), n_upd = n_threads - 32;
  const int slot = state_slot(L, dv);
  float* RT = smem + kStages * slot;
  float* WL = RT + 2 * L * kRows;
  const int tid = threadIdx.x;
  const int n_rb = (dk + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_rb, i0 = (blockIdx.x % n_rb) * kRows;
  const int b = bh / h, hh = bh % h;
  const int rows = min(kRows, dk - i0), rows4 = rows / 4;
  const int n_steps = a.seq / L;
  const size_t row_k = (size_t)h * dk, row_v = (size_t)h * dv;   // token strides
  const size_t state = (size_t)dk * dv;

  // step c's dO rows and r, logw columns into slot c % kStages (a group
  // committed even when c < 0, so wait_group counts steps)
  auto issue = [&](int c) {
    if (c >= 0) {
      float* p = smem + (c % kStages) * slot;
      const size_t tok0 = (size_t)b * a.seq + (size_t)c * L;
      for (int e = tid; e < L * dv4; e += n_threads) {
        const int t = e / dv4, j = (e - t * dv4) * 4;
        cp16(p + t * dv + j, a.d_o + (tok0 + t) * row_v + (size_t)hh * dv + j);
      }
      for (int e = tid; e < L * rows4; e += n_threads) {
        const int t = e / rows4, x = (e - t * rows4) * 4;
        const size_t gi = (tok0 + t) * row_k + (size_t)hh * dk + i0 + x;
        cp16(p + L * dv + t * kRows + x, a.r + gi);
        cp16(p + L * dv + (L + t) * kRows + x, a.logw + gi);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // the last warp, lane l: column i0 + l's r~ and 2^cum[L-1] of step c
  auto cumsum = [&](int c) {
    const int l = tid - n_upd;
    if (l < 0 || l >= rows) return;
    const float* p = smem + (c % kStages) * slot + L * dv + l;
    float rr[kMaxStep], ww[kMaxStep];
#pragma unroll
    for (int t = 0; t < kMaxStep; ++t) {
      rr[t] = t < L ? p[t * kRows] : 0.f;
      ww[t] = t < L ? p[(L + t) * kRows] * kLog2e : 0.f;
    }
    float* rt = RT + (c & 1) * L * kRows + l;
    float hi = 0.f, lo = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxStep; ++t) {
      if (t < L) rt[t * kRows] = rr[t] * ex2(__fadd_rn(hi, lo));
      df_add(hi, lo, ww[t]);
    }
    WL[(c & 1) * kRows + l] = ex2(__fadd_rn(hi, lo));
  };

  const int rg = tid / dv4, q = tid - rg * dv4;
  const bool owner = tid < n_upd && 4 * rg < rows;
  float4 g[4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
    g[x] = owner ? ld4(a.dsT + bh * state + (size_t)(i0 + 4 * rg + x) * dv + 4 * q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  issue(n_steps - 1);
  issue(n_steps - 2);
  issue(n_steps - 3);
  asm volatile("cp.async.wait_group 2;\n" ::);
  __syncthreads();
  cumsum(n_steps - 1);

  for (int c = n_steps - 1; c >= 0; --c) {
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();         // steps c, c - 1 landed; r~ of step c written
    issue(c - 3);
    if (owner) {
      // G <- 2^cum[L-1] G + r~^T dO on the thread's quad of rows
      // i0 + 4 rg.. + 3; then G after step c - 1 (ds0 after step 0) out
      const float* d = smem + (c % kStages) * slot + 4 * q;
      const float* rt = RT + (c & 1) * L * kRows + 4 * rg;
      float4 acc[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[x] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < kMaxStep; ++t) {
        if (t < L) {
          const float4 rx = ld4(rt + t * kRows);
          const float4 y = ld4(d + t * dv);
          const float xs[4] = {rx.x, rx.y, rx.z, rx.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            acc[x].x = fmaf(xs[x], y.x, acc[x].x);
            acc[x].y = fmaf(xs[x], y.y, acc[x].y);
            acc[x].z = fmaf(xs[x], y.z, acc[x].z);
            acc[x].w = fmaf(xs[x], y.w, acc[x].w);
          }
        }
      }
      const float4 w4 = ld4(WL + (c & 1) * kRows + 4 * rg);
      const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
      float* dst = (c > 0 ? a.gs + ((size_t)bh * n_steps + c - 1) * state
                          : a.g_s0 + bh * state) + (size_t)(i0 + 4 * rg) * dv + 4 * q;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        g[x] = make_float4(fmaf(ws[x], g[x].x, acc[x].x), fmaf(ws[x], g[x].y, acc[x].y),
                           fmaf(ws[x], g[x].z, acc[x].z), fmaf(ws[x], g[x].w, acc[x].w));
        *reinterpret_cast<float4*>(dst + (size_t)x * dv) = g[x];
      }
    }
    if (c > 0) cumsum(c - 1);
  }
}

// ---------------------------------------------------------------------------
// 2. the chunk pass
// ---------------------------------------------------------------------------

// In floats (every region a multiple of 4 floats).  Rows of L tokens are
// padded to tp (16 on the mma path, else a multiple of 4), zeros in the
// arrays the products read (dr' and dk' are read at t < L only); ldk
// and ldv pad the key- and value-width rows by 4 floats (the fragment
// loads of dO, V, k~ and G^T then hit 32 banks), lda the score rows by 8
// (those of A^T).  ch, cl: the cumulative log2-decays cum[t] (the sum over
// the tokens before t, t = 0..L) as double-floats, [L + 1][ldc] each (ldc
// pads the rows by 4: the score lanes read rows t and s of a column).
struct ChunkLayout {
  int tp, ldk, ldv, lda, ldc, r, k, v, d_o, g, kt, kdec, cxf, drx, dkx, a, dp, u, wl,
      rs, kd, ch, cl, total;
  __host__ __device__ ChunkLayout(int l, int dk, int dv, bool mma) {
    tp = mma ? 16 : (l + 3) & ~3;
    ldk = dk + 4;
    ldv = dv + 4;
    lda = tp + 8;
    ldc = dk + 4;
    r = 0;
    k = r + tp * ldk;
    v = k + tp * ldk;
    d_o = v + tp * ldv;
    g = d_o + tp * ldv;        // [dk][ldv] G after the step
    kt = g + dk * ldv;         // [tp][ldk] k~ = k * kdec
    kdec = kt + tp * ldk;      // [tp][ldk] 2^(cum[L] - cum[t+1])
    cxf = kdec + tp * ldk;     // [tp][ldk] 2^cum[t]
    drx = cxf + tp * ldk;      // [tp][ldk] dr'
    dkx = drx + tp * ldk;      // [tp][ldk] dk'
    a = dkx + tp * ldk;        // [tp][lda] A[t][s]
    dp = a + tp * lda;         // [tp][lda] dP[t][s] = dO_t . v_s
    u = dp + tp * lda;         // [dk]
    wl = u + dk;               // [dk] 2^cum[L]
    rs = wl + dk;              // [dk] rowsum(S0 * G)
    kd = rs + dk;              // [dk] sum_t k dk'_state
    ch = kd + dk;
    cl = ch + (l + 1) * ldc;
    total = cl + (l + 1) * ldc;
  }
};

// DK, DV: the widths when fixed at compile time (rwkv6's 64 x 64), or 0.
// MMA: the products on 3xTF32 mma.sync (64 x 64, steps of 8 or 16).
template <int DK, int DV, bool MMA>
__global__ void __launch_bounds__(kThreads, 3) rwkv_scan_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dk = DK ? DK : a.dk, dv = DV ? DV : a.dv, L = a.step, h = a.h;
  const ChunkLayout lay(L, dk, dv, MMA);
  const int tp = lay.tp, ldk = lay.ldk, ldv = lay.ldv, lda = lay.lda, ldc = lay.ldc;
  float* R = smem + lay.r;
  float* K = smem + lay.k;
  float* V = smem + lay.v;
  float* DO = smem + lay.d_o;
  float* G = smem + lay.g;
  float* KT = smem + lay.kt;
  float* KDEC = smem + lay.kdec;
  float* CXF = smem + lay.cxf;
  float* DRX = smem + lay.drx;
  float* DKX = smem + lay.dkx;
  float* A = smem + lay.a;
  float* DP = smem + lay.dp;
  float* U = smem + lay.u;
  float* WL = smem + lay.wl;
  float* RS = smem + lay.rs;
  float* KD = smem + lay.kd;
  float* CH = smem + lay.ch;
  float* CL = smem + lay.cl;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_steps = a.seq / L, n_bh = a.b * h;
  const int c = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;   // step-major
  const int b = bh / h, hh = bh % h;
  const int dk4 = dk / 4, dv4 = dv / 4;
  const size_t row_k = (size_t)h * dk, row_v = (size_t)h * dv;   // token strides
  const size_t state = (size_t)dk * dv;
  const size_t tok0 = (size_t)b * a.seq + (size_t)c * L;
  const float* s0 = a.states + ((size_t)bh * n_steps + c) * state;
  const float* g_end = c + 1 < n_steps ? a.gs + ((size_t)bh * n_steps + c) * state
                                       : a.dsT + bh * state;

  // the step's rows by cp.async
  for (int e = tid; e < L * dk4; e += kThreads) {
    const int t = e / dk4, i = (e - t * dk4) * 4;
    const size_t gi = (tok0 + t) * row_k + (size_t)hh * dk + i;
    cp16(R + t * ldk + i, a.r + gi);
    cp16(K + t * ldk + i, a.k + gi);
  }
  for (int e = tid; e < L * dv4; e += kThreads) {
    const int t = e / dv4, j = (e - t * dv4) * 4;
    const size_t gi = (tok0 + t) * row_v + (size_t)hh * dv + j;
    cp16(V + t * ldv + j, a.v + gi);
    cp16(DO + t * ldv + j, a.d_o + gi);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // G, needed from the products on, in a group of its own
  for (int e = tid; e < dk * dv4; e += kThreads) {
    const int i = e / dv4, j = (e - i * dv4) * 4;
    cp16(G + i * ldv + j, g_end + (size_t)i * dv + j);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // zeros: A and dP (the upper triangle stays zero), the padded rows
  for (int e = tid; e < 2 * tp * lda; e += kThreads) A[e] = 0.f;
  for (int e = tid; e < (tp - L) * ldk; e += kThreads) {
    const int o = L * ldk + e;
    R[o] = K[o] = KT[o] = KDEC[o] = CXF[o] = 0.f;
  }
  for (int e = tid; e < (tp - L) * ldv; e += kThreads) V[L * ldv + e] = DO[L * ldv + e] = 0.f;
  for (int i = tid; i < dk; i += kThreads) U[i] = a.u[(size_t)hh * dk + i];
  // the cumulative log2-decays as double-floats (logw read from global):
  // QC lanes a key column, lane p the tokens [p tpt, (p + 1) tpt), the
  // lanes' totals scanned by shuffles; cum[t] (as ch, cl), 2^cum[t],
  // 2^(cum[L] - cum[t+1]), 2^cum[L]
  {
    const int QC = q_cols(dk), tpt = (L + QC - 1) / QC, p = tid % QC;
    for (int i0 = 0; i0 < dk; i0 += kThreads / QC) {
      const int i = i0 + tid / QC;
      const bool ok = i < dk;
      float lw[kMaxStep];
#pragma unroll
      for (int x = 0; x < kMaxStep; ++x) {
        const int t = p * tpt + x;
        lw[x] = ok && x < tpt && t < L
                    ? __ldg(a.logw + (tok0 + t) * row_k + (size_t)hh * dk + i) * kLog2e
                    : 0.f;
      }
      float oh = 0.f, ol = 0.f;          // the lane's sum, then the scan's
#pragma unroll
      for (int x = 0; x < kMaxStep; ++x) df_add(oh, ol, lw[x]);
      for (int off = 1; off < QC; off <<= 1) {
        const float yh = __shfl_up_sync(0xffffffffu, oh, off, QC);
        const float yl = __shfl_up_sync(0xffffffffu, ol, off, QC);
        if (p >= off) df_add(oh, ol, yh, yl);
      }
      const float eh = __shfl_sync(0xffffffffu, oh, QC - 1, QC);   // cum[L]
      const float el = __shfl_sync(0xffffffffu, ol, QC - 1, QC);
      float ch = __shfl_up_sync(0xffffffffu, oh, 1, QC);          // cum at the
      float cl = __shfl_up_sync(0xffffffffu, ol, 1, QC);          // lane's first
      if (p == 0) ch = cl = 0.f;
#pragma unroll
      for (int x = 0; x < kMaxStep; ++x) {
        const int t = p * tpt + x;
        if (ok && x < tpt && t < L) {
          CH[t * ldc + i] = ch;
          CL[t * ldc + i] = cl;
          CXF[t * ldk + i] = ex2(__fadd_rn(ch, cl));
          df_add(ch, cl, lw[x]);
          KDEC[t * ldk + i] = ex2(df_sub(eh, el, ch, cl));
        }
      }
      if (ok && p == 0) {
        CH[L * ldc + i] = eh;
        CL[L * ldc + i] = el;
        WL[i] = ex2(__fadd_rn(eh, el));
      }
    }
  }
  asm volatile("cp.async.wait_group 1;\n" ::);   // the rows (G may be in flight)
  __syncthreads();

  // k~; then the scores A (pairs s < t: a lane pair each, the key columns
  // in two interleaved halves of 16-byte groups summed by a shuffle; the
  // diagonal r u k) and dP[t][s] = dO_t . v_s (s <= t), a thread each
  for (int e = tid; e < L * dk; e += kThreads) {
    const int t = e / dk, i = e - t * dk;
    KT[t * ldk + i] = K[t * ldk + i] * KDEC[t * ldk + i];
  }
  {
    const int n_pairs = L * (L - 1) / 2, n_a = 2 * n_pairs;
    const int n_items = n_a + L + n_pairs + L;
    for (int q0 = 0; q0 < n_items; q0 += kThreads) {
      const int q = q0 + tid;
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      int t = 0, s = 0;
      const int part = q & 1;
      if (q < n_a) {
        pair_of<false>(q >> 1, t, s);
        const float* rt = R + t * ldk;
        const float* ks = K + s * ldk;
        const float* cth = CH + t * ldc;
        const float* ctl = CL + t * ldc;
        const float* csh = CH + (s + 1) * ldc;
        const float* csl = CL + (s + 1) * ldc;
#pragma unroll 2
        for (int i = 4 * part; i < dk; i += 8) {
          const float4 x = ld4(rt + i), y = ld4(ks + i);
          const float4 xh = ld4(cth + i), xl = ld4(ctl + i);
          const float4 yh = ld4(csh + i), yl = ld4(csl + i);
          a4[0] = fmaf(x.x * y.x, ex2(df_sub(xh.x, xl.x, yh.x, yl.x)), a4[0]);
          a4[1] = fmaf(x.y * y.y, ex2(df_sub(xh.y, xl.y, yh.y, yl.y)), a4[1]);
          a4[2] = fmaf(x.z * y.z, ex2(df_sub(xh.z, xl.z, yh.z, yl.z)), a4[2]);
          a4[3] = fmaf(x.w * y.w, ex2(df_sub(xh.w, xl.w, yh.w, yl.w)), a4[3]);
        }
      } else if (q < n_a + L) {
        t = s = q - n_a;
        const float* rt = R + t * ldk;
        const float* kt = K + t * ldk;
        for (int i = 0; i < dk; i += 4) {
          const float4 x = ld4(rt + i), y = ld4(kt + i), uu = ld4(U + i);
          a4[0] = fmaf(x.x * uu.x, y.x, a4[0]);
          a4[1] = fmaf(x.y * uu.y, y.y, a4[1]);
          a4[2] = fmaf(x.z * uu.z, y.z, a4[2]);
          a4[3] = fmaf(x.w * uu.w, y.w, a4[3]);
        }
      } else if (q < n_items) {
        pair_of<true>(q - n_a - L, t, s);
        const float* ot = DO + t * ldv;
        const float* vs = V + s * ldv;
        for (int j = 0; j < dv; j += 4) {
          const float4 x = ld4(ot + j), y = ld4(vs + j);
          a4[0] = fmaf(x.x, y.x, a4[0]);
          a4[1] = fmaf(x.y, y.y, a4[1]);
          a4[2] = fmaf(x.z, y.z, a4[2]);
          a4[3] = fmaf(x.w, y.w, a4[3]);
        }
      }
      const float acc = (a4[0] + a4[1]) + (a4[2] + a4[3]);
      // a pair's halves sit in lanes 2m, 2m + 1 (n_a is even)
      const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
      if (q < n_a) {
        if (part == 0) A[t * lda + s] = acc + other;
      } else if (q < n_a + L) {
        A[t * lda + t] = acc;
      } else if (q < n_items) {
        DP[t * lda + s] = acc;
      }
    }
  }
  // the mma path: warp w's B fragments of S0^T (rows 8w + g of S0), read
  // from global while the block meets at the barrier
  const int g8 = lane >> 2, tg = lane & 3;
  float s0f[MMA ? 16 : 1];
  if constexpr (MMA) {
    const float* row = s0 + (size_t)(8 * warp + g8) * 64 + tg;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      s0f[2 * kk] = __ldg(row + 8 * kk);
      s0f[2 * kk + 1] = __ldg(row + 8 * kk + 4);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);   // G
  __syncthreads();

  // the products: dV = [A^T | k~] [dO ; G] (out), dr' = 2^cx (dO S0^T),
  // dk' = kdec (V G^T); rowsum(S0 * G)
  if constexpr (MMA) {
    // m16n8k8 on 3xTF32: warp w the columns n0 = 8w.. of each product (the
    // three partial products in their own accumulators, summed as
    // (lo hi + hi lo) + hi hi); rows t = g and g + 8
    const int n0 = 8 * warp;
    auto mma3 = [](float (*acc)[4], const float* a4, const float* b2) {
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a4[e], ah[e], al[e]);
      split(b2[0], bh[0], bl[0]);
      split(b2[1], bh[1], bl[1]);
      mma_tf32(acc[0], al, bh);
      mma_tf32(acc[1], ah, bl);
      mma_tf32(acc[2], ah, bh);
    };
    {
      float acc[3][4] = {};
      for (int k0 = 0; k0 < L; k0 += 8) {           // A^T: X(t, s) = A[s][t]
        const float* xa = A + (k0 + tg) * lda + g8;
        const float xf[4] = {xa[0], xa[8], xa[4 * lda], xa[4 * lda + 8]};
        const float* yb = DO + (k0 + tg) * ldv + n0 + g8;
        const float yf[2] = {yb[0], yb[4 * ldv]};
        mma3(acc, xf, yf);
      }
#pragma unroll 2
      for (int k0 = 0; k0 < 64; k0 += 8) {          // k~ G
        const float* xa = KT + g8 * ldk + k0 + tg;
        const float xf[4] = {xa[0], xa[8 * ldk], xa[4], xa[8 * ldk + 4]};
        const float* yb = G + (k0 + tg) * ldv + n0 + g8;
        const float yf[2] = {yb[0], yb[4 * ldv]};
        mma3(acc, xf, yf);
      }
      const size_t col = (size_t)hh * dv + n0 + 2 * tg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = g8 + 8 * half, e = 2 * half;
        if (t < L)
          *reinterpret_cast<float2*>(a.g_v + (tok0 + t) * row_v + col) =
              make_float2((acc[0][e] + acc[1][e]) + acc[2][e],
                          (acc[0][e + 1] + acc[1][e + 1]) + acc[2][e + 1]);
      }
    }
    // dO S0^T and V G^T: X(t, j) rows of dO / V; Y(j, i) = S0[i][j] (the
    // fragments read above) / G[i][j]
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* X = which == 0 ? DO : V;
      float acc[3][4] = {};
      float rs = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k0 = 8 * kk;
        const float* xa = X + g8 * ldv + k0 + tg;
        const float xf[4] = {xa[0], xa[8 * ldv], xa[4], xa[8 * ldv + 4]};
        const float* gr = G + (n0 + g8) * ldv + k0 + tg;
        if (which == 0) {
          const float yf[2] = {s0f[2 * kk], s0f[2 * kk + 1]};
          mma3(acc, xf, yf);
          rs = fmaf(s0f[2 * kk], gr[0], rs);
          rs = fmaf(s0f[2 * kk + 1], gr[4], rs);
        } else {
          const float yf[2] = {gr[0], gr[4]};
          mma3(acc, xf, yf);
        }
      }
      float* out = which == 0 ? DRX : DKX;
      const float* f = which == 0 ? CXF : KDEC;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = g8 + 8 * half, e = 2 * half;
        if (t < L) {
          const int o = t * ldk + n0 + 2 * tg;
          out[o] = f[o] * ((acc[0][e] + acc[1][e]) + acc[2][e]);
          out[o + 1] = f[o + 1] * ((acc[0][e + 1] + acc[1][e + 1]) + acc[2][e + 1]);
        }
      }
      if (which == 0) {
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        if (tg == 0) RS[n0 + g8] = rs;
      }
    }
  } else {
    const int ntm = tp / 4, n_v = ntm * dv4, n_k = ntm * dk4;
    for (int item = tid; item < n_v + 2 * n_k; item += kThreads) {
      float acc[4][4] = {};
      if (item < n_v) {
        const int m0 = 4 * (item / dv4), n0 = 4 * (item % dv4);
        tile<true, true>(acc, A, lda, DO, ldv, m0, n0, 0, tp);
        tile<false, true>(acc, KT, ldk, G, ldv, m0, n0, 0, dk);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (m0 + x < L)
            st4(a.g_v + (tok0 + m0 + x) * row_v + (size_t)hh * dv + n0, acc[x][0],
                acc[x][1], acc[x][2], acc[x][3]);
      } else {
        const bool is_r = item < n_v + n_k;
        const int e = item - n_v - (is_r ? 0 : n_k);
        const int m0 = 4 * (e / dk4), n0 = 4 * (e % dk4);
        if (is_r)
          tile<false, false>(acc, DO, ldv, s0, dv, m0, n0, 0, dv);
        else
          tile<false, false>(acc, V, ldv, G, ldv, m0, n0, 0, dv);
        float* out = is_r ? DRX : DKX;
        const float* f = is_r ? CXF : KDEC;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = m0 + x;
          if (t >= L) continue;
#pragma unroll
          for (int n = 0; n < 4; ++n) out[t * ldk + n0 + n] = f[t * ldk + n0 + n] * acc[x][n];
        }
      }
    }
    for (int i = tid; i < dk; i += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < dv; ++j) acc = fmaf(s0[(size_t)i * dv + j], G[i * ldv + j], acc);
      RS[i] = acc;
    }
  }
  __syncthreads();

  // the pair sums: dr'[t] += sum_{s<t} dP k D, dk'[s] += sum_{t>s} dP r D,
  // D = 2^(cx[t] - cum[s]); Q threads a key column, token t in lane t % Q;
  // first sum_t k dk'_state (the end state's share of rho)
  {
    const int Q = q_cols(dk), col_pass = kThreads / Q, q = tid % Q;
    for (int i0 = 0; i0 < dk; i0 += col_pass) {
      const int i = i0 + tid / Q;
      const bool ok = i < dk;
      float dkp[kMaxStep];
#pragma unroll
      for (int s = 0; s < kMaxStep; ++s) dkp[s] = 0.f;
      float kd = 0.f;
      // token t's pairs s < t, the walk over s unrolled up to n_s
      auto walk = [&](int t, auto n_s) {
        const float rt = R[t * ldk + i];
        const float ch = CH[t * ldc + i], cl = CL[t * ldc + i];
        kd = fmaf(K[t * ldk + i], DKX[t * ldk + i], kd);
        float dr = 0.f;
#pragma unroll
        for (int s = 0; s < decltype(n_s)::value; ++s) {
          if (s < t) {
            const float p = DP[t * lda + s] *
                            ex2(df_sub(ch, cl, CH[(s + 1) * ldc + i], CL[(s + 1) * ldc + i]));
            dr = fmaf(p, K[s * ldk + i], dr);
            dkp[s] = fmaf(p, rt, dkp[s]);
          }
        }
        DRX[t * ldk + i] += dr;
      };
      if (ok) {
        if constexpr (DK != 0) {
          // Q fixed: the lane's m-th token t = q + Q m walks s < Q (m + 1)
          constexpr int QF = q_cols(DK);
          unrolled<kMaxStep / QF>([&](auto m) {
            constexpr int M = decltype(m)::value;
            if (q + QF * M < L) walk(q + QF * M, std::integral_constant<int, QF * (M + 1)>{});
          });
        } else {
          for (int t = q; t < L; t += Q) walk(t, std::integral_constant<int, kMaxStep>{});
        }
      }
      for (int off = 1; off < Q; off <<= 1) {
#pragma unroll
        for (int s = 0; s < kMaxStep; ++s)
          dkp[s] += __shfl_xor_sync(0xffffffffu, dkp[s], off);
        kd += __shfl_xor_sync(0xffffffffu, kd, off);
      }
      if (ok) {
#pragma unroll
        for (int s = 0; s < kMaxStep; ++s)
          if (s < L && s % Q == q) DKX[s * ldk + i] += dkp[s];
        if (q == 0) KD[i] = kd;
      }
    }
  }
  __syncthreads();

  // a thread a column: dlogw (the suffix sums from rho), dr, dk, du's share
  for (int i = tid; i < dk; i += kThreads) {
    const float ui = U[i];
    float acc = fmaf(WL[i], RS[i], KD[i]), du = 0.f;
    for (int t = L - 1; t >= 0; --t) {
      const float rt = R[t * ldk + i], kt = K[t * ldk + i];
      const float drn = DRX[t * ldk + i], dkn = DKX[t * ldk + i];
      const float dpd = DP[t * lda + t];
      if (t + 1 < L) acc = fmaf(R[(t + 1) * ldk + i], DRX[(t + 1) * ldk + i], acc);
      acc = fmaf(-kt, dkn, acc);
      const size_t gi = (tok0 + t) * row_k + (size_t)hh * dk + i;
      a.g_w[gi] = acc;
      a.g_r[gi] = fmaf(ui * kt, dpd, drn);
      a.g_k[gi] = fmaf(ui * rt, dpd, dkn);
      du = fmaf(rt * kt, dpd, du);
    }
    a.ws[((size_t)bh * n_steps + c) * dk + i] = du;
  }
}

// ---------------------------------------------------------------------------
// 3. du
// ---------------------------------------------------------------------------

// du[h] = sum over the batch in order of (sum of the (b, h, step) shares
// from the last step back).  A block a head and 32 key columns:
// threadIdx.y = b % kDuRows sums one batch row's steps (its loads
// unrolled, so they are in flight together), then row 0 adds the
// kDuRows rows in order.
constexpr int kDuRows = 8;

__global__ void __launch_bounds__(32 * kDuRows) rwkv_scan_bwd_du_kernel(const Args a) {
  __shared__ float rows[kDuRows][32];
  const int hh = blockIdx.x, n_steps = a.seq / a.step;
  const int i = blockIdx.y * 32 + threadIdx.x, y = threadIdx.y;
  float total = 0.f;
  for (int b0 = 0; b0 < a.b; b0 += kDuRows) {
    const int bb = b0 + y;
    if (bb < a.b && i < a.dk) {
      const float* w = a.ws + ((size_t)bb * a.h + hh) * n_steps * a.dk + i;
      float s = w[(size_t)(n_steps - 1) * a.dk];
#pragma unroll 8
      for (int c = n_steps - 2; c >= 0; --c) s += w[(size_t)c * a.dk];
      rows[y][threadIdx.x] = s;
    }
    __syncthreads();
    if (y == 0 && i < a.dk)
      for (int r = 0; r < kDuRows && b0 + r < a.b; ++r)
        total = b0 + r == 0 ? rows[r][threadIdx.x] : total + rows[r][threadIdx.x];
    __syncthreads();
  }
  if (y == 0 && i < a.dk) a.g_u[(size_t)hh * a.dk + i] = total;
}

// The chunk kernel's products run on the tensor cores (3xTF32 mma.sync) at
// this shape (ref.wkv_mma_products), on FMA tiles otherwise.
__host__ inline bool chunk_mma(int dk, int dv, int step) {
  return dk == 64 && dv == 64 && step % 8 == 0;
}

// Allow `kernel` `smem` bytes of dynamic shared memory (once per size
// above the default 48 KB); `largest` caches the size allowed so far.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, int& largest) {
  if ((int)smem <= largest || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) largest = (int)smem;
  return err;
}

}  // namespace

extern "C" {

// The gradient of rwkv_scan_f32 (see above).  states: the forward's states
// variant at step `step` (the largest divisor of its chunk up to 16); gs
// [B, H, S / step, dk, dv] and ws [B, H, S / step, dk] scratch.  Launches
// the three kernels on `stream` and returns the first cudaGetLastError()
// that is not cudaSuccess (0 when all three launched), or
// cudaErrorInvalidValue for a shape the kernels do not take (one whose
// step does not fit in a block's shared memory included).
int rwkv_scan_bwd_f32(const void* r, const void* k, const void* v,
                      const void* logw, const void* u, const void* states,
                      const void* d_o, const void* dsT, void* dr, void* dk_out,
                      void* dv_out, void* dlogw, void* du, void* ds0, void* gs,
                      void* ws, int b, int seq, int h, int dk, int dv, int step,
                      void* stream) {
  if (b < 1 || h < 1 || seq < 1 || step < 1 || step > kMaxStep || seq % step ||
      dk < 4 || dk % 4 || dv < 4 || dv % 4 || state_threads(dv) > 1024 ||
      gs == nullptr || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool mma = chunk_mma(dk, dv, step);
  const size_t smem_state = sizeof(float) * (size_t)state_smem_floats(step, dv);
  const size_t smem_chunk = sizeof(float) * (size_t)ChunkLayout(step, dk, dv, mma).total;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem_state > (size_t)max_smem || smem_chunk > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  auto state_kernel = dv == 64 ? rwkv_scan_bwd_state_kernel<64>
                               : rwkv_scan_bwd_state_kernel<0>;
  auto chunk_kernel = mma ? rwkv_scan_bwd_chunk_kernel<64, 64, true>
                          : rwkv_scan_bwd_chunk_kernel<0, 0, false>;
  static int state_set[2] = {0, 0}, chunk_set[2] = {0, 0};   // largest allowed
  if ((err = allow_smem(state_kernel, smem_state, state_set[dv == 64])) != cudaSuccess ||
      (err = allow_smem(chunk_kernel, smem_chunk, chunk_set[mma])) != cudaSuccess)
    return (int)err;
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.logw = static_cast<const float*>(logw);
  a.u = static_cast<const float*>(u);
  a.states = static_cast<const float*>(states);
  a.d_o = static_cast<const float*>(d_o);
  a.dsT = static_cast<const float*>(dsT);
  a.g_r = static_cast<float*>(dr);
  a.g_k = static_cast<float*>(dk_out);
  a.g_v = static_cast<float*>(dv_out);
  a.g_w = static_cast<float*>(dlogw);
  a.g_u = static_cast<float*>(du);
  a.g_s0 = static_cast<float*>(ds0);
  a.gs = static_cast<float*>(gs);
  a.ws = static_cast<float*>(ws);
  a.b = b;
  a.seq = seq;
  a.h = h;
  a.dk = dk;
  a.dv = dv;
  a.step = step;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n_rb = (unsigned)((dk + kRows - 1) / kRows);
  state_kernel<<<(unsigned)(b * h) * n_rb, state_threads(dv), smem_state, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  chunk_kernel<<<(unsigned)(b * h) * (unsigned)(seq / step), kThreads, smem_chunk, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rwkv_scan_bwd_du_kernel<<<dim3((unsigned)h, (unsigned)((dk + 31) / 32)), dim3(32, kDuRows), 0,
                            s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
