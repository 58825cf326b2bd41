// RWKV6 chunked wkv recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel _wkv_kernel
// (repro/kernels/rwkv_scan.py:21, called by rwkv_scan :57).  Same
// function, in f32, per (batch b, head h): with cum the inclusive
// cumulative sum of logw over a run of tokens and cx = cum - logw,
//   A[t][s] = sum_i r[t][i] k[s][i] exp(cx[t][i] - cum[s][i])   (t > s)
//   A[t][t] = sum_i r[t][i] u[i] k[t][i]
//   o[t][j] = sum_{s<=t} A[t][s] v[s][j] + sum_i r[t][i] exp(cx[t][i]) S[i][j]
//   S[i][j] <- exp(cum[L-1][i]) S[i][j]
//              + sum_s k[s][i] exp(cum[L-1][i] - cum[s][i]) v[s][j]
// Every exponent is a difference of cumulative log-decays, <= 0.
//
// Bound on this card: bytes, about 220 MB of r/k/v/logw/o/state at
// rwkv6-3b's prefill shape (B=8, S=512, H=40, dk=dv=64, chunk 32;
// 0.066 ms at 3.35 TB/s) against 4 GFLOP (0.060 ms at 67 TFLOP/s): the
// two are close, and each (b, h) is a chain of dependent steps.
//
// The design (the redesign for Hopper; the first port walked a chunk of
// 32 tokens in six phases of scalar FMAs fed from shared memory, one exp
// per score term):
//   * steps of L tokens, L the largest divisor of the chunk up to 16: the
//     identity the reference uses across chunks, anchoring the scores of
//     a later sub-chunk at the cumulative decay before it, is applied at
//     every L tokens, so the off-diagonal sub-blocks of a chunk's scores
//     are carried by the state product r~ S that the step computes anyway
//     (the same sum, associated as r~ (k~^T v) instead of (r~ k~^T) v);
//   * inside a step the same identity again, at every level: a pair s < t
//     whose highest differing index bit is b is anchored at the last
//     token of the lower half of its 2^(b+1)-block, so its score is the
//     dot of two rows scaled by factors <= 1 (hat_b, below); the scan
//     lanes compute them from registers, one exp a token, column and
//     level (three levels at L = 16: 4,096 exps a step where one a pair
//     and column took 7,680), and the scores are plain dots of two rows
//     (two floats a term read from shared memory, where six were);
//   * exps are ex2.approx on log-decays scaled by log2(e) once, before
//     the cumulative sums;
//   * the cumulative sums are warp scans (16 lanes a key column, four
//     columns side by side) kept as double-floats in registers; every
//     exponent is a difference of two of them, so a large decay early in
//     a step costs no precision in the terms after it (with one f32 sum,
//     at logw = -exp(N(0, 2)), the kernel was 1.5e-2 off the float64
//     recurrence, the plain chunk form 4.3e-3; now 3.7e-5: PERF.md);
//   * the scores: one pair a lane pair, the key columns in two
//     interleaved halves (their 16-byte loads in different banks), four
//     partial sums a lane; the diagonal r u k by the block's other lanes;
//   * the products, o = [A | r~] [v ; S] (K = L + dk) and k~^T v: at
//     64 x 64 with steps of 8 or 16 tokens on the tensor cores as 3xTF32
//     mma.sync (tf32_mma.cuh, f32 accuracy; warp w the o columns
//     8w..8w+7, and a 16 x 32 tile of the state), the three products in
//     their own accumulators; at other widths on 4 x 4 register tiles of
//     f32 FMAs (one warp-uniform 16-byte load of [A | r~]^T and one of
//     [v ; S] for 16 FMAs, the K range cut in KP <= 3 parts summed
//     through shared memory); the mma path measured 0.349 ms against
//     0.401 for the FMA tiles at rwkv6-3b's shape (H100 80GB HBM3,
//     700 W);
//   * the next step's r/k/logw/v are copied by cp.async into the second
//     of two buffers while this step is computed;
//   * four barriers a step: landed; scans, decays and anchored rows;
//     scores; products; then the partials' sum and the state update.
// What bounds it now: the SM's pipes over 32 dependent steps a (b, h)
// (scripts/wkv_sweep.py on an H100 80GB HBM3 at 700 W, of 0.349 ms:
// no scan rounds 0.300, single-f32
// scans 0.311, no anchored rows 0.309, no scores 0.284, no output
// product 0.273, no state update 0.308; the scans beside the previous
// step's state update, three barriers a step, read 0.353-0.358).  Next:
// a state pass parallel over steps.
// Occupancy at rwkv6-3b's shape: one 256-thread block per (b, h), 320
// blocks; 73 KB of shared memory and at most 85 registers a thread
// (80 used, a few spilled) let three blocks share an SM
// (rwkv_scan_blocks_per_sm), so the 320 blocks run in one wave on the
// 132 SMs (56 of them hold three blocks, 76 two; two an SM, two waves,
// measured 0.416 ms).  The v columns are not split across blocks: that
// would compute each step's scores twice.
//
// The states variant (rwkv_scan_states_f32, STATES): the same kernel
// also copies the state at the start of every step to states[B, H,
// S / L, dk, dv] (entry 0 is s0), what the backward kernel
// (rwkv_scan_bwd.cu) starts each of its steps from.  The copy reads the
// state in shared memory between two barriers that already order it, and
// changes no arithmetic: o and sT are the unflagged kernel's, bit for bit.
//
// Layouts (row-major, contiguous, 16-byte aligned): r/k/logw [B, S, H, dk],
// v/o [B, S, H, dv], u [H, dk], s0/sT [B, H, dk, dv], all f32.
// dk, dv multiples of 4; the chunk (<= 64) divides S.

#include <cmath>

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStep = 16;     // tokens a step (one scan segment of 16 lanes)
constexpr int kMaxChunk = 64;
constexpr int kMaxParts = 3;     // K parts of the output product
constexpr float kLog2e = 1.4426950408889634f;

// The step's shared-memory layout, in floats (every region a multiple of
// 4 floats, so 16-byte aligned).  ldk pads the key-width rows by 4.
// ldv pads the value-width rows by 8 and ldx the rows of [A | r~]^T by 8
// floats: the mma fragments' loads then hit 32 distinct banks.
struct Layout {
  int ldk, ldv, tp, ldx, buf, h1, h2, kt, x, s, u, wl, total;
  __host__ __device__ Layout(int l, int dk, int dv) {
    ldk = dk + 4;
    ldv = dv + 8;
    tp = (l + 3) & ~3;
    ldx = tp + 8;
    buf = 3 * l * ldk + l * ldv;      // r, k, logw ([L][ldk] each), v [L][ldv]
    h1 = 2 * buf;                     // [L][ldk] anchored rows, level 1
    h2 = h1 + l * ldk;                // [L][ldk] ... level 2 (level 3: logw's rows)
    kt = h2 + l * ldk;                // [L][ldk] k * 2^(P[L-1] - P)
    x = kt + l * ldk;                 // [L + dk][ldx]: A^T, then (r * 2^cx)^T
    s = x + (l + dk) * ldx;           // [dk][ldv] state
    u = s + dk * ldv;                 // [dk]
    wl = u + dk;                      // [dk] 2^(cum[L-1])
    total = wl + dk;
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (hi, lo) += (yh, yl) as double-float: hi + lo keeps the sum to about
// 2^-44 of its size (two-sum of the hi parts, the lo parts added in)
__device__ __forceinline__ void df_add(float& hi, float& lo, float yh, float yl) {
  const float s = __fadd_rn(hi, yh);
  const float bp = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bp)), __fsub_rn(yh, bp));
  const float l = __fadd_rn(__fadd_rn(lo, yl), e);
  hi = __fadd_rn(s, l);
  lo = __fsub_rn(l, __fsub_rn(hi, s));
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

__device__ __forceinline__ float at(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// acc[a][b] += x[a] * y[b]
__device__ __forceinline__ void outer(float (*acc)[4], const float4& x,
                                      const float4& y) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float xa = at(x, a);
    acc[a][0] = fmaf(xa, y.x, acc[a][0]);
    acc[a][1] = fmaf(xa, y.y, acc[a][1]);
    acc[a][2] = fmaf(xa, y.z, acc[a][2]);
    acc[a][3] = fmaf(xa, y.w, acc[a][3]);
  }
}

// DK, DV: the key and value widths when fixed at compile time (rwkv6's
// 64 x 64, so that every loop over them unrolls), or 0 for any.  MMA:
// the products on 3xTF32 mma.sync (64 x 64 and steps of 8 or 16 tokens),
// else on 4 x 4 FMA tiles.  STATES: also write each step's starting state.
template <int DK, int DV, bool MMA, bool STATES = false>
__global__ void __launch_bounds__(kThreads, 3)
rwkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ o, float* __restrict__ sT, int seq,
                 int h, int dk_, int dv_, int step, int parts,
                 float* __restrict__ states) {
  extern __shared__ __align__(16) float smem[];
  const int dk = DK ? DK : dk_, dv = DV ? DV : dv_;
  const Layout lay(step, dk, dv);
  const int ldk = lay.ldk, ldv = lay.ldv, tp = lay.tp, ldx = lay.ldx, L = step;
  float* h1_s = smem + lay.h1;
  float* h2_s = smem + lay.h2;
  float* kt_s = smem + lay.kt;
  float* x_s = smem + lay.x;
  float* st_s = smem + lay.s;
  float* u_s = smem + lay.u;
  float* wl_s = smem + lay.wl;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int dk4 = dk / 4, dv4 = dv / 4;
  const int n_steps = seq / L;
  const size_t row_k = (size_t)h * dk, row_v = (size_t)h * dv;   // token strides

  // step c's r/k/logw/v into buffer c & 1
  auto issue = [&](int c) {
    float* buf = smem + (c & 1) * lay.buf;
    const size_t tok0 = (size_t)b * seq + (size_t)c * L;
    for (int e = tid; e < L * dk4; e += kThreads) {
      const int t = e / dk4, i = (e - t * dk4) * 4;
      const size_t g = (tok0 + t) * row_k + (size_t)hh * dk + i;
      cp16(buf + t * ldk + i, r + g);
      cp16(buf + (L + t) * ldk + i, k + g);
      cp16(buf + (2 * L + t) * ldk + i, logw + g);
    }
    for (int e = tid; e < L * dv4; e += kThreads) {
      const int t = e / dv4, j = (e % dv4) * 4;
      cp16(buf + 3 * L * ldk + t * ldv + j,
           v + (tok0 + t) * row_v + (size_t)hh * dv + j);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue(0);

  for (int e = tid; e < dk * dv; e += kThreads)
    st_s[(e / dv) * ldv + e % dv] = s0[(size_t)bh * dk * dv + e];
  for (int i = tid; i < dk; i += kThreads) u_s[i] = u[(size_t)hh * dk + i];
  // A^T above the diagonal and the columns past L stay zero
  for (int e = tid; e < (L + dk) * ldx; e += kThreads) x_s[e] = 0.f;

  const int n_pairs = L * (L - 1) / 2;        // s < t
  const int n_rg = tp / 4;
  const int kdim = L + dk;

  for (int c = 0; c < n_steps; ++c) {
    float* buf = smem + (c & 1) * lay.buf;
    float* r_s = buf;
    float* k_s = buf + L * ldk;
    float* w_s = buf + 2 * L * ldk;           // logw
    float* v_s = buf + 3 * L * ldk;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();                          // step c landed; step c-1 done
    if (c + 1 < n_steps) issue(c + 1);
    if constexpr (STATES) {
      // the state before step c; the next write to it follows two barriers
      float* dst = states + ((size_t)bh * n_steps + c) * dk * dv;
      for (int e = tid; e < dk * dv; e += kThreads)
        dst[e] = st_s[(e / dv) * ldv + e % dv];
    }

    // The scan lanes: 16 lanes a key column (lane t token t), kScanCols
    // columns side by side.  Inclusive cumulative log2-decays P[t] as
    // double-floats by a warp scan, kept in registers; every exponent is a
    // difference of two of them (df_sub), exact where they are close.  From
    // them, in this phase:
    //   * the decays: (r * 2^P[t-1])^T into A^T's lower rows, k~ = k *
    //     2^(P[L-1] - P[t]), 2^P[L-1];
    //   * the anchored rows of the scores: a pair s < t whose highest
    //     differing index bit is b > 0 is anchored at m, the last token of
    //     the lower half of its 2^(b+1)-block: its decay 2^(P[t-1] - P[s])
    //     = 2^(P[t-1] - P[m]) 2^(P[m] - P[s]), both factors <= 1, so A[t][s]
    //     = sum_i hat_b[t][i] hat_b[s][i] with hat_b[t] = r[t] 2^(P[t-1] -
    //     P[m]) in the upper half and hat_b[s] = k[s] 2^(P[m] - P[s]) in
    //     the lower (an underflow drops a term smaller than the factor
    //     that underflowed).  At b = 0 (t = s + 1, s even) the decay is
    //     2^0: r and k as they are.  One exp a token, column and level,
    //     where the pair form took one a pair and column.
    // hat_3 lives in this step's logw rows (each lane overwrites the
    // element it read).
    auto hat_s = [&](int b) { return b == 1 ? h1_s : b == 2 ? h2_s : w_s; };
    {
      constexpr int kScanCols = 4;
      const int t = lane & 15;
      int n_bits = 0;                       // index bits of the step's tokens
      while ((1 << n_bits) < L) ++n_bits;
      for (int i0 = 2 * warp; i0 < dk; i0 += 2 * kScanCols * (kThreads / 32)) {
        float hi[kScanCols], lo[kScanCols], rv[kScanCols], kv[kScanCols];
#pragma unroll
        for (int n = 0; n < kScanCols; ++n) {
          const int i = i0 + n * 2 * (kThreads / 32) + (lane >> 4);
          const bool ok = t < L && i < dk;
          hi[n] = ok ? w_s[t * ldk + i] * kLog2e : 0.f;
          lo[n] = 0.f;
          rv[n] = ok ? r_s[t * ldk + i] : 0.f;
          kv[n] = ok ? k_s[t * ldk + i] : 0.f;
        }
#pragma unroll
        for (int off = 1; off < kMaxStep; off <<= 1) {
#pragma unroll
          for (int n = 0; n < kScanCols; ++n) {
            const float yh = __shfl_up_sync(0xffffffffu, hi[n], off, 16);
            const float yl = __shfl_up_sync(0xffffffffu, lo[n], off, 16);
            if (t >= off) df_add(hi[n], lo[n], yh, yl);
          }
        }
        float ph[kScanCols], pl[kScanCols];
#pragma unroll
        for (int n = 0; n < kScanCols; ++n) {
          const int i = i0 + n * 2 * (kThreads / 32) + (lane >> 4);
          ph[n] = __shfl_up_sync(0xffffffffu, hi[n], 1, 16);     // P[t-1]
          pl[n] = __shfl_up_sync(0xffffffffu, lo[n], 1, 16);
          if (t == 0) ph[n] = pl[n] = 0.f;
          const float eh = __shfl_sync(0xffffffffu, hi[n], L - 1, 16);   // P[L-1]
          const float el = __shfl_sync(0xffffffffu, lo[n], L - 1, 16);
          if (t < L && i < dk) {
            x_s[(L + i) * ldx + t] = rv[n] * ex2(ph[n] + pl[n]);
            kt_s[t * ldk + i] = kv[n] * ex2(df_sub(eh, el, hi[n], lo[n]));
            if (t == 0) wl_s[i] = ex2(eh + el);
          }
        }
        // the levels outside, the columns inside: independent chains
        for (int b = 1; b < n_bits; ++b) {
          const bool upper = (t >> b) & 1;
          const int m = upper ? ((t >> b) << b) - 1 : (t | ((1 << b) - 1));
          float* hat = hat_s(b);
#pragma unroll
          for (int n = 0; n < kScanCols; ++n) {
            const int i = i0 + n * 2 * (kThreads / 32) + (lane >> 4);
            const float mh = __shfl_sync(0xffffffffu, hi[n], m, 16);
            const float ml = __shfl_sync(0xffffffffu, lo[n], m, 16);
            if (t < L && i < dk)
              hat[t * ldk + i] = upper ? rv[n] * ex2(df_sub(ph[n], pl[n], mh, ml))
                                       : kv[n] * ex2(df_sub(mh, ml, hi[n], lo[n]));
          }
        }
      }
    }
    __syncthreads();

    // scores: pair p < n_pairs is (t, s), s < t, its key columns cut in
    // two interleaved halves of 16-byte groups (adjacent lanes, so their
    // loads sit in different banks; summed by one shuffle): the dot of
    // its level's anchored rows.  The L diagonal entries r u k after
    // them, a thread each.  Four partial sums a thread, one a column of
    // the float4, for independent chains.
    for (int q0 = 0; q0 < 2 * n_pairs + L; q0 += kThreads) {
      const int q = q0 + tid;
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      int t = 0, s = 0;
      const int part = q & 1;
      if (q < 2 * n_pairs) {
        const int p = q >> 1;
        t = (int)((sqrtf(8.f * (float)p + 1.f) + 1.f) * 0.5f);
        while (t * (t - 1) / 2 > p) --t;
        while ((t + 1) * t / 2 <= p) ++t;
        s = p - t * (t - 1) / 2;
        const int b = 31 - __clz(t ^ s);
        const float* ra = (b ? hat_s(b) : r_s) + t * ldk;
        const float* kb = (b ? hat_s(b) : k_s) + s * ldk;
#pragma unroll 4
        for (int i = 4 * part; i < dk; i += 8) {
          const float4 a = ld4(ra + i), kk = ld4(kb + i);
          a4[0] = fmaf(a.x, kk.x, a4[0]);
          a4[1] = fmaf(a.y, kk.y, a4[1]);
          a4[2] = fmaf(a.z, kk.z, a4[2]);
          a4[3] = fmaf(a.w, kk.w, a4[3]);
        }
      } else if (q < 2 * n_pairs + L) {
        t = s = q - 2 * n_pairs;
        const float* rt = r_s + t * ldk;
        const float* kt = k_s + t * ldk;
#pragma unroll 4
        for (int i = 0; i < dk; i += 4) {
          const float4 a = ld4(rt + i), kk = ld4(kt + i), uu = ld4(u_s + i);
          a4[0] = fmaf(a.x * uu.x, kk.x, a4[0]);
          a4[1] = fmaf(a.y * uu.y, kk.y, a4[1]);
          a4[2] = fmaf(a.z * uu.z, kk.z, a4[2]);
          a4[3] = fmaf(a.w * uu.w, kk.w, a4[3]);
        }
      }
      float acc = (a4[0] + a4[1]) + (a4[2] + a4[3]);
      // a pair's halves sit in lanes 2m, 2m + 1 (2 n_pairs is even)
      const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
      if (q < 2 * n_pairs) {
        if (part == 0) x_s[s * ldx + t] = acc + other;
      } else if (q < 2 * n_pairs + L) {
        x_s[t * ldx + t] = acc;
      }
    }
    __syncthreads();

    // o = [A | r~] [v ; S]
    const size_t tok0 = (size_t)b * seq + (size_t)c * L;
    float* red = buf;
    if constexpr (MMA) {
      // o = [A | r~] [v ; S] as m16n8k8 products: warp w the columns
      // 8w..8w+7 of every row, K = L + 64 in steps of 8 (each step's rows
      // all in v or all in S: L is a multiple of 8)
      // the three products in their own accumulators (independent
      // chains), summed at the end as (lo hi + hi lo) + hi hi
      const int g = lane >> 2, tg = lane & 3, n0 = 8 * warp;
      float acc[3][4] = {};
#pragma unroll 2
      for (int kk0 = 0; kk0 < kdim; kk0 += 8) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        const float* xa = x_s + (kk0 + tg) * ldx + g;
        split(xa[0], ah[0], al[0]);
        split(xa[8], ah[1], al[1]);
        split(xa[4 * ldx], ah[2], al[2]);
        split(xa[4 * ldx + 8], ah[3], al[3]);
        const float* yb = (kk0 < L ? v_s + (kk0 + tg) * ldv
                                   : st_s + (kk0 - L + tg) * ldv) + n0 + g;
        split(yb[0], bh[0], bl[0]);
        split(yb[4 * ldv], bh[1], bl[1]);
        mma_tf32(acc[0], al, bh);
        mma_tf32(acc[1], ah, bl);
        mma_tf32(acc[2], ah, bh);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][e] = (acc[0][e] + acc[1][e]) + acc[2][e];
      const size_t col = (size_t)hh * dv + n0 + 2 * tg;
      if (g < L)
        *reinterpret_cast<float2*>(o + (tok0 + g) * row_v + col) =
            make_float2(acc[0][0], acc[0][1]);
      if (g + 8 < L)
        *reinterpret_cast<float2*>(o + (tok0 + g + 8) * row_v + col) =
            make_float2(acc[0][2], acc[0][3]);
    } else {
      // o = [A | r~] [v ; S]: 4 x 4 tiles (rows rg, columns cg), K cut in
      // `parts`; the partials go to `red` (this step's r/k/logw, read no
      // more) unless there is one part
      for (int item = tid; item < parts * n_rg * dv4; item += kThreads) {
        const int cg = item % dv4, rest = item / dv4;
        const int rg = rest % n_rg, kp = rest / n_rg;
        const int kk0 = kp * kdim / parts, kk1 = (kp + 1) * kdim / parts;
        float acc[4][4] = {};
#pragma unroll 4
        for (int kk = kk0; kk < kk1; ++kk) {
          const float4 xa = ld4(x_s + kk * ldx + 4 * rg);
          const float4 yb = ld4(kk < L ? v_s + kk * ldv + 4 * cg
                                       : st_s + (kk - L) * ldv + 4 * cg);
          outer(acc, xa, yb);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int t = 4 * rg + a;
          const float4 out = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
          if (parts == 1) {
            if (t < L)
              *reinterpret_cast<float4*>(o + (tok0 + t) * row_v + (size_t)hh * dv +
                                         4 * cg) = out;
          } else {
            *reinterpret_cast<float4*>(red + ((size_t)kp * tp + t) * dv + 4 * cg) = out;
          }
        }
      }
    }
    __syncthreads();

    // the partials' sum, and S <- 2^cum[L-1] S + k~^T v
    if (!MMA && parts > 1) {
      for (int e = tid; e < L * dv4; e += kThreads) {
        const int t = e / dv4, j = (e % dv4) * 4;
        float4 sum = ld4(red + t * dv + j);
        for (int kp = 1; kp < parts; ++kp) {
          const float4 y = ld4(red + ((size_t)kp * tp + t) * dv + j);
          sum.x += y.x;
          sum.y += y.y;
          sum.z += y.z;
          sum.w += y.w;
        }
        *reinterpret_cast<float4*>(o + (tok0 + t) * row_v + (size_t)hh * dv + j) = sum;
      }
    }
    if constexpr (MMA) {
      // S <- 2^cum[L-1] S + k~^T v as m16n8k8 products: warp w the rows
      // 16 (w / 2).. and the columns 32 (w % 2).., four n-tiles
      const int g = lane >> 2, tg = lane & 3;
      const int m0 = 16 * (warp >> 1), nb = 32 * (warp & 1);
      float acc[4][3][4] = {};
      for (int k0 = 0; k0 < L; k0 += 8) {
        uint32_t ah[4], al[4];
        const float* ka = kt_s + (k0 + tg) * ldk + m0 + g;
        split(ka[0], ah[0], al[0]);
        split(ka[8], ah[1], al[1]);
        split(ka[4 * ldk], ah[2], al[2]);
        split(ka[4 * ldk + 8], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bh[2], bl[2];
          const float* yb = v_s + (k0 + tg) * ldv + nb + 8 * n + g;
          split(yb[0], bh[0], bl[0]);
          split(yb[4 * ldv], bh[1], bl[1]);
          mma_tf32(acc[n][0], al, bh);
          mma_tf32(acc[n][1], ah, bl);
          mma_tf32(acc[n][2], ah, bh);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = m0 + g + 8 * half;
          float2* sp = reinterpret_cast<float2*>(st_s + i * ldv + nb + 8 * n + 2 * tg);
          const float2 old = *sp;
          const float w = wl_s[i];
          const int e = 2 * half;
          *sp = make_float2(
              fmaf(w, old.x, (acc[n][0][e] + acc[n][1][e]) + acc[n][2][e]),
              fmaf(w, old.y, (acc[n][0][e + 1] + acc[n][1][e + 1]) + acc[n][2][e + 1]));
        }
      }
    } else {
      for (int item = tid; item < dk4 * dv4; item += kThreads) {
        const int ig = item / dv4, cg = item % dv4;
        float acc[4][4] = {};
#pragma unroll 4
        for (int s = 0; s < L; ++s)
          outer(acc, ld4(kt_s + s * ldk + 4 * ig), ld4(v_s + s * ldv + 4 * cg));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float* srow = st_s + (4 * ig + a) * ldv + 4 * cg;
          const float4 old = ld4(srow);
          const float w = wl_s[4 * ig + a];
          *reinterpret_cast<float4*>(srow) =
              make_float4(fmaf(w, old.x, acc[a][0]), fmaf(w, old.y, acc[a][1]),
                          fmaf(w, old.z, acc[a][2]), fmaf(w, old.w, acc[a][3]));
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < dk * dv; e += kThreads)
    sT[(size_t)bh * dk * dv + e] = st_s[(e / dv) * ldv + e % dv];
}

// Returns cudaGetLastError() right after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take (including
// one whose tiles do not fit in a block's shared memory).  states: null,
// or [B, H, S / step, dk, dv] for the states variant.
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* o, void* sT, void* states,
           int b, int seq, int h, int dk, int dv, int chunk, void* stream) {
  if (b < 1 || h < 1 || seq < 1 || chunk < 1 || chunk > kMaxChunk ||
      seq % chunk || dk < 4 || dk % 4 || dv < 4 || dv % 4)
    return (int)cudaErrorInvalidValue;
  // the step: the largest divisor of the chunk up to kMaxStep
  int step = chunk < kMaxStep ? chunk : kMaxStep;
  while (chunk % step) --step;
  const Layout lay(step, dk, dv);
  // K parts of the output product: as many as the step's r/k/logw hold
  int parts = 3 * step * lay.ldk / (lay.tp * dv);
  parts = parts < 1 ? 1 : parts > kMaxParts ? kMaxParts : parts;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)lay.total;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  // the mma instantiation: 64 x 64 and steps of a multiple of 8 tokens
  const bool fixed = dk == 64 && dv == 64 && step % 8 == 0;
  auto kernel = fixed ? rwkv_scan_kernel<64, 64, true>
                      : rwkv_scan_kernel<0, 0, false>;
  static int smem_set[4] = {0, 0, 0, 0};     // largest size allowed so far
  if (states != nullptr)
    kernel = fixed ? rwkv_scan_kernel<64, 64, true, true>
                   : rwkv_scan_kernel<0, 0, false, true>;
  const int which = (int)fixed + 2 * (states != nullptr);
  if ((int)smem > smem_set[which] && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[which] = (int)smem;
  }
  kernel<<<(unsigned)(b * h), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(sT), seq, h, dk, dv, step,
      parts, static_cast<float*>(states));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rwkv_scan_f32(const void* r, const void* k, const void* v, const void* logw,
                  const void* u, const void* s0, void* o, void* sT, int b,
                  int seq, int h, int dk, int dv, int chunk, void* stream) {
  return launch(r, k, v, logw, u, s0, o, sT, nullptr, b, seq, h, dk, dv, chunk,
                stream);
}

// rwkv_scan_f32 that also writes states [B, H, S / step, dk, dv], step the
// largest divisor of the chunk up to 16.
int rwkv_scan_states_f32(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s0,
                         void* o, void* sT, void* states, int b, int seq, int h,
                         int dk, int dv, int chunk, void* stream) {
  if (states == nullptr) return (int)cudaErrorInvalidValue;
  return launch(r, k, v, logw, u, s0, o, sT, states, b, seq, h, dk, dv, chunk,
                stream);
}

// Blocks of the kernel an SM holds at this shape (the occupancy the
// card reports), or minus a cudaError_t.
int rwkv_scan_blocks_per_sm(int dk, int dv, int chunk) {
  if (chunk < 1 || chunk > kMaxChunk || dk < 4 || dk % 4 || dv < 4 || dv % 4)
    return -(int)cudaErrorInvalidValue;
  int step = chunk < kMaxStep ? chunk : kMaxStep;
  while (chunk % step) --step;
  const size_t smem = sizeof(float) * (size_t)Layout(step, dk, dv).total;
  const bool fixed = dk == 64 && dv == 64 && step % 8 == 0;
  auto kernel = fixed ? rwkv_scan_kernel<64, 64, true>
                      : rwkv_scan_kernel<0, 0, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // extern "C"
