// The wkv backward's first design, kept for comparison with
// src/repro_torch/kernels/csrc/rwkv_scan_bwd.cu on the card
// (scripts/redesign_check.py wkv-bwd).  Not part of the package: the
// package's build never compiles it.  One block per (batch, head) walks
// the sequence's steps in reverse with every piece of a step's work on
// that chain, f32 FMA tiles, synchronous loads; du's batch shares are
// merged by the head's last block (a ticket).  Its C entry point takes
// ws [B, H, dk] and n_tickets >= H zeroed uint32 tickets.
//
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
// plain version (the formulas there).
//
// The design (a first one: right and simple, not yet fast):
//   * one 256-thread block per (b, h) walks the sequence in reverse, in
//     steps of L tokens (the forward's step: the largest divisor of the
//     chunk up to 16), starting each step from the state the forward's
//     states variant wrote there (rwkv_scan_states_f32), so no state is
//     rebuilt backwards by dividing by a decay (w reaches ~1e-22 at
//     logw = -exp(N(0, 2)));
//   * G, the gradient of the state after the step, and the step's
//     starting state S0 live in shared memory; G <- 2^cum[L-1] G + (r
//     2^cx)^T dO in place at the end of the step (ds0 after the last);
//   * cumulative log2-decays in double precision (one thread a key
//     column); every exponent is a difference of two of them, <= 0
//     (masked pairs are never formed), so exps never overflow;
//   * the scores A[t][s] = sum_i r k 2^(cx[t] - cum[s]) and dP = dO V^T,
//     a thread a pair; the pair sums dr'[t] = sum_{s<t} dP k 2^.. and
//     dk'[s] = sum_{t>s} dP r 2^.. by 256 / dk threads a column (their
//     dk' shares summed by shuffles, each written by one lane);
//   * the products dV = A^T dO + k~ G, dO S0^T, V G^T and r~^T dO on 4 x
//     4 register tiles of f32 FMAs from shared memory;
//   * dlogw by the identity of gated linear attention, with no division:
//     dcum[t] = r[t+1] dr'[t+1] - k[t] dk'[t] (+ rowsum(S_end * G_end) at
//     the step's last token), dlogw the suffix sum over the step, one
//     thread a column walking the step backwards;
//   * du: each block's share in a fixed order, then the last block of a
//     head (a ticket) sums the B shares in batch order: no float atomics,
//     so two runs are bit-equal.
// Bound on this card: bytes (about 0.39 GB of r/k/v/logw/dO in and
// dr/dk/dv/dlogw out at rwkv6-3b's B = 8, S = 512, H = 40, dk = dv = 64;
// 0.117 ms at 3.35 TB/s) against 6.8 GFLOP of f32 (0.102 ms at 67
// TFLOP/s): the two are close; chip_smoke.py computes both.  Measured
// 1.38 ms there, 0.70 at B = 4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// What bounds it now: a chain of dependent steps a block with seven
// barriers each, FMAs fed from shared memory, two blocks an SM (82 KB of
// shared memory, 128 registers).
//
// Layouts (row-major, contiguous, 16-byte aligned, f32): as rwkv_scan.cu,
// states [B, H, S / L, dk, dv], ws [B, H, dk] (the du shares), tickets
// >= H zeroed uint32.  dk, dv multiples of 4; L divides S.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStep = 16;
constexpr float kLog2e = 1.4426950408889634f;

// The step's shared-memory layout, in floats (every region a multiple of
// 4 floats).  Rows of L tokens are padded to tp (a multiple of 4) with
// zeros; ldk, ldv and lda pad the rows by 4 floats.  rp (r * 2^cx) takes
// the logw rows' place once the cumulative sums are taken.
struct Layout {
  int tp, ldk, ldv, lda, r, k, w, rp, v, d_o, s0, g, a, dp, drx, dkx, kt, u,
      wl, rho, du, cum, total;
  __host__ __device__ Layout(int l, int dk, int dv) {
    tp = (l + 3) & ~3;
    ldk = dk + 4;
    ldv = dv + 4;
    lda = tp + 4;
    r = 0;
    k = r + tp * ldk;
    w = k + tp * ldk;
    rp = w;
    v = w + tp * ldk;
    d_o = v + tp * ldv;
    s0 = d_o + tp * ldv;     // [dk][ldv]
    g = s0 + dk * ldv;       // [dk][ldv]
    a = g + dk * ldv;        // [tp][lda] A[t][s]: scores, diagonal r u k
    dp = a + tp * lda;       // [tp][lda] dO_t . v_s
    drx = dp + tp * lda;     // [tp][ldk] dr' (pair sums, then all of dr')
    dkx = drx + tp * ldk;    // [tp][ldk] dk'
    kt = dkx + tp * ldk;     // [tp][ldk] k * 2^(cum[L-1] - cum)
    u = kt + tp * ldk;       // [dk]
    wl = u + dk;             // [dk] 2^cum[L-1]
    rho = wl + dk;           // [dk] rowsum(S_end * G_end)
    du = rho + dk;           // [dk] this block's du share
    cum = du + dk;           // [L + 1][dk] doubles: cum[t] = sum_{<t} log2 w
    total = cum + 2 * (l + 1) * dk;
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The head's ticket after every thread's stores; true in the block that
// drew the last one (which resets it).  Called by every thread.
__device__ __forceinline__ bool last_of_group(unsigned* tickets, int group,
                                              unsigned size) {
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    __threadfence();                     // the block's share, device-wide
    last = atomicAdd(tickets + group, 1u) == size - 1;
    if (last) {
      __threadfence();                   // the other blocks' shares, seen
      tickets[group] = 0u;
    }
  }
  return __syncthreads_or(last);
}

struct Args {
  const float *r, *k, *v, *logw, *u, *states, *sT, *d_o, *dsT;
  float *g_r, *g_k, *g_v, *g_w, *g_u, *g_s0, *ws;  // dr dk dv dlogw du ds0
  unsigned* tickets;
  int b, seq, h, dk, dv, step;
};

// DK, DV: the widths when fixed at compile time (rwkv6's 64 x 64), or 0.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2) rwkv_scan_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dk = DK ? DK : a.dk, dv = DV ? DV : a.dv, L = a.step;
  const Layout lay(L, dk, dv);
  const int tp = lay.tp, ldk = lay.ldk, ldv = lay.ldv, lda = lay.lda;
  float* R = smem + lay.r;
  float* K = smem + lay.k;
  float* W = smem + lay.w;
  float* RP = smem + lay.rp;
  float* V = smem + lay.v;
  float* DO = smem + lay.d_o;
  float* S0 = smem + lay.s0;
  float* G = smem + lay.g;
  float* A = smem + lay.a;
  float* DP = smem + lay.dp;
  float* DRX = smem + lay.drx;
  float* DKX = smem + lay.dkx;
  float* KT = smem + lay.kt;
  float* U = smem + lay.u;
  float* WL = smem + lay.wl;
  float* RHO = smem + lay.rho;
  float* DU = smem + lay.du;
  double* CUM = reinterpret_cast<double*>(smem + lay.cum);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h, h = a.h;
  const int dk4 = dk / 4, dv4 = dv / 4, seq = a.seq;
  const int n_steps = seq / L;
  const size_t row_k = (size_t)h * dk, row_v = (size_t)h * dv;   // token strides
  const size_t state = (size_t)dk * dv;

  // zeros everywhere (the padded rows and A's upper triangle stay zero)
  for (int e = tid; e < lay.total; e += kThreads) smem[e] = 0.f;
  __syncthreads();
  for (int i = tid; i < dk; i += kThreads) U[i] = a.u[(size_t)hh * dk + i];
  for (int e = tid; e < dk * dv4; e += kThreads) {
    const int i = e / dv4, j = (e - i * dv4) * 4;
    *reinterpret_cast<float4*>(G + i * ldv + j) =
        ld4(a.dsT + bh * state + (size_t)i * dv + j);
    *reinterpret_cast<float4*>(S0 + i * ldv + j) =
        ld4(a.sT + bh * state + (size_t)i * dv + j);
  }
  __syncthreads();
  // the end state's term of dlogw: rowsum(sT * dsT)
  for (int i = tid; i < dk; i += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < dv; ++j) acc = fmaf(S0[i * ldv + j], G[i * ldv + j], acc);
    RHO[i] = acc;
  }

  // threads a key column in the pair sums (a power of two up to 16)
  int q_cols = 1;
  while (q_cols < 16 && 2 * q_cols * dk <= kThreads) q_cols <<= 1;
  const int Q = q_cols, col_pass = kThreads / Q, q = tid % Q;
  const int n_pairs = L * (L - 1) / 2;
  const int ntm = tp / 4;

  for (int c = n_steps - 1; c >= 0; --c) {
    __syncthreads();                    // the previous step is done
    const size_t tok0 = (size_t)b * seq + (size_t)c * L;
    for (int e = tid; e < L * dk4; e += kThreads) {
      const int t = e / dk4, i = (e - t * dk4) * 4;
      const size_t gi = (tok0 + t) * row_k + (size_t)hh * dk + i;
      *reinterpret_cast<float4*>(R + t * ldk + i) = ld4(a.r + gi);
      *reinterpret_cast<float4*>(K + t * ldk + i) = ld4(a.k + gi);
      *reinterpret_cast<float4*>(W + t * ldk + i) = ld4(a.logw + gi);
    }
    for (int e = tid; e < L * dv4; e += kThreads) {
      const int t = e / dv4, j = (e - t * dv4) * 4;
      const size_t gi = (tok0 + t) * row_v + (size_t)hh * dv + j;
      *reinterpret_cast<float4*>(V + t * ldv + j) = ld4(a.v + gi);
      *reinterpret_cast<float4*>(DO + t * ldv + j) = ld4(a.d_o + gi);
    }
    const float* st = a.states + ((size_t)bh * n_steps + c) * state;
    for (int e = tid; e < dk * dv4; e += kThreads) {
      const int i = e / dv4, j = (e - i * dv4) * 4;
      *reinterpret_cast<float4*>(S0 + i * ldv + j) = ld4(st + (size_t)i * dv + j);
    }
    __syncthreads();

    // cumulative log2-decays, a thread a column, in double precision
    for (int i = tid; i < dk; i += kThreads) {
      double acc = 0.0;
      CUM[i] = 0.0;
      for (int t = 0; t < L; ++t) {
        acc += (double)(W[t * ldk + i] * kLog2e);
        CUM[(t + 1) * dk + i] = acc;
      }
      WL[i] = ex2((float)acc);
    }
    __syncthreads();

    // r~ = r 2^cx (into logw's rows), k~ = k 2^(cum[L-1] - cum)
    for (int e = tid; e < L * dk; e += kThreads) {
      const int t = e / dk, i = e - t * dk;
      RP[t * ldk + i] = R[t * ldk + i] * ex2((float)CUM[t * dk + i]);
      KT[t * ldk + i] =
          K[t * ldk + i] * ex2((float)(CUM[L * dk + i] - CUM[(t + 1) * dk + i]));
    }
    // the pairs s <= t: A[t][s] and dP[t][s] = dO_t . v_s
    for (int p = tid; p < n_pairs + L; p += kThreads) {
      int t, s;
      if (p < n_pairs) {
        t = (int)((sqrtf(8.f * (float)p + 1.f) + 1.f) * 0.5f);
        while (t * (t - 1) / 2 > p) --t;
        while ((t + 1) * t / 2 <= p) ++t;
        s = p - t * (t - 1) / 2;
      } else {
        t = s = p - n_pairs;
      }
      const float* rt = R + t * ldk;
      const float* ks = K + s * ldk;
      float acc = 0.f;
      if (s < t) {
        const double* ct = CUM + t * dk;
        const double* cs = CUM + (s + 1) * dk;
        for (int i = 0; i < dk; ++i)
          acc = fmaf(rt[i] * ks[i], ex2((float)(ct[i] - cs[i])), acc);
      } else {
        for (int i = 0; i < dk; ++i) acc = fmaf(rt[i] * U[i], ks[i], acc);
      }
      A[t * lda + s] = acc;
      const float* ot = DO + t * ldv;
      const float* vs = V + s * ldv;
      float d = 0.f;
      for (int j = 0; j < dv; j += 4) {
        const float4 x = ld4(ot + j), y = ld4(vs + j);
        d = fmaf(x.x, y.x, d);
        d = fmaf(x.y, y.y, d);
        d = fmaf(x.z, y.z, d);
        d = fmaf(x.w, y.w, d);
      }
      DP[t * lda + s] = d;
    }
    __syncthreads();

    // the pair sums: dr'[t] = sum_{s<t} dP k D, dk'[s] = sum_{t>s} dP r D,
    // D = 2^(cx[t] - cum[s]); Q threads a column, token t in lane t % Q
    for (int i0 = 0; i0 < dk; i0 += col_pass) {
      const int i = i0 + tid / Q;
      const bool ok = i < dk;
      float dkp[kMaxStep];
#pragma unroll
      for (int s = 0; s < kMaxStep; ++s) dkp[s] = 0.f;
      if (ok) {
        for (int t = q; t < L; t += Q) {
          const float rt = R[t * ldk + i];
          const double ct = CUM[t * dk + i];
          float dr = 0.f;
#pragma unroll
          for (int s = 0; s < kMaxStep; ++s) {
            if (s < t) {
              const float p = DP[t * lda + s] * ex2((float)(ct - CUM[(s + 1) * dk + i]));
              dr = fmaf(p, K[s * ldk + i], dr);
              dkp[s] = fmaf(p, rt, dkp[s]);
            }
          }
          DRX[t * ldk + i] = dr;
        }
      }
#pragma unroll
      for (int s = 0; s < kMaxStep; ++s)
        for (int off = 1; off < Q; off <<= 1)
          dkp[s] += __shfl_xor_sync(0xffffffffu, dkp[s], off);
      if (ok) {
#pragma unroll
        for (int s = 0; s < kMaxStep; ++s)
          if (s < L && s % Q == q) DKX[s * ldk + i] = dkp[s];
      }
    }
    __syncthreads();

    // dV = A^T dO + k~ G; dr' += 2^cx (dO S0^T); dk' += 2^(cum[L-1] - cum) (V G^T)
    {
      const int n_v = ntm * dv4, n_k = ntm * dk4;
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
          tile<false, false>(acc, is_r ? DO : V, ldv, is_r ? S0 : G, ldv, m0, n0, 0, dv);
          float* out = is_r ? DRX : DKX;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int t = m0 + x;
            if (t >= L) continue;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int i = n0 + n;
              const double ex = is_r ? CUM[t * dk + i]
                                     : CUM[L * dk + i] - CUM[(t + 1) * dk + i];
              out[t * ldk + i] = fmaf(acc[x][n], ex2((float)ex), out[t * ldk + i]);
            }
          }
        }
      }
    }
    __syncthreads();

    // G <- 2^cum[L-1] G + r~^T dO in place (each tile reads only its own G);
    // then a thread a column: dlogw (suffix sums), dr, dk, du's share
    {
      const int n_g = dk4 * dv4;
      for (int item = tid; item < n_g + dk; item += kThreads) {
        if (item < n_g) {
          const int m0 = 4 * (item / dv4), n0 = 4 * (item % dv4);
          float acc[4][4] = {};
          tile<true, true>(acc, RP, ldk, DO, ldv, m0, n0, 0, tp);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float* gp = G + (m0 + x) * ldv + n0;
            const float4 old = ld4(gp);
            const float w = WL[m0 + x];
            st4(gp, fmaf(w, old.x, acc[x][0]), fmaf(w, old.y, acc[x][1]),
                fmaf(w, old.z, acc[x][2]), fmaf(w, old.w, acc[x][3]));
          }
        } else {
          const int i = item - n_g;
          const float ui = U[i];
          float acc = RHO[i], du = DU[i];
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
          DU[i] = du;
        }
      }
    }
    __syncthreads();

    // rowsum(S0 * G): the end-state term of the previous step's dlogw
    for (int i = tid; i < dk; i += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < dv; ++j) acc = fmaf(S0[i * ldv + j], G[i * ldv + j], acc);
      RHO[i] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < dk * dv4; e += kThreads) {
    const int i = e / dv4, j = (e - i * dv4) * 4;
    *reinterpret_cast<float4*>(a.g_s0 + bh * state + (size_t)i * dv + j) =
        ld4(G + i * ldv + j);
  }
  // du: this block's share, then the head's last block sums the B shares
  // in batch order
  for (int i = tid; i < dk; i += kThreads) a.ws[(size_t)bh * dk + i] = DU[i];
  if (!last_of_group(a.tickets, hh, (unsigned)a.b)) return;
  for (int i = tid; i < dk; i += kThreads) {
    float acc = 0.f;
    for (int bb = 0; bb < a.b; ++bb)
      acc += __ldcg(a.ws + ((size_t)bb * h + hh) * dk + i);
    a.g_u[(size_t)hh * dk + i] = acc;
  }
}

}  // namespace

extern "C" {

// The gradient of rwkv_scan_f32 (see above).  states: the forward's states
// variant at step `step` (the largest divisor of its chunk up to 16); ws
// [B, H, dk]; tickets n_tickets >= H zeroed uint32 (left zeroed).  Returns
// cudaGetLastError() right after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take (one whose step does not fit in a
// block's shared memory included).
int rwkv_scan_bwd_f32(const void* r, const void* k, const void* v,
                      const void* logw, const void* u, const void* states,
                      const void* sT, const void* d_o, const void* dsT, void* dr,
                      void* dk_out, void* dv_out, void* dlogw, void* du,
                      void* ds0, void* ws, void* tickets, int n_tickets, int b,
                      int seq, int h, int dk, int dv, int step, void* stream) {
  if (b < 1 || h < 1 || seq < 1 || step < 1 || step > kMaxStep || seq % step ||
      dk < 4 || dk % 4 || dv < 4 || dv % 4 || n_tickets < h || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  const Layout lay(step, dk, dv);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)lay.total;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const bool fixed = dk == 64 && dv == 64;
  auto kernel = fixed ? rwkv_scan_bwd_kernel<64, 64> : rwkv_scan_bwd_kernel<0, 0>;
  static int smem_set[2] = {0, 0};     // largest size allowed so far
  if ((int)smem > smem_set[fixed] && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[fixed] = (int)smem;
  }
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.logw = static_cast<const float*>(logw);
  a.u = static_cast<const float*>(u);
  a.states = static_cast<const float*>(states);
  a.sT = static_cast<const float*>(sT);
  a.d_o = static_cast<const float*>(d_o);
  a.dsT = static_cast<const float*>(dsT);
  a.g_r = static_cast<float*>(dr);
  a.g_k = static_cast<float*>(dk_out);
  a.g_v = static_cast<float*>(dv_out);
  a.g_w = static_cast<float*>(dlogw);
  a.g_u = static_cast<float*>(du);
  a.g_s0 = static_cast<float*>(ds0);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<unsigned*>(tickets);
  a.b = b;
  a.seq = seq;
  a.h = h;
  a.dk = dk;
  a.dv = dv;
  a.step = step;
  kernel<<<(unsigned)(b * h), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
