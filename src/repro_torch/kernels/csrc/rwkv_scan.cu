// RWKV6 chunked wkv recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel _wkv_kernel
// (repro/kernels/rwkv_scan.py:21, called by rwkv_scan :57).  Same
// function, in f32, per (batch b, head h) and chunk of C tokens, with
// cum the inclusive cumulative sum of logw over the chunk and
// cx = cum - logw:
//   A[t][s] = sum_i r[t][i] k[s][i] exp(cx[t][i] - cum[s][i])   (t > s)
//   A[t][t] = sum_i r[t][i] u[i] k[t][i]
//   o[t][j] = sum_{s<=t} A[t][s] v[s][j] + sum_i r[t][i] exp(cx[t][i]) S[i][j]
//   S[i][j] <- exp(cum[C-1][i]) S[i][j]
//              + sum_s k[s][i] exp(cum[C-1][i] - cum[s][i]) v[s][j]
// Every exponent is a difference of cumulative log-decays, <= 0; the
// pairs t <= s are never formed (the mask comes before the exp).
//
// The TPU runs the chunks as a sequential grid axis with the state in
// VMEM scratch.  Here there is no sequential grid: one block walks all
// chunks of its (b, h) in a loop, with the [dk, dv] state in shared
// memory the whole time.
//
// Bound on this card: bytes at rwkv6-3b's prefill shape (B=8, S=512,
// H=40, dk=dv=64, chunk 32): about 220 MB of r/k/v/logw/o/state against
// about 4 GFLOP.  What the design does about it: each input element is
// read from device memory once, in 16-byte loads, into shared memory
// rows padded by 4 floats; the scores read r/cx/k/cum in 16-byte
// vectors, one (t, s) pair a thread (no idle lanes for the masked
// triangle); the output and the state update each read one operand as
// a 16-byte vector and broadcast the other.  Scalar f32 FMAs.
//
// Layouts (row-major, contiguous, 16-byte aligned): r/k/logw [B, S, H, dk],
// v/o [B, S, H, dv], u [H, dk], s0/sT [B, H, dk, dv], all f32.
// dk, dv multiples of 4; chunk C <= 64 divides S.

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

// floats of the A tile, rounded up so that the state tile after it
// stays 16-byte aligned
inline __host__ __device__ int a_floats(int c) { return (c * (c + 1) + 3) / 4 * 4; }

inline size_t smem_floats(int c, int dk, int dv) {
  const int ld = dk + 4;
  return (size_t)4 * c * ld       // r, k, cx, cum
         + (size_t)c * dv         // v
         + (size_t)a_floats(c)    // A
         + (size_t)dk * dv        // state
         + 2 * (size_t)dk;        // u, exp(cum[C-1])
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
rwkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ o, float* __restrict__ sT,
                 int seq, int h, int dk, int dv, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int ld = dk + 4;
  float* r_s = smem;                   // [C][ld]  r, then r * exp(cx)
  float* k_s = r_s + chunk * ld;       // [C][ld]  k, then k * exp(cum_last - cum)
  float* x_s = k_s + chunk * ld;       // [C][ld]  logw, then cx
  float* c_s = x_s + chunk * ld;       // [C][ld]  cum
  float* v_s = c_s + chunk * ld;       // [C][dv]
  float* a_s = v_s + chunk * dv;       // [C][C+1] scores, A[t][t] on the diagonal
  float* st_s = a_s + a_floats(chunk);      // [dk][dv] state
  float* u_s = st_s + dk * dv;         // [dk]
  float* wl_s = u_s + dk;              // [dk] exp(cum[C-1])

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int dk4 = dk / 4, dv4 = dv / 4;
  const int n_pairs = chunk * (chunk - 1) / 2;

  for (int e = tid; e < dk * dv; e += kThreads)
    st_s[e] = s0[(size_t)bh * dk * dv + e];
  for (int i = tid; i < dk; i += kThreads) u_s[i] = u[(size_t)hh * dk + i];

  for (int c0 = 0; c0 < seq; c0 += chunk) {
    __syncthreads();   // the previous chunk is done with every tile
    const size_t tok0 = (size_t)b * seq + c0;
    for (int e = tid; e < chunk * dk4; e += kThreads) {
      const int t = e / dk4, i = (e % dk4) * 4;
      const size_t g = ((tok0 + t) * h + hh) * dk + i;
      *reinterpret_cast<float4*>(r_s + t * ld + i) = __ldg(reinterpret_cast<const float4*>(r + g));
      *reinterpret_cast<float4*>(k_s + t * ld + i) = __ldg(reinterpret_cast<const float4*>(k + g));
      *reinterpret_cast<float4*>(x_s + t * ld + i) = __ldg(reinterpret_cast<const float4*>(logw + g));
    }
    for (int e = tid; e < chunk * dv4; e += kThreads) {
      const int t = e / dv4, j = (e % dv4) * 4;
      *reinterpret_cast<float4*>(v_s + t * dv + j) = __ldg(reinterpret_cast<const float4*>(
          v + ((tok0 + t) * h + hh) * dv + j));
    }
    __syncthreads();

    // cumulative log-decays over the chunk, one lane per key column
    for (int i = tid; i < dk; i += kThreads) {
      float run = 0.f;
      for (int t = 0; t < chunk; ++t) {
        const float w = x_s[t * ld + i];
        run = __fadd_rn(run, w);
        c_s[t * ld + i] = run;
        x_s[t * ld + i] = __fsub_rn(run, w);     // cx = cum - logw
      }
    }
    __syncthreads();

    // scores: pair p < n_pairs is (t, s) with s < t, then the diagonal
    for (int p = tid; p < n_pairs + chunk; p += kThreads) {
      float acc = 0.f;
      int t, s;
      if (p < n_pairs) {
        t = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
        while (t * (t - 1) / 2 > p) --t;
        while ((t + 1) * t / 2 <= p) ++t;
        s = p - t * (t - 1) / 2;
        const float* rt = r_s + t * ld;
        const float* xt = x_s + t * ld;
        const float* ks = k_s + s * ld;
        const float* cs = c_s + s * ld;
        for (int i = 0; i < dk; i += 4) {
          const float4 a = ld4(rt + i), x = ld4(xt + i), kk = ld4(ks + i),
                       c = ld4(cs + i);
          acc = fmaf(a.x * kk.x, expf(__fsub_rn(x.x, c.x)), acc);
          acc = fmaf(a.y * kk.y, expf(__fsub_rn(x.y, c.y)), acc);
          acc = fmaf(a.z * kk.z, expf(__fsub_rn(x.z, c.z)), acc);
          acc = fmaf(a.w * kk.w, expf(__fsub_rn(x.w, c.w)), acc);
        }
      } else {
        t = s = p - n_pairs;
        const float* rt = r_s + t * ld;
        const float* kt = k_s + t * ld;
        for (int i = 0; i < dk; i += 4) {
          const float4 a = ld4(rt + i), kk = ld4(kt + i), uu = ld4(u_s + i);
          acc = fmaf(a.x * uu.x, kk.x, acc);
          acc = fmaf(a.y * uu.y, kk.y, acc);
          acc = fmaf(a.z * uu.z, kk.z, acc);
          acc = fmaf(a.w * uu.w, kk.w, acc);
        }
      }
      a_s[t * (chunk + 1) + s] = acc;
    }
    __syncthreads();

    // decays: r *= exp(cx), k *= exp(cum_last - cum); exp(cum_last)
    const float* c_last = c_s + (chunk - 1) * ld;
    for (int e = tid; e < chunk * dk; e += kThreads) {
      const int t = e / dk, i = e % dk;
      r_s[t * ld + i] *= expf(x_s[t * ld + i]);
      k_s[t * ld + i] *= expf(__fsub_rn(c_last[i], c_s[t * ld + i]));
    }
    for (int i = tid; i < dk; i += kThreads) wl_s[i] = expf(c_last[i]);
    __syncthreads();

    // outputs: lane (t, 4 columns); A and r broadcast, v and S as vectors
    for (int e = tid; e < chunk * dv4; e += kThreads) {
      const int t = e / dv4, j = (e % dv4) * 4;
      const float* at = a_s + t * (chunk + 1);
      float4 intra = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s <= t; ++s) {
        const float a = at[s];
        const float4 vv = ld4(v_s + s * dv + j);
        intra.x = fmaf(a, vv.x, intra.x);
        intra.y = fmaf(a, vv.y, intra.y);
        intra.z = fmaf(a, vv.z, intra.z);
        intra.w = fmaf(a, vv.w, intra.w);
      }
      float4 inter = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* rt = r_s + t * ld;
      for (int i = 0; i < dk; ++i) {
        const float a = rt[i];
        const float4 ss = ld4(st_s + i * dv + j);
        inter.x = fmaf(a, ss.x, inter.x);
        inter.y = fmaf(a, ss.y, inter.y);
        inter.z = fmaf(a, ss.z, inter.z);
        inter.w = fmaf(a, ss.w, inter.w);
      }
      *reinterpret_cast<float4*>(o + ((tok0 + t) * h + hh) * dv + j) =
          make_float4(intra.x + inter.x, intra.y + inter.y, intra.z + inter.z,
                      intra.w + inter.w);
    }
    __syncthreads();

    // state: lane (4 key rows, column j); k broadcast as a vector, v scalar
    for (int e = tid; e < dk4 * dv; e += kThreads) {
      const int i = (e / dv) * 4, j = e % dv;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < chunk; ++s) {
        const float4 kk = ld4(k_s + s * ld + i);
        const float vv = v_s[s * dv + j];
        acc.x = fmaf(kk.x, vv, acc.x);
        acc.y = fmaf(kk.y, vv, acc.y);
        acc.z = fmaf(kk.z, vv, acc.z);
        acc.w = fmaf(kk.w, vv, acc.w);
      }
      float* st = st_s + i * dv + j;
      st[0] = fmaf(wl_s[i], st[0], acc.x);
      st[dv] = fmaf(wl_s[i + 1], st[dv], acc.y);
      st[2 * dv] = fmaf(wl_s[i + 2], st[2 * dv], acc.z);
      st[3 * dv] = fmaf(wl_s[i + 3], st[3 * dv], acc.w);
    }
  }
  __syncthreads();
  for (int e = tid; e < dk * dv; e += kThreads)
    sT[(size_t)bh * dk * dv + e] = st_s[e];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take (including
// one whose tiles do not fit in a block's shared memory).
int rwkv_scan_f32(const void* r, const void* k, const void* v, const void* logw,
                  const void* u, const void* s0, void* o, void* sT, int b,
                  int seq, int h, int dk, int dv, int chunk, void* stream) {
  if (b < 1 || h < 1 || seq < 1 || chunk < 1 || chunk > kMaxChunk ||
      seq % chunk || dk < 4 || dk % 4 || dv < 4 || dv % 4)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * smem_floats(chunk, dk, dv);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;             // largest size allowed so far
  if ((int)smem > smem_set && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rwkv_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = (int)smem;
  }
  rwkv_scan_kernel<<<(unsigned)(b * h), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(sT), seq, h, dk, dv, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
