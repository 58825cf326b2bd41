// Blockwise online-softmax GQA attention (prefill) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel _flash_kernel
// (repro/kernels/flash_attention.py:26, called by flash_attention :73).
// Same function, in f32: for each query row, an online softmax over key
// tiles (running max m, running sum l, accumulator acc), masked scores
// set to -1e30, out = acc / max(l, 1e-30).  Causal masking keeps key
// col <= query row, aligned top-left as the Pallas kernel does; the
// wrapper only asks for it with Sq == Sk, where the top-left and the
// bottom-right conventions agree.
//
// Bound on this card: operations.  A causal layer at granite-3-2b's
// prefill shape (B=8, H=32, S=512, D=64) does 4*D f32 operations per
// (query, key) pair it keeps, about 8.6 GFLOP against 84 MB of q/k/v/out:
// 0.128 ms on the CUDA cores' 67 TFLOP/s.  The products run on the
// tensor cores instead, at f32 accuracy, so the bound of this route is
// three TF32 products per f32 product at 495 TFLOP/s (0.052 ms there).
// What the design does about it:
//   * 3xTF32: each operand is split into hi = tf32(x) and lo = tf32(x -
//     hi) (round to nearest, ties away, as cvt.rna), and mma.sync.m16n8k8
//     accumulates lo*hi + hi*lo + hi*hi in f32; the dropped lo*lo term is
//     ~2^-22 relative, so the products keep f32 precision (TF32 alone
//     keeps ~2^-11).  mma.sync's TF32 rate on the card is below the 495
//     TFLOP/s of wgmma (scripts/flash_sweep.py reads it);
//   * the FA2 layout: one block per (batch, kv head, query tile) whose 64
//     rows are the G = H/Hkv query heads of the kv head times 64/G
//     positions (each K/V tile serves the group), four warps of 16 rows;
//     Q fragments stay in registers for the whole key loop (D <= 128;
//     above, in shared memory); softmax runs on the score fragments with
//     quad shuffles, in exp2 on scores scaled by log2(e)/sqrt(D);
//   * P goes from the score accumulators straight into PV's A fragments:
//     a thread's accumulator holds keys 2tg, 2tg+1 of each 8-key tile,
//     so PV's k index tg stands for key 2tg and tg+4 for key 2tg+1, and
//     V's B fragment reads rows 2tg and 2tg+1 to match (no shuffles, no
//     shared-memory round trip);
//   * operands are rounded to TF32 with two integer operations (add half
//     an ulp, clear 13 bits), not cvt.rna.tf32.f32, which runs on the
//     slower conversion pipe; every warp splits the K/V elements it
//     multiplies (a tile split once into shared memory for the block
//     measured slower: the split pass and its barrier do not overlap the
//     products; PERF.md);
//   * K/V tiles of 32 keys through a two-stage cp.async ring, so the next
//     tile's copy overlaps this tile's products (64-key tiles mask more
//     of the diagonal tile); rows padded to D + 4 floats: every fragment
//     read of K, V and Q hits 32 distinct banks;
//   * key tiles past a block's last query row are never loaded (causal),
//     and the grid starts the longest (last) query tiles first;
//   * any Sq, Sk: query rows and key columns past the end are masked in
//     the kernel; any D that is a multiple of 8 up to 256, the columns up
//     to the next multiple of 32 zero-filled in shared memory (one
//     instantiation each of 32, 64, ..., 256).
//
// Layouts (row-major, contiguous, 16-byte aligned): q/out [B, H, Sq, D],
// k/v [B, Hkv, Sk, D], all f32.  D % 8 == 0, 8 <= D <= 256; G <= 64.
//
// flash_attention_fwd_lse_f32 is the same kernel (LSE = true) that also
// writes each row's natural-log logsumexp of its scaled, masked scores,
// lse [B, H, Sq] f32, from the online-softmax state it keeps (m in base
// 2, l): lse = (m + log2 l) * ln 2.  Its out is the LSE = false kernel's,
// bit for bit.  The training path saves lse for the backward kernels
// (flash_attention_bwd.cu).

#include <cmath>

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;     // query rows of a block (G heads x positions)
constexpr int kWarps = 4;     // 16 rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;     // keys a K/V tile

// scripts/flash_sweep.py times builds of this file with other choices
template <int DP>
struct Cfg {
  static constexpr int BC = kKeys;
  static constexpr bool QREG = DP <= 128;         // Q fragments in registers
  static constexpr int LD = DP + 4;               // padded row stride (floats)
  static constexpr int KT = DP / 8;               // k-steps of QK^T, n-tiles of PV
  static constexpr int NT = BC / 8;               // n-tiles of QK^T, k-steps of PV
  static constexpr int kStage = 2 * BC * LD;      // floats: a K tile, then a V tile
  static constexpr size_t kSmem =
      sizeof(float) * (2 * (size_t)kStage + (QREG ? 0 : (size_t)kRows * LD));
  // with Q in registers it is staged through the ring before the loop
  static_assert(!QREG || kRows <= 2 * BC, "Q staging fits a ring stage");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// an A fragment split once, for every n-tile it multiplies
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float* a) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
  }
};

// acc[n] += a * B_n for n < N at f32 accuracy, B_n's fragment being
// (b[2n], b[2n + 1]): the small terms first, then hi * hi, each term a
// pass over the N tiles, so an accumulator's three products are N mma
// apart
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*acc)[4], const SplitA& a,
                                           const float* b) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[2 * n], bh[n][0], bl[n][0]);
    split(b[2 * n + 1], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.lo, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, bh[n]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layouts of m16n8k8: tf32_mma.cuh.
template <int DP, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int h, int hkv, int sq, int sk, int d, int group, int bq,
                    int causal, float scale_log2) {
  using C = Cfg<DP>;
  constexpr int BC = C::BC, LD = C::LD, KT = C::KT, NT = C::NT;
  constexpr int CH = DP / 4;           // 16-byte chunks of a padded row
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                  // two stages of [K: BC][LD], [V: BC][LD]
  float* q_sh = C::QREG ? ring : smem + 2 * C::kStage;   // [kRows][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;   // last tiles first
  const int rows = group * bq;
  const int nd4 = d / 4;

  // block row r = (head kvh*group + r / bq, position q0 + r % bq)
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < rows && q0 + r % bq < sq && c < nd4;
    const float* src =
        ok ? q + (((size_t)b * h + kvh * group + r / bq) * sq + q0 + r % bq) * d +
                 c * 4
           : q;
    cp16(q_sh + r * LD + c * 4, src, ok);
  }

  // keys this block needs: causal stops at its last query row
  int kmax = sk;
  if (causal) {
    const int last = q0 + bq < sq ? q0 + bq : sq;
    kmax = last < sk ? last : sk;
  }
  const int n_tiles = (kmax + BC - 1) / BC;
  const size_t kv_base = ((size_t)b * hkv + kvh) * sk;
  // tile j goes to stage (j + 1) & 1: stage 0 first holds Q (QREG)
  auto load_tile = [&](int j) {
    float* ks = ring + ((j + 1) & 1) * C::kStage;
    float* vs = ks + BC * LD;
    const int k0 = j * BC;
    for (int e = tid; e < BC * CH; e += kThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = k0 + r < kmax && c < nd4;
      const size_t off = (kv_base + k0 + r) * d + c * 4;
      cp16(ks + r * LD + c * 4, ok ? k + off : k, ok);
      cp16(vs + r * LD + c * 4, ok ? v + off : v, ok);
    }
  };
  load_tile(0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + g, r1 = r0 + 8;   // this thread's two rows
  const int pos0 = q0 + r0 % bq, pos1 = q0 + r1 % bq;
  float qf[C::QREG ? KT : 1][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qf[kk][0] = q_sh[r0 * LD + 8 * kk + tg];
      qf[kk][1] = q_sh[r1 * LD + 8 * kk + tg];
      qf[kk][2] = q_sh[r0 * LD + 8 * kk + tg + 4];
      qf[kk][3] = q_sh[r1 * LD + 8 * kk + tg + 4];
    }
  }
  __syncthreads();   // the Q staging (ring stage 0) may be overwritten

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_commit();
    cp_wait<1>();            // tile j has landed
    __syncthreads();
    const float* ks = ring + ((j + 1) & 1) * C::kStage;
    const float* vs = ks + BC * LD;
    const int k0 = j * BC;

    // S = Q K^T for this warp's 16 rows and the tile's BC keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[4];
      if constexpr (C::QREG) {
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = qf[kk][c];
      } else {
        a[0] = q_sh[r0 * LD + 8 * kk + tg];
        a[1] = q_sh[r1 * LD + 8 * kk + tg];
        a[2] = q_sh[r0 * LD + 8 * kk + tg + 4];
        a[3] = q_sh[r1 * LD + 8 * kk + tg + 4];
      }
      float bf[2 * NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kr = ks + (8 * n + g) * LD + 8 * kk + tg;
        bf[2 * n] = kr[0];
        bf[2 * n + 1] = kr[4];
      }
      mma_3xtf32<NT>(s, SplitA(a), bf);
    }

    // online softmax in base 2 on the fragments: c0, c1 are row r0's
    // keys 8n + 2tg, +1; c2, c3 row r1's
    const bool need_mask = k0 + BC > kmax || (causal && k0 + BC - 1 > q0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * scale_log2;
        if (need_mask) {
          const int col = k0 + 8 * n + 2 * tg + (c & 1);
          const int pos = c < 2 ? pos0 : pos1;
          if (col >= kmax || (causal && col > pos)) x = kNegInf;
        }
        s[n][c] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mx0);
      s[n][1] = exp2f(s[n][1] - mx0);
      s[n][2] = exp2f(s[n][2] - mx1);
      s[n][3] = exp2f(s[n][3] - mx1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + ls0;   // this lane's keys only; summed at the end
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V: PV's k-step kk covers keys 8kk..8kk+7, its k index tg
    // standing for key 2tg and tg + 4 for key 2tg + 1
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      const SplitA ps(a);
      const float* vr = vs + (8 * kk + 2 * tg) * LD + g;
#pragma unroll
      for (int n0 = 0; n0 < KT; n0 += 4) {    // four d-tiles at a time
        float bf[8];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          bf[2 * n] = vr[8 * (n0 + n)];
          bf[2 * n + 1] = vr[LD + 8 * (n0 + n)];
        }
        mma_3xtf32<4>(o + n0, ps, bf);
      }
    }
    __syncthreads();   // stage (j + 1) & 1 is free for tile j + 2
  }

  const float den0 = fmaxf(quad_sum(l0), 1e-30f);
  const float den1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    const int pos = half ? pos1 : pos0;
    if (r >= rows || pos >= sq) continue;
    const float den = half ? den1 : den0;
    const size_t row = ((size_t)b * h + kvh * group + r / bq) * sq + pos;
    if constexpr (LSE) {
      if (tg == 0) lse[row] = ((half ? m1 : m0) + log2f(den)) * 0.6931471805599453f;
    }
    float* o_row = out + row * d;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      if (8 * n >= d) break;
      const float2 w = make_float2(o[n][2 * half] / den, o[n][2 * half + 1] / den);
      *reinterpret_cast<float2*>(o_row + 8 * n + 2 * tg) = w;
    }
  }
}

template <int DP, bool LSE>
cudaError_t launch_dp(const float* q, const float* k, const float* v, float* out,
                      float* lse, int b, int h, int hkv, int sq, int sk, int d,
                      int causal, cudaStream_t stream) {
  const size_t smem = Cfg<DP>::kSmem;
  static bool smem_set = false;      // once per instantiation
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_3xtf32_kernel<DP, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int group = h / hkv;
  const int bq = kRows / group;
  // log2(e) / sqrt(D): scores in base 2 for exp2f
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  dim3 grid((sq + bq - 1) / bq, hkv, b);
  flash_3xtf32_kernel<DP, LSE><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, h, hkv, sq, sk, d, group, bq, causal, scale_log2);
  return cudaGetLastError();
}

template <bool LSE>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int h, int hkv, int sq, int sk, int d, int causal,
           void* stream) {
  if (b < 1 || hkv < 1 || h % hkv || h / hkv > kRows || sq < 1 || sk < 1 ||
      b > 65535 || hkv > 65535 || (causal && sq != sk) || d < 8 || d > 256 ||
      d % 8 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || (LSE && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(out);
  auto lf = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((d + 31) / 32) {
    case 1: return (int)launch_dp<32, LSE>(qf, kf, vf, of, lf, b, h, hkv, sq, sk, d, causal, st);
    case 2: return (int)launch_dp<64, LSE>(qf, kf, vf, of, lf, b, h, hkv, sq, sk, d, causal, st);
    case 3: return (int)launch_dp<96, LSE>(qf, kf, vf, of, lf, b, h, hkv, sq, sk, d, causal, st);
    case 4: return (int)launch_dp<128, LSE>(qf, kf, vf, of, lf, b, h, hkv, sq, sk, d, causal, st);
    case 5: return (int)launch_dp<160, LSE>(qf, kf, vf, of, lf, b, h, hkv, sq, sk, d, causal, st);
    case 6: return (int)launch_dp<192, LSE>(qf, kf, vf, of, lf, b, h, hkv, sq, sk, d, causal, st);
    case 7: return (int)launch_dp<224, LSE>(qf, kf, vf, of, lf, b, h, hkv, sq, sk, d, causal, st);
    case 8: return (int)launch_dp<256, LSE>(qf, kf, vf, of, lf, b, h, hkv, sq, sk, d, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int b, int h, int hkv, int sq, int sk, int d,
                        int causal, void* stream) {
  return launch<false>(q, k, v, out, nullptr, b, h, hkv, sq, sk, d, causal,
                       stream);
}

// The same, also writing lse [B, H, Sq] f32 (the training forward).
int flash_attention_fwd_lse_f32(const void* q, const void* k, const void* v,
                                void* out, void* lse, int b, int h, int hkv,
                                int sq, int sk, int d, int causal,
                                void* stream) {
  return launch<true>(q, k, v, out, lse, b, h, hkv, sq, sk, d, causal, stream);
}

}  // extern "C"
