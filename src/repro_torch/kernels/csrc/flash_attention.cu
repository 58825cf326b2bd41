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
// (query, key) pair it keeps, about 8.6 GFLOP against 84 MB of q/k/v/out.
// What the design does about it:
//   * one block per (batch, kv head, query tile); its 64 rows are the
//     G = H/Hkv query heads of the kv head times 64/G positions, so each
//     K/V tile staged in shared memory serves the whole group (GQA);
//   * each of the 256 threads owns a 4x4 tile of the 64x64 score tile
//     and a 4 x D/16 tile of the output, read from shared memory in
//     16-byte vectors (rows padded by 4 floats: no bank conflicts), so a
//     thread does 64 FMAs per eight 16-byte shared loads;
//   * key tiles past a block's last query row are never loaded (causal),
//     and the grid starts the longest (last) query tiles first;
//   * any Sq, Sk: query rows and key columns past the end are masked in
//     the kernel (the Pallas kernel asks for multiples of its blocks).
// Scalar f32 FMAs on the CUDA cores; wgmma/TMA belong to a later change.
//
// Layouts (row-major, contiguous, 16-byte aligned): q/out [B, H, Sq, D],
// k/v [B, Hkv, Sk, D], all f32.  D in {16, 32, 64, 128, 256}; G <= 64.

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;     // query rows of a block (G heads x positions)
constexpr int kKeys = 64;     // keys of a tile
constexpr int kThreads = 256;
constexpr int kLdp = kKeys + 16;   // p_sh row stride: two rows a warp, disjoint banks

template <int D>
struct Shape {
  static constexpr int VW = D >= 64 ? 4 : D / 16;   // floats per output vector
  static constexpr int NG = D / (16 * VW);           // output vectors a row
  static constexpr int LD = D + 4;                   // padded row stride
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)(kRows + 2 * kKeys) * LD + (size_t)kRows * kLdp);
};

template <int VW>
struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* x) { x[0] = *p; }
};
template <> struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  }
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int h, int hkv, int sq, int sk, int group, int bq,
                       int causal, float sm_scale) {
  using S = Shape<D>;
  constexpr int LD = S::LD, VW = S::VW, NG = S::NG, NV4 = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                  // [kRows][LD]
  float* k_sh = q_sh + kRows * LD;     // [kKeys][LD]
  float* v_sh = k_sh + kKeys * LD;     // [kKeys][LD]
  float* p_sh = v_sh + kKeys * LD;     // [kRows][kLdp] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;             // key / output-column lane
  const int ty = tid >> 4;             // row lane: rows ty + 16*i
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;   // last tiles first
  const int rows = group * bq;

  // block row r = (head kvh*group + r / bq, position q0 + r % bq)
  for (int e = tid; e < kRows * NV4; e += kThreads) {
    const int r = e / NV4, d4 = (e % NV4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && q0 + r % bq < sq) {
      const int head = kvh * group + r / bq;
      x = __ldg(reinterpret_cast<const float4*>(
          q + (((size_t)b * h + head) * sq + q0 + r % bq) * D + d4));
    }
    *reinterpret_cast<float4*>(q_sh + r * LD + d4) = x;
  }

  int qpos[4];
  float m[4], l[4], acc[4][NG * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    qpos[i] = r < rows ? q0 + r % bq : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * VW; ++c) acc[i][c] = 0.f;
  }

  // keys this block needs: causal stops at its last query row
  int kmax = sk;
  if (causal) {
    const int last = q0 + bq < sq ? q0 + bq : sq;
    kmax = last < sk ? last : sk;
  }
  const size_t kv_base = ((size_t)b * hkv + kvh) * sk;

  for (int k0 = 0; k0 < kmax; k0 += kKeys) {
    const int nk = kmax - k0 < kKeys ? kmax - k0 : kKeys;
    __syncthreads();   // the previous tile's k/v/p are no longer read
    for (int e = tid; e < kKeys * NV4; e += kThreads) {
      const int c = e / NV4, d4 = (e % NV4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (c < nk) {
        const size_t g = (kv_base + k0 + c) * D + d4;
        kx = __ldg(reinterpret_cast<const float4*>(k + g));
        vx = __ldg(reinterpret_cast<const float4*>(v + g));
      }
      *reinterpret_cast<float4*>(k_sh + c * LD + d4) = kx;
      *reinterpret_cast<float4*>(v_sh + c * LD + d4) = vx;
    }
    __syncthreads();

    // scores of rows ty + 16*i against keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_sh + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(k_sh + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // online softmax: the 16 lanes of a row hold its 64 keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = tx + 16 * j < nk && (!causal || col <= qpos[i]);
        s[i][j] = keep ? s[i][j] * sm_scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mc));
      const float alpha = expf(m[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ls += p;
        p_sh[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + ls;     // this lane's keys only; summed at the end
#pragma unroll
      for (int c = 0; c < NG * VW; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    // acc += P V over the tile's valid keys (rounded up to 4: p = 0, v = 0)
    for (int c = 0; c < nk; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(p_sh + (ty + 16 * i) * kLdp + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[NG * VW];
#pragma unroll
        for (int n = 0; n < NG; ++n)
          Vec<VW>::load(v_sh + (c + cc) * LD + tx * VW + n * 16 * VW, vv + n * VW);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = comp(pr[i], cc);
#pragma unroll
          for (int x = 0; x < NG * VW; ++x) acc[i][x] = fmaf(pc, vv[x], acc[i][x]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int r = ty + 16 * i;
    if (r >= rows || qpos[i] >= sq) continue;
    const int head = kvh * group + r / bq;
    float* o_row = out + (((size_t)b * h + head) * sq + qpos[i]) * D;
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int w = 0; w < VW; ++w)
        o_row[tx * VW + n * 16 * VW + w] = acc[i][n * VW + w] / denom;
  }
}

template <int D>
cudaError_t launch_d(const float* q, const float* k, const float* v, float* out,
                     int b, int h, int hkv, int sq, int sk, int causal,
                     cudaStream_t stream) {
  const size_t smem = Shape<D>::kSmem;
  static bool smem_set = false;      // once per instantiation
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int group = h / hkv;
  const int bq = kRows / group;
  const float sm_scale = 1.0f / sqrtf((float)D);
  dim3 grid((sq + bq - 1) / bq, hkv, b);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, h, hkv, sq, sk, group, bq, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int b, int h, int hkv, int sq, int sk, int d,
                        int causal, void* stream) {
  if (b < 1 || hkv < 1 || h % hkv || h / hkv > kRows || sq < 1 || sk < 1 ||
      b > 65535 || hkv > 65535 || (causal && sq != sk))
    return (int)cudaErrorInvalidValue;
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch_d<16>(qf, kf, vf, of, b, h, hkv, sq, sk, causal, st);
    case 32: return (int)launch_d<32>(qf, kf, vf, of, b, h, hkv, sq, sk, causal, st);
    case 64: return (int)launch_d<64>(qf, kf, vf, of, b, h, hkv, sq, sk, causal, st);
    case 128: return (int)launch_d<128>(qf, kf, vf, of, b, h, hkv, sq, sk, causal, st);
    case 256: return (int)launch_d<256>(qf, kf, vf, of, b, h, hkv, sq, sk, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
