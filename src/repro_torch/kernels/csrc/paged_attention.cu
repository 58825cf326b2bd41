// Paged GQA decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernels in
// repro/kernels/paged_attention.py:
//   * _paged_kernel (:39)     -> paged_attention_f32
//   * _paged_q8_kernel (:77)  -> paged_attention_q8_int8 / _fp8
// Same function: for each (sequence b, query head), an online softmax
// over the pages the page table names, pages at or past lengths[b] never
// read, out = acc / max(l, 1e-30) (a length-0 row writes zeros).  For the
// quantized pages the k scale multiplies the logits and the v scale the
// probabilities; codes are dequantised in registers, never to a page.
//
// Bound on this card: memory bytes, the k/v bytes of the valid pages
// (plus their scales).  A decode step does about 4*D flops per k/v
// element pair it reads, far below the H100's flops-per-byte balance.
// What the design does about it: one block per (b, kv head) loads each
// valid page's [page, D] k and v slice for that kv head into shared
// memory once, and the G = H/Hkv query heads of the group (one warp
// each) all read it there, so each k/v byte crosses device memory once
// per kv head, not once per query head.
//
// Layouts (row-major, contiguous): q/out [B, H, D] f32; k/v pages
// [P, page, Hkv, D] of T; scales [P, page, Hkv] f32; page_table [B, pps]
// int32; lengths [B] int32.  D = 32*NV with NV in 1..8, page <= 64,
// G <= 32; the page tensors start 16-byte aligned.  Page ids named by
// the table below ceil(length/page) must lie in [0, P); entries past it
// are never read.
//
// Known limit, first in line for a later change: at decode shapes the
// grid is only B*Hkv blocks (64 for granite at batch 8 on 132 SMs), and
// each block walks its pages in order without overlapping the next
// page's loads.  Split-K over pages with a combine pass fixes both; the
// (acc, m, l) partials output the pool path needs belongs to that work.

#include <cmath>

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxPage = 64;
constexpr int kMaxGroup = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// 16 bytes of page elements -> floats at dst (16-byte aligned)
__device__ __forceinline__ void cvt_store(float* dst, const uint4& raw, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void cvt_store(float* dst, const uint4& raw, int8_t) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(c[e], c[e + 1], c[e + 2], c[e + 3]);
}
__device__ __forceinline__ void cvt_store(float* dst, const uint4& raw,
                                          __nv_fp8_e4m3) {
  const __nv_fp8_e4m3* c = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(to_f32(c[e]), to_f32(c[e + 1]), to_f32(c[e + 2]),
                    to_f32(c[e + 3]));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, bool Q, int NV>
__global__ void __launch_bounds__(1024)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       float* __restrict__ out,
                       int pps, int page, int hkv, int group, float sm_scale) {
  constexpr int D = NV * 32;
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int kNVec = D / kVec;           // 16-byte loads per token row
  constexpr int kR = 4;
  extern __shared__ float smem[];
  float* k_sh = smem;                    // [page, D]
  float* v_sh = k_sh + page * D;         // [page, D]
  float* s_sh = v_sh + page * D;         // [group, page] scores
  float* ks_sh = s_sh + group * page;    // [page] (quantized only)
  float* vs_sh = ks_sh + page;           // [page] (quantized only)

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int head = kvh * group + warp;
  const int length = lengths[b];

  const float* q_row = q + ((size_t)b * hkv * group + head) * D;
  float qv[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qv[i] = q_row[lane + 32 * i];
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int n_pages = (length + page - 1) / page;
  n_pages = n_pages < pps ? n_pages : pps;
  const size_t tok_stride = (size_t)hkv * D;
  float* s_w = s_sh + warp * page;

  for (int pi = 0; pi < n_pages; ++pi) {
    const int phys = page_table[(size_t)b * pps + pi];
    const int rest = length - pi * page;
    const int n_valid = rest < page ? rest : page;
    const size_t base = (size_t)phys * page * tok_stride + (size_t)kvh * D;
    // 16-byte loads, kR of k and of v in flight per thread before any
    // is converted and stored (one round per page at granite's shapes)
    const int total = n_valid * kNVec;
    for (int i0 = threadIdx.x; i0 < total; i0 += kR * blockDim.x) {
      uint4 kr[kR], vr[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < total) {
          const size_t g = base + (size_t)(i / kNVec) * tok_stride +
                           (i % kNVec) * kVec;
          kr[j] = __ldg(reinterpret_cast<const uint4*>(k_pages + g));
          vr[j] = __ldg(reinterpret_cast<const uint4*>(v_pages + g));
        }
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < total) {
          const int o = (i / kNVec) * D + (i % kNVec) * kVec;
          cvt_store(k_sh + o, kr[j], T());
          cvt_store(v_sh + o, vr[j], T());
        }
      }
    }
    if (Q) {
      for (int t = threadIdx.x; t < n_valid; t += blockDim.x) {
        const size_t g = ((size_t)phys * page + t) * hkv + kvh;
        ks_sh[t] = k_scale[g];
        vs_sh[t] = v_scale[g];
      }
    }
    __syncthreads();

    // scores of this warp's head against the page's valid positions;
    // the xor butterfly leaves the same sum in every lane
    float m_page = kNegInf;
#pragma unroll 4
    for (int t = 0; t < n_valid; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) part += qv[i] * k_sh[t * D + lane + 32 * i];
      float s = warp_sum(part);
      s = Q ? s * ks_sh[t] * sm_scale : s * sm_scale;
      m_page = fmaxf(m_page, s);
      if (lane == 0) s_w[t] = s;
    }
    __syncwarp();

    const float m_new = fmaxf(m, m_page);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] *= alpha;
    for (int t = 0; t < n_valid; ++t) {
      const float p = expf(s_w[t] - m_new);
      l += p;
      const float pw = Q ? p * vs_sh[t] : p;
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] += pw * v_sh[t * D + lane + 32 * i];
    }
    m = m_new;
    __syncthreads();   // the next page overwrites the shared tiles
  }

  const float denom = fmaxf(l, 1e-30f);
  float* o_row = out + ((size_t)b * hkv * group + head) * D;
#pragma unroll
  for (int i = 0; i < NV; ++i) o_row[lane + 32 * i] = acc[i] / denom;
}

template <typename T, bool Q, int NV>
cudaError_t launch_nv(const float* q, const T* k, const T* v,
                      const float* ks, const float* vs, const int* table,
                      const int* lengths, float* out, int b, int hkv,
                      int group, int pps, int page, float sm_scale,
                      cudaStream_t stream) {
  constexpr int D = NV * 32;
  const size_t smem = sizeof(float) * ((size_t)2 * page * D +
                                       (size_t)group * page + 2 * page);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, Q, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(b, hkv);
  paged_attention_kernel<T, Q, NV><<<grid, group * 32, smem, stream>>>(
      q, k, v, ks, vs, table, lengths, out, pps, page, hkv, group, sm_scale);
  return cudaGetLastError();
}

template <typename T, bool Q>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths, void* out,
           int b, int h, int hkv, int d, int pps, int page, void* stream) {
  if (hkv <= 0 || h % hkv || h / hkv > kMaxGroup || d % 32 || d < 32 ||
      d > 256 || page < 1 || page > kMaxPage || pps < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  const int group = h / hkv;
  const float sm_scale = 1.0f / sqrtf((float)d);
  auto qf = static_cast<const float*>(q);
  auto kt = static_cast<const T*>(k);
  auto vt = static_cast<const T*>(v);
  auto ksf = static_cast<const float*>(ks);
  auto vsf = static_cast<const float*>(vs);
  auto tb = static_cast<const int*>(table);
  auto ln = static_cast<const int*>(lengths);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d / 32) {
#define CASE(NV) \
    case NV: return (int)launch_nv<T, Q, NV>(qf, kt, vt, ksf, vsf, tb, ln, o, \
                                              b, hkv, group, pps, page,       \
                                              sm_scale, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take.

int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* page_table,
                        const void* lengths, void* out, int b, int h, int hkv,
                        int d, int pps, int page, void* stream) {
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr,
                              page_table, lengths, out, b, h, hkv, d, pps,
                              page, stream);
}

int paged_attention_q8_int8(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* page_table,
                            const void* lengths, void* out, int b, int h,
                            int hkv, int d, int pps, int page, void* stream) {
  return launch<int8_t, true>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, lengths, out, b, h, hkv, d, pps,
                              page, stream);
}

int paged_attention_q8_fp8(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* page_table,
                           const void* lengths, void* out, int b, int h,
                           int hkv, int d, int pps, int page, void* stream) {
  return launch<__nv_fp8_e4m3, true>(q, k_pages, v_pages, k_scale, v_scale,
                                     page_table, lengths, out, b, h, hkv, d,
                                     pps, page, stream);
}

}  // extern "C"
