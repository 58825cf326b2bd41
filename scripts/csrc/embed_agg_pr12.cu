// The embedding kernels' first design, kept for comparison with
// src/repro_torch/kernels/csrc/embed_agg.cu on the card
// (scripts/redesign_check.py embed).  Not part of the package: the
// package's build never compiles it.  f32 tables only (and int32 rows
// for the gather); the bag kernel runs a block a bag, a thread an
// element, four lookups unrolled; the gather a thread an element.
//
// Embedding bag and batched row gather for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernels in
// repro/kernels/embed_agg.py:
//   * _embed_kernel (:23)   -> embed_agg: out[b] = sum over l = 0..L-1,
//     in lookup order from 0, of w[b, l] * table[idx[b, l]] (the product
//     rounded before its add; unweighted: the rows themselves), [B, D] f32
//   * _gather_kernel (:94)  -> embed_gather_f32 / _i32: out[b, k] =
//     table[idx[b, k]], [B, K, D], the 4-byte element kept
// The order of the bag's adds is the contract: __fmul_rn / __fadd_rn, so
// nvcc cannot contract them into an FMA and the result equals the plain
// version (kernels/ref.py) bit for bit.
//
// Bound on this card: memory bytes, the looked-up rows (each distinct row
// once), the indices, the weights and the output.  Both kernels are row
// copies driven by indices: embed_agg runs one block per bag with threads
// over D (neighbouring threads read neighbouring elements of a row, so
// each row read coalesces), each thread walking the bag's L lookups in
// order; embed_gather runs one thread per output element.  Ids are checked
// in [0, V) by the wrapper before launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool Weighted>
__global__ void embed_agg_kernel(const float* __restrict__ table,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ w,
                                 float* __restrict__ out, int n_look, int d) {
  const size_t b = blockIdx.x;
  const int* bag = idx + b * n_look;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int l = 0; l < n_look; ++l) {
      const float x = table[(size_t)bag[l] * d + j];
      acc = Weighted ? __fadd_rn(acc, __fmul_rn(w[b * n_look + l], x))
                     : __fadd_rn(acc, x);
    }
    out[b * d + j] = acc;
  }
}

template <typename T>
__global__ void embed_gather_kernel(const T* __restrict__ table,
                                    const int* __restrict__ idx,
                                    T* __restrict__ out, long long n_rows,
                                    int d) {
  const long long total = n_rows * d;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step)
    out[e] = table[(size_t)idx[e / d] * d + e % d];
}

template <typename T>
int launch_gather(const void* table, const void* idx, void* out,
                  long long n_rows, int d, void* stream) {
  if (n_rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const long long want = (n_rows * d + 255) / 256;
  const int blocks = (int)(want < 65535 * 16 ? want : 65535 * 16);
  embed_gather_kernel<T><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<T*>(out), n_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take.

int embed_agg(const void* table, const void* idx, const void* weights,
              void* out, int b, int n_look, int d, void* stream) {
  if (b < 1 || n_look < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int threads = d < 256 ? ((d + 31) / 32) * 32 : 256;
  auto st = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const float*>(table);
  auto ix = static_cast<const int*>(idx);
  auto w = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  if (w != nullptr)
    embed_agg_kernel<true><<<b, threads, 0, st>>>(tb, ix, w, o, n_look, d);
  else
    embed_agg_kernel<false><<<b, threads, 0, st>>>(tb, ix, w, o, n_look, d);
  return (int)cudaGetLastError();
}

int embed_gather_f32(const void* table, const void* idx, void* out,
                     long long n_rows, int d, void* stream) {
  return launch_gather<float>(table, idx, out, n_rows, d, stream);
}

int embed_gather_i32(const void* table, const void* idx, void* out,
                     long long n_rows, int d, void* stream) {
  return launch_gather<int32_t>(table, idx, out, n_rows, d, stream);
}

}  // extern "C"
