// The in-storage scan's two-launch design, kept for comparison with
// src/repro_torch/kernels/csrc/isp_scan.cu on the card
// (scripts/redesign_check.py scan).  Not part of the package: the
// package's build never compiles it.
//
// (a) scan_pages_kernel: one thread per (valid page, column) walks the
//     page's rows in order and writes the page partials [n_valid, 4,
//     n_cols] (count, sum, min, max);
// (b) scan_fold_kernel: one block per 32 columns adds the partials' sums
//     in page order (one lane a column); each of its 16 warps folds the
//     counts of the pages it loads, and the warps' counts are added last
//     (equal to the page-order fold only below 2^24 rows).
// Exported: scan_two_pass_<fmt> (both launches), scan_pages_<fmt> (a
// alone) and scan_fold (b alone over partials a left), each returning
// cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPosInf = 1e30f;
constexpr float kNegInf = -1e30f;
constexpr int kFoldThreads = 512;  // scan fold block
constexpr int kFoldChunk = 256;    // pages staged per fold round
constexpr int kFoldBatch = 16;     // shared-memory reads in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// element `elem` of the pool, dequantised with the scale of its row
template <typename T, bool Q>
__device__ __forceinline__ float load_value(const T* __restrict__ pages,
                                            const float* __restrict__ scales,
                                            size_t elem, size_t row) {
  const float v = to_f32(pages[elem]);
  return Q ? __fmul_rn(v, scales[row]) : v;
}

// FILTER_OPS order: all, ge, lt, eq, ne
__device__ __forceinline__ bool predicate(float key, float thr, int op) {
  switch (op) {
    case 0: return true;
    case 1: return key >= thr;
    case 2: return key < thr;
    case 3: return key == thr;
    default: return key != thr;
  }
}

// ---------------------------------------------------------------- scan

template <typename T, bool Q>
__global__ void scan_pages_kernel(const T* __restrict__ pages,
                                  const float* __restrict__ scales,
                                  const int* __restrict__ table,
                                  float* __restrict__ partials, int n_valid,
                                  int page_rows, int n_cols, long long n_rows,
                                  float thr, int filter_col, int op) {
  const long long total = (long long)n_valid * n_cols;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const int p = (int)(t / n_cols);
    const int c = (int)(t % n_cols);
    const size_t row0 = (size_t)table[p] * page_rows;
    float cnt = 0.f, sum = 0.f, mn = kPosInf, mx = kNegInf;
    // unrolled so that several rows' loads are in flight at once
#pragma unroll 4
    for (int r = 0; r < page_rows; ++r) {
      const size_t row = row0 + r;
      const float key = load_value<T, Q>(pages, scales,
                                         row * n_cols + filter_col, row);
      const float v = load_value<T, Q>(pages, scales, row * n_cols + c, row);
      const bool m = (long long)p * page_rows + r < n_rows &&
                     predicate(key, thr, op);
      cnt = __fadd_rn(cnt, m ? 1.f : 0.f);
      sum = __fadd_rn(sum, m ? v : 0.f);
      mn = fminf(mn, m ? v : kPosInf);
      mx = fmaxf(mx, m ? v : kNegInf);
    }
    float* o = partials + (size_t)p * 4 * n_cols + c;
    o[0] = cnt;
    o[n_cols] = sum;
    o[2 * n_cols] = mn;
    o[3 * n_cols] = mx;
  }
}

// One block per 32 columns.  Each round stages kFoldChunk pages' sums in
// shared memory, and warp 0 adds them in page order, one lane per column,
// while all warps' loads of the next round are in flight in registers.
// Count, min and max do not depend on the order (the counts are
// integer-valued and their total is exact below 2^24): each warp folds
// those of the pages it loads, and the warps' results are combined last.
__global__ void __launch_bounds__(kFoldThreads)
scan_fold_kernel(const float* __restrict__ partials, float* __restrict__ out,
                 int n_valid, int n_cols) {
  constexpr int kWarps = kFoldThreads / 32;
  constexpr int kPer = kFoldChunk / kWarps;   // pages a warp loads a round
  __shared__ float sums[kFoldChunk][33];
  __shared__ float red[3][kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool live = c < n_cols;
  const size_t stride = 4 * (size_t)n_cols;
  float cnt = 0.f, sum = 0.f, mn = kPosInf, mx = kNegInf;
  float a[kPer][4];
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = base + warp + kWarps * i;
      const bool ok = live && p < n_valid;
      const float* q = partials + (size_t)(ok ? p : 0) * stride + (live ? c : 0);
      a[i][0] = ok ? q[0] : 0.f;
      a[i][1] = ok ? q[n_cols] : 0.f;
      a[i][2] = ok ? q[2 * n_cols] : kPosInf;
      a[i][3] = ok ? q[3 * n_cols] : kNegInf;
    }
  };
  load(0);
  for (int base = 0; base < n_valid; base += kFoldChunk) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      cnt += a[i][0];
      sums[warp + kWarps * i][lane] = a[i][1];
      mn = fminf(mn, a[i][2]);
      mx = fmaxf(mx, a[i][3]);
    }
    __syncthreads();
    if (base + kFoldChunk < n_valid) load(base + kFoldChunk);
    if (warp == 0 && live) {
      const int n = n_valid - base < kFoldChunk ? n_valid - base : kFoldChunk;
      int j = 0;
      // the shared-memory reads of a batch go out together; the adds
      // then run in page order
      for (; j + kFoldBatch <= n; j += kFoldBatch) {
        float b[kFoldBatch];
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u) b[u] = sums[j + u][lane];
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u) sum = __fadd_rn(sum, b[u]);
      }
      for (; j < n; ++j) sum = __fadd_rn(sum, sums[j][lane]);
    }
    __syncthreads();
  }
  red[0][warp][lane] = cnt;
  red[1][warp][lane] = mn;
  red[2][warp][lane] = mx;
  __syncthreads();
  if (warp != 0 || !live) return;
  for (int w = 1; w < kWarps; ++w) {
    cnt += red[0][w][lane];
    mn = fminf(mn, red[1][w][lane]);
    mx = fmaxf(mx, red[2][w][lane]);
  }
  out[c] = cnt;
  out[n_cols + c] = sum;
  out[2 * n_cols + c] = mn;
  out[3 * n_cols + c] = mx;
  for (int r = 4; r < 8; ++r) out[r * n_cols + c] = 0.f;
}

template <typename T, bool Q>
int launch_pages(const void* pages, const void* scales, const void* table,
                 void* partials, int n_valid, int page_rows, int n_cols,
                 long long n_rows, float thr, int filter_col, int op,
                 void* stream) {
  if (n_valid < 1 || page_rows < 1 || n_cols < 1 || filter_col < 0 ||
      filter_col >= n_cols || op < 0 || op > 4 || (Q && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n_valid * n_cols;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 16 ? want : 65535 * 16);
  scan_pages_kernel<T, Q><<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pages), static_cast<const float*>(scales),
      static_cast<const int*>(table), static_cast<float*>(partials), n_valid,
      page_rows, n_cols, n_rows, thr, filter_col, op);
  return (int)cudaGetLastError();
}

int launch_fold(const void* partials, void* out, int n_valid, int n_cols,
                void* stream) {
  if (n_valid < 1 || n_cols < 1) return (int)cudaErrorInvalidValue;
  scan_fold_kernel<<<(n_cols + 31) / 32, kFoldThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), n_valid,
      n_cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define SCAN(FMT, T, Q)                                                      \
  int scan_pages_##FMT(const void* pages, const void* scales,                \
                       const void* table, void* partials, int n_valid,       \
                       int page_rows, int n_cols, long long n_rows,          \
                       float thr, int filter_col, int op, void* stream) {    \
    return launch_pages<T, Q>(pages, scales, table, partials, n_valid,       \
                              page_rows, n_cols, n_rows, thr, filter_col,    \
                              op, stream);                                   \
  }                                                                          \
  int scan_two_pass_##FMT(const void* pages, const void* scales,             \
                          const void* table, void* partials, void* out,      \
                          int n_valid, int page_rows, int n_cols,            \
                          long long n_rows, float thr, int filter_col,       \
                          int op, void* stream) {                            \
    const int err = launch_pages<T, Q>(pages, scales, table, partials,       \
                                       n_valid, page_rows, n_cols, n_rows,   \
                                       thr, filter_col, op, stream);         \
    return err ? err : launch_fold(partials, out, n_valid, n_cols, stream);  \
  }
SCAN(f32, float, false)
SCAN(int8, int8_t, true)
SCAN(fp8, __nv_fp8_e4m3, true)
#undef SCAN

int scan_fold(const void* partials, void* out, int n_valid, int n_cols,
              void* stream) {
  return launch_fold(partials, out, n_valid, n_cols, stream);
}

}  // extern "C"
