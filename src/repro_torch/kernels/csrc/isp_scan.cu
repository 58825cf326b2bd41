// In-storage scan/filter/reduce and query-scored top-k for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernels in
// repro/kernels/isp_scan.py:
//   * _scan_kernel (:120), _scan_q_kernel (:162), fold _fold_block (:95)
//       -> scan_filter_reduce_f32 / _int8 / _fp8
//   * _topk_kernel (:376), _topk_q_kernel (:414), _topk_fold_page (:335),
//     _topk_merge (:304)
//       -> topk_scan_f32 / _int8 / _fp8
// Same functions over a pool of pages [n_phys, page_rows, n_cols] (f32,
// or int8 / fp8-e4m3 codes with per-row f32 scales, dequantised in
// registers as code * scale) addressed by a page table whose first
// n_valid = min(max(ceil(n_rows / page_rows), 1), pps) entries are read.
//
// The contract is bit-identity with the page-sequential fold
// (kernels/ref.py): every f32 multiply and add whose order is fixed goes
// through __fmul_rn / __fadd_rn (nvcc cannot contract them into an FMA),
// and sqrt / division are __fsqrt_rn / __fdiv_rn.
//
// Bound on this card: memory bytes, the valid pages (and their scales)
// read once; a scan does a few operations per byte read.
//
// scan_filter_reduce, two launches:
//   (a) one thread per (valid page, column) walks the page's rows
//       0..page_rows-1 in order and writes its page partials
//       [n_valid, 4, n_cols]: count, sum, min, max.  Threads of a page
//       read neighbouring columns of a row, so loads coalesce.
//   (b) per column, the sums of the partials are added in page order in
//       f32 (staged through shared memory, one lane per column); count,
//       min and max do not depend on the order (the count is a sum of
//       integer-valued f32s: exact below 2^24 rows).  It writes the
//       [8, n_cols] block (count broadcast, sum, min, max, zero rows).
// topk_scan, three or four launches:
//   (a) one block per contiguous group of valid pages (about two blocks
//       per SM); one thread per page row carries its row's score chain
//       s = w[0]; s = s + w[c] with w = x * q rounded first.  Column
//       tiles of the page pass through shared memory for coalesced
//       loads (16 bytes of f32 or 4 bytes of codes a load when rows are
//       multiples of 4; the next tile's loads are in flight in registers
//       while this one is scored), and the chain carries across tiles in
//       order.  A page whose
//       rows can beat the block's k-th best is merged into the block's
//       running top-k by a bitonic sort under (score desc, id asc).  The
//       block writes its k candidates.
//   (b) rounds of merges under the same order, each block sorting 1024
//       candidates (kSortMerge / k lists) into one list of k, until one
//       block writes the [8, topk_pad(k)] block (two or three launches).
//       Row ids are unique, so the order is total and the result equals
//       the TPU's sequential merge.
//
// Known limits, for later work: (b) of the scan is one dependent add
// chain per column over all pages (latency-bound, not byte-bound); the
// top-k page loads are not TMA, and a block's pages are scored one after
// another.

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr float kPosInf = 1e30f;
constexpr float kNegInf = -1e30f;
constexpr int kBigId = 1 << 30;
constexpr int kMaxTopk = 128;
constexpr int kTopkThreads = 256;  // >= page_rows
constexpr int kTile = 32;          // columns per shared-memory tile
constexpr int kSortPage = 512;     // pow2 >= kMaxTopk + kTopkThreads
constexpr int kMergeThreads = 512;
constexpr int kSortMerge = 1024;
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

// V consecutive elements of a row of the pool (V = 1, or 4 from one 16-byte
// f32 or 4-byte code load), dequantised with the row's scale
template <typename T, bool Q, int V>
__device__ __forceinline__ void load_values(const T* __restrict__ pages,
                                            const float* __restrict__ scales,
                                            size_t elem, size_t row,
                                            float* out) {
  if constexpr (V == 1) {
    out[0] = load_value<T, Q>(pages, scales, elem, row);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(pages + elem);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(pages + elem);
    const float sc = Q ? scales[row] : 1.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint8_t byte = (w >> (8 * e)) & 0xffu;
      const float x = to_f32(*reinterpret_cast<const T*>(&byte));
      out[e] = Q ? __fmul_rn(x, sc) : x;
    }
  }
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
int launch_scan(const void* pages, const void* scales, const void* table,
                void* partials, void* out, int n_valid, int page_rows,
                int n_cols, long long n_rows, float thr, int filter_col,
                int op, void* stream) {
  if (n_valid < 1 || page_rows < 1 || n_cols < 1 || filter_col < 0 ||
      filter_col >= n_cols || op < 0 || op > 4 || (Q && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n_valid * n_cols;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 16 ? want : 65535 * 16);
  scan_pages_kernel<T, Q><<<blocks, threads, 0, st>>>(
      static_cast<const T*>(pages), static_cast<const float*>(scales),
      static_cast<const int*>(table), static_cast<float*>(partials), n_valid,
      page_rows, n_cols, n_rows, thr, filter_col, op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_fold_kernel<<<(n_cols + 31) / 32, kFoldThreads, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), n_valid,
      n_cols);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- top-k

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Block-wide bitonic sort of n (a power of two) pairs in shared memory,
// best first.  Callers synchronise before; it synchronises after.
__device__ void bitonic_sort(float* s, int* id, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool best_first = (i & size) == 0;
          const bool swap = best_first ? better(s[j], id[j], s[i], id[i])
                                       : better(s[i], id[i], s[j], id[j]);
          if (swap) {
            const float ts = s[i];
            s[i] = s[j];
            s[j] = ts;
            const int ti = id[i];
            id[i] = id[j];
            id[j] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, bool Q, int V>
__global__ void __launch_bounds__(kTopkThreads)
topk_pages_kernel(const T* __restrict__ pages,
                  const float* __restrict__ scales,
                  const float* __restrict__ query,
                  const int* __restrict__ table, float* __restrict__ cand_s,
                  int* __restrict__ cand_i, int n_valid, int page_rows,
                  int n_cols, long long n_rows, int k, int cosine,
                  int n_blocks) {
  // a step is one column tile of one page; a thread loads V columns
  // from col_in of rows row_in, row_in + kRowStep, ... of the tile
  constexpr int kLanesPerRow = kTile / V;
  constexpr int kRowStep = kTopkThreads / kLanesPerRow;
  constexpr int kLoads = kTopkThreads / kRowStep;
  __shared__ float tile[kTopkThreads][kTile + 1];
  __shared__ float q_sh[kTile];
  // [0, k) the block's running best, [k, k + page_rows) a page's rows
  __shared__ float srt_s[kSortPage];
  __shared__ int srt_i[kSortPage];

  const int t = threadIdx.x;
  const int col_in = (t % kLanesPerRow) * V, row_in = t / kLanesPerRow;
  const int p0 = (int)((long long)n_valid * blockIdx.x / n_blocks);
  const int p1 = (int)((long long)n_valid * (blockIdx.x + 1) / n_blocks);
  const int n_tiles = (n_cols + kTile - 1) / kTile;
  const int n_steps = (p1 - p0) * n_tiles;
  int n_sort = 1;
  while (n_sort < k + page_rows) n_sort <<= 1;
  for (int i = t; i < kSortPage; i += blockDim.x) {
    srt_s[i] = kNegInf;
    srt_i[i] = kBigId;
  }

  // the next step's tile is loaded into registers while this one is
  // scored from shared memory
  float v[kLoads][V];
  auto load_step = [&](int step) {
    const size_t row0 = (size_t)table[p0 + step / n_tiles] * page_rows;
    const int c = (step % n_tiles) * kTile + col_in;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int r = row_in + kRowStep * j;
      if (r < page_rows && c < n_cols) {
        load_values<T, Q, V>(pages, scales, (row0 + r) * n_cols + c,
                             row0 + r, v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[j][e] = 0.f;
      }
    }
  };
  if (n_steps > 0) load_step(0);
  float s = 0.f, nrm = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int p = p0 + step / n_tiles;
    const int c0 = (step % n_tiles) * kTile;
    const int tc = n_cols - c0 < kTile ? n_cols - c0 : kTile;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int r = row_in + kRowStep * j;
      if (r < page_rows) {
#pragma unroll
        for (int e = 0; e < V; ++e) tile[r][col_in + e] = v[j][e];
      }
    }
    if (t < tc) q_sh[t] = query[c0 + t];
    __syncthreads();
    if (step + 1 < n_steps) load_step(step + 1);
    if (t < page_rows) {
      for (int c = 0; c < tc; ++c) {
        const float x = tile[t][c];
        const float w = __fmul_rn(x, q_sh[c]);
        const float xx = __fmul_rn(x, x);
        if (c0 + c == 0) {
          s = w;
          nrm = xx;
        } else {
          s = __fadd_rn(s, w);
          nrm = __fadd_rn(nrm, xx);
        }
      }
    }
    __syncthreads();
    if (c0 + tc < n_cols) continue;       // the page's last tile is done
    const long long pos = (long long)p * page_rows + t;
    const bool valid = t < page_rows && pos < n_rows;
    const float score =
        cosine ? __fdiv_rn(s, fmaxf(__fsqrt_rn(nrm), 1e-6f)) : s;
    // merge only a page that has a row the running k-th best loses to
    const bool wins = valid && better(score, (int)pos, srt_s[k - 1],
                                      srt_i[k - 1]);
    if (__syncthreads_or(wins)) {
      if (t < page_rows) {
        srt_s[k + t] = valid ? score : kNegInf;
        srt_i[k + t] = valid ? (int)pos : kBigId;
      }
      __syncthreads();
      bitonic_sort(srt_s, srt_i, n_sort);
      for (int i = k + t; i < n_sort; i += blockDim.x) {
        srt_s[i] = kNegInf;
        srt_i[i] = kBigId;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int i = t; i < k; i += blockDim.x) {
    cand_s[(size_t)blockIdx.x * k + i] = srt_s[i];
    cand_i[(size_t)blockIdx.x * k + i] = srt_i[i];
  }
}

// One round of the merge: each block takes kSortMerge / k of the sorted
// candidate lists, sorts them together and keeps the k best as one list
// (or, in the last round, writes the [8, kpad] block).  Any grouping
// gives the same k: the order is total.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ cand_s,
                  const int* __restrict__ cand_i, int n_lists, int k,
                  int kpad, float* __restrict__ next_s,
                  int* __restrict__ next_i, float* __restrict__ out) {
  __shared__ float s[kSortMerge];
  __shared__ int id[kSortMerge];
  const int group = kSortMerge / k;
  const int first = blockIdx.x * group;
  const int n = (n_lists - first < group ? n_lists - first : group) * k;
  const size_t base = (size_t)first * k;
  for (int i = threadIdx.x; i < kSortMerge; i += blockDim.x) {
    s[i] = i < n ? cand_s[base + i] : kNegInf;
    id[i] = i < n ? cand_i[base + i] : kBigId;
  }
  __syncthreads();
  bitonic_sort(s, id, kSortMerge);
  if (out == nullptr) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      next_s[(size_t)blockIdx.x * k + i] = s[i];
      next_i[(size_t)blockIdx.x * k + i] = id[i];
    }
    return;
  }
  for (int i = threadIdx.x; i < 8 * kpad; i += blockDim.x) {
    const int r = i / kpad, c = i % kpad;
    float v = 0.f;
    if (c < k && r == 0) v = s[c];
    if (c < k && r == 1) v = static_cast<float>(id[c]);
    out[i] = v;
  }
}

template <typename T, bool Q>
int launch_topk(const void* pages, const void* scales, const void* query,
                const void* table, void* cand_s, void* cand_i, void* out,
                int n_valid, int page_rows, int n_cols, long long n_rows,
                int k, int kpad, int cosine, int n_blocks, void* stream) {
  if (n_valid < 1 || page_rows < 1 || page_rows > kTopkThreads ||
      n_cols < 1 || k < 1 || k > kMaxTopk || kpad < k || n_blocks < 1 ||
      n_blocks > n_valid || (Q && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  // cand_s / cand_i hold two [n_blocks, k] halves: the merge rounds
  // ping-pong between them
  float* src_s = static_cast<float*>(cand_s);
  int* src_i = static_cast<int*>(cand_i);
  float* dst_s = src_s + (size_t)n_blocks * k;
  int* dst_i = src_i + (size_t)n_blocks * k;
  // rows of 4-element multiples, and an aligned pool, take wide loads
  auto kernel = n_cols % 4 == 0 &&
                reinterpret_cast<uintptr_t>(pages) % (4 * sizeof(T)) == 0
                    ? topk_pages_kernel<T, Q, 4>
                    : topk_pages_kernel<T, Q, 1>;
  kernel<<<n_blocks, kTopkThreads, 0, st>>>(
      static_cast<const T*>(pages), static_cast<const float*>(scales),
      static_cast<const float*>(query), static_cast<const int*>(table),
      src_s, src_i, n_valid, page_rows, n_cols, n_rows, k, cosine, n_blocks);
  cudaError_t err = cudaGetLastError();
  const int group = kSortMerge / k;
  for (int n = n_blocks; err == cudaSuccess;) {
    const int blocks = (n + group - 1) / group;
    topk_merge_kernel<<<blocks, kMergeThreads, 0, st>>>(
        src_s, src_i, n, k, kpad, dst_s, dst_i,
        blocks == 1 ? static_cast<float*>(out) : nullptr);
    err = cudaGetLastError();
    if (blocks == 1) break;
    float* ts = src_s;
    src_s = dst_s;
    dst_s = ts;
    int* ti = src_i;
    src_i = dst_i;
    dst_i = ti;
    n = blocks;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after its launches (0 on
// success), or cudaErrorInvalidValue for arguments the kernels do not take.

#define SCAN(NAME, T, Q)                                                    \
  int NAME(const void* pages, const void* scales, const void* table,      \
           void* partials, void* out, int n_valid, int page_rows,          \
           int n_cols, long long n_rows, float thr, int filter_col,        \
           int op, void* stream) {                                         \
    return launch_scan<T, Q>(pages, scales, table, partials, out, n_valid, \
                             page_rows, n_cols, n_rows, thr, filter_col,   \
                             op, stream);                                  \
  }
SCAN(scan_filter_reduce_f32, float, false)
SCAN(scan_filter_reduce_int8, int8_t, true)
SCAN(scan_filter_reduce_fp8, __nv_fp8_e4m3, true)
#undef SCAN

#define TOPK(NAME, T, Q)                                                    \
  int NAME(const void* pages, const void* scales, const void* query,      \
           const void* table, void* cand_s, void* cand_i, void* out,       \
           int n_valid, int page_rows, int n_cols, long long n_rows, int k, \
           int kpad, int cosine, int n_blocks, void* stream) {             \
    return launch_topk<T, Q>(pages, scales, query, table, cand_s, cand_i,  \
                             out, n_valid, page_rows, n_cols, n_rows, k,   \
                             kpad, cosine, n_blocks, stream);              \
  }
TOPK(topk_scan_f32, float, false)
TOPK(topk_scan_int8, int8_t, true)
TOPK(topk_scan_fp8, __nv_fp8_e4m3, true)
#undef TOPK

}  // extern "C"
