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
// topk_scan, one launch (the redesign for Hopper): bound by the valid
//   pages' bytes (int8/fp8: 0.23 ms at 1M x 768 on 3.35 TB/s).  A row's
//   score is one dependent add chain in column order, so parallelism is
//   across rows and pages only; the work is to keep enough bytes in
//   flight and spend few instructions a byte:
//   * one or two persistent blocks an SM, each over a contiguous range
//     of pages; one row thread a page row, plus a producer warp;
//   * a stage is page_rows x 128 bytes (32 f32 columns, 128 codes), one
//     TMA box of the pool viewed as 2-D [n_phys * page_rows, n_cols]
//     (the page table gives the box's row), 128-byte swizzled, with the
//     query's columns and, on a page's first stage, its row scales
//     (cp.async.bulk) on the same mbarrier; a ring of up to 4 stages
//     keeps ~48 KB a block in flight whatever the page format;
//   * row t reads its 16-byte chunk j at j ^ (t & 7): a quarter warp's
//     eight rows hit eight distinct 16-byte bank groups, no conflicts;
//   * codes are converted in registers: int8 by one byte permute under
//     the exponent of 2^23 and one exact subtraction, fp8 two at a time
//     through f16x2; then code * scale, x * q and the add, in order;
//   * at a page's end its rows that beat the block's running k-th best
//     are appended to a shared candidate buffer, sorted in (bitonic) once
//     max(k, 32) have gathered, so a page costs one barrier and a sort
//     is short enough for the ring's stages in flight to cover;
//   * the last block to finish (an atomic ticket after __threadfence)
//     merges the blocks' sorted lists a position at a time, stopping at
//     the first position where nothing beats its running k-th best,
//     writes the [8, topk_pad(k)] block and resets the ticket.
//   Row ids are unique, so (score desc, id asc) is a total order and the
//   result equals the TPU's sequential merge.
//   Any pool the reference takes: a page is walked as units of at most
//   kMaxUnitRows (256) rows in row order (a TMA box has at most 256 rows;
//   one row thread a unit row), the blocks taking contiguous ranges of
//   units, candidates gathered at each unit's end (ids stay page *
//   page_rows + row).  Rows whose bytes are not a multiple of 16 (or a
//   pool or query not 16-byte aligned), and code pages of rows not a
//   multiple of 4 (their scales are no 16-byte copy), go to the direct
//   instantiation: no ring and no producer warp, each row thread reads
//   its row from device memory through L1 (32-bit words of codes where
//   rows are a multiple of 4 bytes, else elements), the query by
//   broadcast loads, its scale itself (a unit ahead, the page id two
//   units ahead); there pages of at most kGroupMax (128) rows go as many
//   whole pages a unit as fit in 256 rows, so a unit's barrier and
//   candidate round serve up to 256 rows, not a few, and a block has up
//   to 8 warps.  Every path adds a row's columns in
//   order, the chain of ref.topk_blocks_emulated, so all agree bit for
//   bit.
//
// Known limits, for later work: (b) of the scan is one dependent add
// chain per column over all pages (latency-bound, not byte-bound).

#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPosInf = 1e30f;
constexpr float kNegInf = -1e30f;
constexpr int kBigId = 1 << 30;
constexpr int kMaxTopk = 128;
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

constexpr int kStageRowBytes = 128;   // bytes of every page row in one stage
constexpr int kMaxStages = 4;
constexpr int kRingBytes = 96 * 1024; // the ring's budget: two blocks an SM
constexpr int kMaxUnitRows = 256;     // one row thread a unit row (TMA box <= 256)
constexpr int kGroupMax = 128;        // direct: pages of up to this many rows grouped
constexpr int kSortCap = 1024;        // the best k, then the pending candidates
constexpr int kFlushAt = 32;          // candidates that trigger a sort (or k)
constexpr int kMaxTopkBlocks = 512;   // a merge round's k + blocks fit kSortCap
constexpr int kMergePer = kMaxTopkBlocks / 32;   // lists a row thread merges
constexpr int kRowsBar = 1;           // named barrier of the row threads

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of the pool's 2-D tensor map (columns c0.., rows r0..) into
// shared memory, 128-byte swizzled, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void rows_sync(int n) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kRowsBar), "r"(n) : "memory");
}

// barrier of the row threads that returns how many of them passed `pred`
__device__ __forceinline__ int rows_count(bool pred, int n) {
  int c;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.popc.u32 %0, %2, %3, p;\n"
      "}\n"
      : "=r"(c)
      : "r"((int)pred), "n"(kRowsBar), "r"(n)
      : "memory");
  return c;
}

// Bitonic sort of n (a power of two) pairs in shared memory, best first,
// by the n_rt row threads, each taking compare-exchange pairs (i, i +
// stride) directly; each pass ends on their barrier.
__device__ void bitonic_rows(float* s, int* id, int n, int t, int n_rt) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = t; p < n / 2; p += n_rt) {
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int j = i + stride;
        const bool best_first = (i & size) == 0;
        const float si = s[i], sj = s[j];
        const int ii = id[i], ij = id[j];
        if (best_first ? better(sj, ij, si, ii) : better(si, ii, sj, ij)) {
          s[i] = sj;
          s[j] = si;
          id[i] = ij;
          id[j] = ii;
        }
      }
      rows_sync(n_rt);
    }
  }
}

// Sort the best k [0, k) and the pending candidates [k, k + pending)
// together (called by all row threads after their barrier); the k best
// end up in [0, k).
__device__ void flush(float* s, int* id, int k, int pending, int t, int n_rt) {
  int n = 1;
  while (n < k + pending) n <<= 1;
  for (int i = k + pending + t; i < n; i += n_rt) {
    s[i] = kNegInf;
    id[i] = kBigId;
  }
  rows_sync(n_rt);
  bitonic_rows(s, id, n, t, n_rt);
}

// The warp's winners take the next free candidate slots; `base` is the
// running count at the last flush (slots k.. hold what came since).
__device__ __forceinline__ void append(bool wins, float score, int pos,
                                       float* s, int* id, int* count, int k,
                                       int base) {
  const unsigned m = __ballot_sync(0xffffffffu, wins);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  int first = 0;
  if (lane == 0) first = atomicAdd(count, __popc(m));
  first = __shfl_sync(0xffffffffu, first, 0);
  if (wins) {
    const int slot = k + first - base + __popc(m & ((1u << lane) - 1u));
    s[slot] = score;
    id[slot] = pos;
  }
}

template <bool COS>
__device__ __forceinline__ void score_step(float x, float q, float& s,
                                           float& nrm) {
  s = __fadd_rn(s, __fmul_rn(x, q));
  if (COS) nrm = __fadd_rn(nrm, __fmul_rn(x, x));
}

// four codes of a 32-bit word as exact f32 values
template <int CODE>
__device__ __forceinline__ void decode4(uint32_t w, float* x) {
  if constexpr (CODE == 1) {
    // int8: the biased byte under the exponent of 2^23 is 2^23 + code +
    // 128; one byte permute and one exact subtraction a code
    const uint32_t u = w ^ 0x80808080u;
    x[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)), 8388736.f);
    x[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)), 8388736.f);
    x[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)), 8388736.f);
    x[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)), 8388736.f);
  } else {
    // fp8-e4m3: two codes a conversion to f16x2 (exact), then to f32
    const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
    const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
    const float2 a = __half22float2(__half2(lo));
    const float2 b = __half22float2(__half2(hi));
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  }
}

// one code as an exact f32 value
template <int CODE>
__device__ __forceinline__ float decode1(uint8_t b) {
  if constexpr (CODE == 1) {
    return static_cast<float>(static_cast<int8_t>(b));
  } else {
    __nv_fp8_e4m3 x;
    x.__x = b;
    return static_cast<float>(x);
  }
}

// row `row` of the pool read straight from device memory, its columns
// added to the chains in order (the direct instantiation)
template <int CODE, bool COS>
__device__ __forceinline__ void score_row(const void* __restrict__ pool,
                                          size_t row, int n_cols, bool words,
                                          const float* __restrict__ query,
                                          float sc, float& s, float& nrm) {
  if constexpr (CODE == 0) {
    const float* x = static_cast<const float*>(pool) + row * n_cols;
    for (int c = 0; c < n_cols; ++c)
      score_step<COS>(__ldg(x + c), __ldg(query + c), s, nrm);
  } else {
    const uint8_t* x = static_cast<const uint8_t*>(pool) + row * n_cols;
    if (words) {
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
      for (int w = 0; w < n_cols / 4; ++w) {
        float v[4];
        decode4<CODE>(__ldg(xw + w), v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          score_step<COS>(__fmul_rn(v[e], sc), __ldg(query + 4 * w + e), s, nrm);
      }
    } else {
      for (int c = 0; c < n_cols; ++c)
        score_step<COS>(__fmul_rn(decode1<CODE>(__ldg(x + c)), sc),
                        __ldg(query + c), s, nrm);
    }
  }
}

// one 16-byte chunk of a row (physical chunk `phys` of the swizzled row,
// logical columns of `qs`), its columns added to the chains in order
template <int CODE, bool COS>
__device__ __forceinline__ void score_chunk(const uint8_t* row, int phys,
                                            const float* qs, float sc,
                                            float& s, float& nrm) {
  const uint4 w = *reinterpret_cast<const uint4*>(row + phys * 16);
  if constexpr (CODE == 0) {
    const float4 q = *reinterpret_cast<const float4*>(qs);
    score_step<COS>(__uint_as_float(w.x), q.x, s, nrm);
    score_step<COS>(__uint_as_float(w.y), q.y, s, nrm);
    score_step<COS>(__uint_as_float(w.z), q.z, s, nrm);
    score_step<COS>(__uint_as_float(w.w), q.w, s, nrm);
  } else {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 q = *reinterpret_cast<const float4*>(qs + 4 * e);
      float x[4];
      decode4<CODE>(words[e], x);
      score_step<COS>(__fmul_rn(x[0], sc), q.x, s, nrm);
      score_step<COS>(__fmul_rn(x[1], sc), q.y, s, nrm);
      score_step<COS>(__fmul_rn(x[2], sc), q.z, s, nrm);
      score_step<COS>(__fmul_rn(x[3], sc), q.w, s, nrm);
    }
  }
}

// CODE: 0 f32 pages, 1 int8 codes, 2 fp8-e4m3 codes (with row scales).
// TMA: rows staged through the ring of tensor-map boxes; else the direct
// instantiation (rows read from device memory by their row threads).
// Block: round_up(unit_rows, 32) row threads, then (TMA) one producer
// warp.  sc_bulk: a unit's scales come as one bulk copy with its first
// box (TMA only).
template <int CODE, bool COS, bool TMA>
__global__ void __launch_bounds__(kMaxUnitRows + 32)
topk_stream_kernel(const __grid_constant__ CUtensorMap pool,
                   const void* __restrict__ raw,
                   const float* __restrict__ scales,
                   const float* __restrict__ query,
                   const int* __restrict__ table, float* __restrict__ list_s,
                   int* __restrict__ list_i, unsigned int* __restrict__ done,
                   float* __restrict__ out, int n_valid, int page_rows,
                   int unit_rows, int group, int n_cols, long long n_rows,
                   int k, int kpad, int n_stages, int sc_bulk) {
  constexpr bool Q = CODE != 0;
  constexpr int kElem = CODE == 0 ? 4 : 1;
  constexpr int kW = kStageRowBytes / kElem;      // columns a stage
  __shared__ float srt_s[kSortCap];
  __shared__ int srt_i[kSortCap];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ int count, last;
  extern __shared__ __align__(16) uint8_t dyn[];
  // the ring of stages [rows8][128 B] from a 1024-byte boundary (the
  // swizzle's period), then each stage's query slice and page scales
  uint8_t* ring = dyn + ((1024u - (smem_u32(dyn) & 1023u)) & 1023u);
  const int rows8 = (unit_rows + 7) & ~7;
  const int rows4 = (unit_rows + 3) & ~3;
  const int stage_bytes = rows8 * kStageRowBytes;
  float* q_sl = reinterpret_cast<float*>(ring + (size_t)n_stages * stage_bytes);
  float* sc_sl = q_sl + n_stages * kW;

  const int t = threadIdx.x;
  const int n_rt = TMA ? blockDim.x - 32 : blockDim.x;
  const int n_tiles = (n_cols + kW - 1) / kW;
  // this block's units: unit u is rows [r0, r0 + unit_rows) of valid page
  // u / parts, r0 = (u % parts) * unit_rows; or (group > 1, pages of a
  // few rows, direct only) the `group` whole valid pages from u * group,
  // row thread t on row t % page_rows of the page t / page_rows
  const int parts = (page_rows + unit_rows - 1) / unit_rows;
  const long long n_units = group > 1 ? ((long long)n_valid + group - 1) / group
                                      : (long long)n_valid * parts;
  const int u0 = (int)(n_units * blockIdx.x / gridDim.x);
  const int u1 = (int)(n_units * (blockIdx.x + 1) / gridDim.x);

  if (t == 0) {
    if (TMA) {
      for (int i = 0; i < n_stages; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], n_rt / 32);
      }
    }
    count = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int i = t; i < kSortCap; i += blockDim.x) {
    srt_s[i] = kNegInf;
    srt_i[i] = kBigId;
  }
  __syncthreads();

  if (TMA && t >= n_rt) {
    // producer: one lane keeps the ring full, a stage being one box of
    // unit_rows x 128 bytes, the query's columns of the box, and on a
    // unit's first box (sc_bulk) the unit's row scales
    if (t == n_rt) {
      int step = 0;
      for (int u = u0; u < u1; ++u) {
        const int p = u / parts;
        const int r0 = (u - p * parts) * unit_rows;
        const int nr = page_rows - r0 < unit_rows ? page_rows - r0 : unit_rows;
        const int row0 = table[p] * page_rows + r0;
        for (int tile = 0; tile < n_tiles; ++tile, ++step) {
          const int slot = step % n_stages;
          if (step >= n_stages)
            mbar_wait(&empty[slot], ((step / n_stages) + 1) & 1);
          const int c0 = tile * kW;
          const int q_bytes = (n_cols - c0 < kW ? n_cols - c0 : kW) * 4;
          const bool with_sc = Q && sc_bulk && tile == 0;
          mbar_expect_tx(&full[slot], unit_rows * kStageRowBytes + q_bytes +
                                          (with_sc ? nr * 4 : 0));
          tma_load_2d(ring + (size_t)slot * stage_bytes, &pool, c0, row0,
                      &full[slot]);
          bulk_load(q_sl + slot * kW, query + c0, q_bytes, &full[slot]);
          if (with_sc)
            bulk_load(sc_sl + slot * rows4, scales + row0, nr * 4,
                      &full[slot]);
        }
      }
    }
    return;
  }

  // row threads: thread t carries row t's chains through the unit's
  // stages in column order; row t's 16-byte chunk j sits at j ^ (t & 7)
  const int lane = t & 31;
  const int sw = t & 7;
  float s = -0.f, nrm = -0.f, sc = 1.f;   // -0 + w == w: the chain's start
  // page ids (two units ahead) and row scales (one ahead) that the row
  // threads load themselves: every unit in the direct instantiation, the
  // scales where they are not bulk-copied
  const bool row_scales = Q && !(TMA && sc_bulk);
  const bool own_phys = !TMA || row_scales;
  const bool words = (n_cols & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(raw) & 3) == 0;
  const int t_page = t / page_rows, t_row = t - t_page * page_rows;
  // this thread's row of unit u: its valid page (the return value), row
  // within the page, and whether the row exists
  auto locate = [&](int u, int& row, bool& live) {
    if (group > 1) {
      const int pg = u * group + t_page;
      row = t_row;
      live = t < unit_rows && pg < n_valid;
      return live ? pg : u * group;
    }
    const int pg = u / parts;
    const int r0 = (u - pg * parts) * unit_rows;
    row = r0 + t;
    live = t < (page_rows - r0 < unit_rows ? page_rows - r0 : unit_rows);
    return pg;
  };
  auto row_scale = [&](int phys, int u) {
    int row;
    bool live;
    locate(u, row, live);
    return live ? __ldg(scales + (size_t)phys * page_rows + row) : 1.f;
  };
  auto page_id = [&](int u) {
    int row;
    bool live;
    return __ldg(table + locate(u, row, live));
  };
  int ph_cur = 0, ph_next = 0;
  float sc_cur = 1.f;
  if (own_phys && u0 < u1) {
    ph_cur = page_id(u0);
    if (u0 + 1 < u1) ph_next = page_id(u0 + 1);
    if (row_scales) sc_cur = row_scale(ph_cur, u0);
  }
  float thr_s = kNegInf;
  int thr_i = kBigId;
  int total = 0, base = 0;   // candidates appended, and at the last flush
  // sort candidates in once max(k, kFlushAt) have gathered: small sorts
  // that the ring's stages in flight cover (or when the next page's rows
  // might not fit)
  const int cap = kSortCap - k - n_rt;
  const int flush_at = k > kFlushAt ? k : kFlushAt;
  int step = 0;
  for (int u = u0; u < u1; ++u) {
    int row;
    bool live;
    const int p = locate(u, row, live);
    const int phys = ph_cur;
    if (own_phys) {
      // the next unit's scale (its page id came a unit ago), then the
      // page id of the one after
      if (row_scales) {
        sc = sc_cur;
        if (u + 1 < u1) sc_cur = row_scale(ph_next, u + 1);
      }
      ph_cur = ph_next;
      if (u + 2 < u1) ph_next = page_id(u + 2);
    }
    if constexpr (TMA) {
      for (int tile = 0; tile < n_tiles; ++tile, ++step) {
        const int slot = step % n_stages;
        mbar_wait(&full[slot], (step / n_stages) & 1);
        if (live) {
          if (Q && sc_bulk && tile == 0) sc = sc_sl[slot * rows4 + t];
          const uint8_t* row =
              ring + (size_t)slot * stage_bytes + t * kStageRowBytes;
          const float* qs = q_sl + slot * kW;
          const int c0 = tile * kW;
          const int n_chunks = (n_cols - c0 < kW ? n_cols - c0 : kW) * kElem / 16;
          if (n_chunks == kStageRowBytes / 16) {
#pragma unroll
            for (int j = 0; j < kStageRowBytes / 16; ++j)
              score_chunk<CODE, COS>(row, j ^ sw, qs + j * (16 / kElem), sc,
                                     s, nrm);
          } else {
            for (int j = 0; j < n_chunks; ++j)
              score_chunk<CODE, COS>(row, j ^ sw, qs + j * (16 / kElem), sc,
                                     s, nrm);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
    } else {
      if (live)
        score_row<CODE, COS>(raw, (size_t)phys * page_rows + row, n_cols,
                             words, query, sc, s, nrm);
    }
    // the unit is scored: rows that beat the running k-th best become
    // candidates; they are sorted in only when the buffer would overflow
    const long long pos = (long long)p * page_rows + row;
    const bool valid = live && pos < n_rows;
    const float score =
        COS ? __fdiv_rn(s, fmaxf(__fsqrt_rn(nrm), 1e-6f)) : s;
    s = -0.f;
    nrm = -0.f;
    const bool wins = valid && better(score, (int)pos, thr_s, thr_i);
    append(wins, score, (int)pos, srt_s, srt_i, &count, k, base);
    total += rows_count(wins, n_rt);
    if (total - base >= flush_at || total - base > cap) {
      flush(srt_s, srt_i, k, total - base, t, n_rt);
      thr_s = srt_s[k - 1];
      thr_i = srt_i[k - 1];
      base = total;
    }
  }
  if (total > base) flush(srt_s, srt_i, k, total - base, t, n_rt);
  base = total;
  for (int i = t; i < k; i += n_rt) {
    list_s[(size_t)blockIdx.x * k + i] = srt_s[i];
    list_i[(size_t)blockIdx.x * k + i] = srt_i[i];
  }
  __threadfence();
  rows_sync(n_rt);
  if (t == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  rows_sync(n_rt);
  if (!last) return;

  // the last block to finish merges the block lists.  Each is sorted, so
  // position r of every list is taken at once, r = 0, 1, ...: once no
  // entry at a position beats the k-th best of the last sort, no later
  // one can.  The candidates are sorted in once k have gathered (or the
  // next round might not fit).
  __threadfence();
  for (int i = t; i < k; i += n_rt) {
    srt_s[i] = kNegInf;
    srt_i[i] = kBigId;
  }
  thr_s = kNegInf;
  thr_i = kBigId;
  rows_sync(n_rt);
  const int nb = gridDim.x;
  const int per = (nb + n_rt - 1) / n_rt;   // <= kMergePer
  for (int r = 0; r < k; ++r) {
    // this position of every list this thread takes, loads in flight
    // together
    float cs[kMergePer];
    int ci[kMergePer];
#pragma unroll
    for (int j = 0; j < kMergePer; ++j) {
      const int b = j * n_rt + t;
      cs[j] = kNegInf;
      ci[j] = kBigId;
      if (j < per && b < nb) {
        cs[j] = __ldcg(list_s + (size_t)b * k + r);
        ci[j] = __ldcg(list_i + (size_t)b * k + r);
      }
    }
    int won = 0;
#pragma unroll
    for (int j = 0; j < kMergePer; ++j) {
      if (j == per) break;
      const bool wins =
          j * n_rt + t < nb && better(cs[j], ci[j], thr_s, thr_i);
      append(wins, cs[j], ci[j], srt_s, srt_i, &count, k, base);
      won += rows_count(wins, n_rt);
    }
    if (won == 0) break;
    total += won;
    if (total - base >= k || total - base + nb > kSortCap - k) {
      flush(srt_s, srt_i, k, total - base, t, n_rt);
      thr_s = srt_s[k - 1];
      thr_i = srt_i[k - 1];
      base = total;
    }
  }
  if (total > base) flush(srt_s, srt_i, k, total - base, t, n_rt);
  for (int i = t; i < 8 * kpad; i += n_rt) {
    const int r = i / kpad, c = i % kpad;
    float v = 0.f;
    if (c < k && r == 0) v = srt_s[c];
    if (c < k && r == 1) v = static_cast<float>(srt_i[c]);
    out[i] = v;
  }
  if (t == 0) *done = 0u;   // the next launch on this stream starts at 0
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

template <int CODE, bool TMA>
cudaError_t start_topk(const CUtensorMap& map, const void* pages,
                       const void* scales, const void* query,
                       const void* table, void* list_s, void* list_i,
                       void* done, void* out, int n_valid, int page_rows,
                       int unit_rows, int group, int n_cols, long long n_rows,
                       int k, int kpad, int cosine, int n_blocks, int n_stages,
                       int sc_bulk, size_t smem, cudaStream_t stream) {
  auto kernel = cosine ? topk_stream_kernel<CODE, true, TMA>
                       : topk_stream_kernel<CODE, false, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = (unit_rows + 31) / 32 * 32 + (TMA ? 32 : 0);
  kernel<<<n_blocks, threads, smem, stream>>>(
      map, pages, static_cast<const float*>(scales),
      static_cast<const float*>(query), static_cast<const int*>(table),
      static_cast<float*>(list_s), static_cast<int*>(list_i),
      static_cast<unsigned int*>(done), static_cast<float*>(out), n_valid,
      page_rows, unit_rows, group, n_cols, n_rows, k, kpad, n_stages, sc_bulk);
  return cudaGetLastError();
}

template <int CODE>
int launch_topk(const void* pages, const void* scales, const void* query,
                const void* table, void* list_s, void* list_i, void* done,
                void* out, int n_phys, int n_valid, int page_rows, int n_cols,
                long long n_rows, int k, int kpad, int cosine, int n_blocks,
                void* stream) {
  constexpr bool Q = CODE != 0;
  constexpr int kElem = CODE == 0 ? 4 : 1;
  // the ring takes rows of a multiple of 16 bytes from a 16-byte-aligned
  // pool, with a 16-byte-aligned query, and (codes) pages of a multiple
  // of 4 rows, whose scales are one bulk copy; else the direct
  // instantiation, where pages of at most kGroupMax rows go kMaxUnitRows
  // rows' worth of whole pages a unit (the same rule as
  // kernels/ref.topk_unit_pages)
  const bool tma = (n_cols * kElem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(query) % 16 == 0 &&
                   !(Q && page_rows % 4);
  const int group = !tma && page_rows <= kGroupMax ? kMaxUnitRows / page_rows : 1;
  const int unit_rows = group > 1 ? group * page_rows
                        : page_rows < kMaxUnitRows ? page_rows : kMaxUnitRows;
  const long long n_units =
      group > 1 ? ((long long)n_valid + group - 1) / group
                : (long long)n_valid * ((page_rows + unit_rows - 1) / unit_rows);
  if (n_valid < 1 || n_phys < 1 || page_rows < 1 || n_cols < 1 ||
      reinterpret_cast<uintptr_t>(pages) % kElem ||
      reinterpret_cast<uintptr_t>(query) % 4 || k < 1 || k > kMaxTopk ||
      kpad < k || n_blocks < 1 || n_blocks > n_units ||
      n_blocks > kMaxTopkBlocks || done == nullptr ||
      (long long)n_phys * page_rows > 0x7fffffffLL ||
      (Q && (scales == nullptr || reinterpret_cast<uintptr_t>(scales) % 4)))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap map = {};
  if (!tma)
    return (int)start_topk<CODE, false>(
        map, pages, scales, query, table, list_s, list_i, done, out, n_valid,
        page_rows, unit_rows, group, n_cols, n_rows, k, kpad, cosine,
        n_blocks, 0, 0, 0, st);
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the pool as a 2-D tensor [n_phys * page_rows, n_cols]; a box is one
  // unit's rows x 128 bytes of columns (zero past the last column, or the
  // last row of the pool)
  const cuuint64_t dims[2] = {(cuuint64_t)n_cols,
                              (cuuint64_t)n_phys * (cuuint64_t)page_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_cols * kElem};
  const cuuint32_t box[2] = {(cuuint32_t)(kStageRowBytes / kElem),
                             (cuuint32_t)unit_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      &map, CODE == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(pages), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  // a unit's scales in one bulk copy where they are 16-byte aligned
  const int sc_bulk = Q && reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  const int rows8 = (unit_rows + 7) & ~7, rows4 = (unit_rows + 3) & ~3;
  const int stage_bytes = rows8 * kStageRowBytes;
  int n_stages = kRingBytes / stage_bytes;
  n_stages = n_stages < 2 ? 2 : n_stages > kMaxStages ? kMaxStages : n_stages;
  const size_t smem = 1024 + (size_t)n_stages * (stage_bytes +
                                                 kStageRowBytes / kElem * 4 +
                                                 rows4 * 4);
  return (int)start_topk<CODE, true>(
      map, pages, scales, query, table, list_s, list_i, done, out, n_valid,
      page_rows, unit_rows, 1, n_cols, n_rows, k, kpad, cosine, n_blocks,
      n_stages, sc_bulk, smem, st);
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

#define TOPK(NAME, CODE)                                                    \
  int NAME(const void* pages, const void* scales, const void* query,       \
           const void* table, void* list_s, void* list_i, void* done,      \
           void* out, int n_phys, int n_valid, int page_rows, int n_cols,  \
           long long n_rows, int k, int kpad, int cosine, int n_blocks,    \
           void* stream) {                                                  \
    return launch_topk<CODE>(pages, scales, query, table, list_s, list_i,   \
                             done, out, n_phys, n_valid, page_rows, n_cols, \
                             n_rows, k, kpad, cosine, n_blocks, stream);    \
  }
TOPK(topk_scan_f32, 0)
TOPK(topk_scan_int8, 1)
TOPK(topk_scan_fp8, 2)
#undef TOPK

}  // extern "C"
