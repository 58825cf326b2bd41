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
// scan_filter_reduce, one launch (the redesign for Hopper).  Two limits:
//   * the valid pages' bytes (SF-1 lineitem, 46,885 pages of 128 x 16:
//     384 MB f32, 0.115 ms at 3.35 TB/s; 120 MB of codes and scales,
//     0.036 ms);
//   * the contract's fold: each page's [count, sums] added in page order
//     in f32, n_valid dependent adds a value whatever the design (4
//     cycles each: ~0.1 ms at SF-1), which no split may reassociate.
//   So the stream runs beside the fold, and the call costs about the
//   larger of the two, not their sum:
//   * n_prod producer blocks (two blocks an SM) take chunks of whole
//     pages interleaved (chunk c to block c mod n_prod), so the prefix
//     of finished chunks grows evenly.  A page of a multiple of 16 bytes
//     (aligned; code pages of a multiple of 4 rows, their scales on the
//     same mbarrier) is one cp.async.bulk into a ring of up to 8 stages
//     of a few whole pages (17 KB: two f32 lineitem pages), its stride
//     padded so the pages a warp reads sit on other banks.  The consumer
//     warps first turn a stage's filter column into one bit a row (a
//     ballot a 32-row word), so the count is a popcount and thread
//     (page, column) adds its column's passing rows in order, loads a
//     batch ahead, with no filter work; where a stage has at most 128
//     such tasks, two groups of four warps walk two stages at once (the
//     walk is bound by instruction issue, and one stage's tasks fill
//     only a warp or two).  Other pools take the direct instantiation
//     (threads read their rows through L1; one rule, ref.scan_tma_path).
//     Each page's count and sums go to a workspace [n_cols + 1][pages]
//     that stays in L2, min/max (order-free) into the block's.  After a
//     chunk, a fence and a release store of the call's epoch into the
//     chunk's flag (the wrapper counts calls on a stream, so no launch
//     resets the flags).
//   * n_fold fold blocks, one lane a value (8 values a block at 16
//     columns: each block reads only its values' rows, so no single SM
//     pulls the whole workspace).  A loader warp acquires the flags of
//     the next slots' chunks (a lane each) and bulk-copies each value's
//     row of a slot into a ring; the adder warp adds them in page order
//     with __fadd_rn, 16 pages loaded (float4) ahead of the 16 it adds.
//     Block 0's other warps fold the producers' min/max as their blocks
//     finish.  The count is in the ordered chain, so it equals the
//     page-order f32 fold above 2^24 rows too.
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

// ---------------------------------------------------------------- scan
//
// One launch of n_fold + n_prod blocks (ref.scan_plan sizes everything;
// the emulation is ref.scan_blocks_emulated).  Blocks [0, n_fold) fold,
// the others produce.  ws: the fold values [n_cols + 1][pad_pages]
// (value 0 a page's count, value 1 + c its column-c sum), then the
// producers' min/max [n_prod][2][n_cols]; flags: [n_chunks] chunk ready,
// then [n_prod] block done, each set to this call's epoch (so no launch
// resets them).

constexpr int kScanThreads = 256;   // consumer threads (ref.SCAN_THREADS)
constexpr int kScanMaxStages = 8;
constexpr int kScanMaxSlots = 8;
constexpr int kScanMaxValues = 32;  // values a fold block (a lane each)
constexpr int kScanUnroll = 8;      // rows whose loads go out together
constexpr int kMinMaxBar = 2;       // named barrier of the min/max warps
constexpr int kGroupBar = 3;        // named barriers of the consumer groups

struct ScanArgs {
  const void* pages;
  const float* scales;
  const int* table;
  float* ws;
  int* flags;
  float* out;
  long long n_rows;
  float thr;
  int n_valid, page_rows, n_cols, filter_col, op;
  int chunk_pages, unit_pages, n_stages, page_stride, stage_bytes;
  int mask_words, vw, n_fold, passes, slot_pages, slot_stride, n_slots;
  int n_chunks, n_prod, pad_pages, epoch;
  int follow_only;   // the fold blocks alone over a filled ws: the chain
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Waits of the scan on other blocks and on copies are bounded: a wait
// that outlasts 10 s of the card's clock (a fault, never a slow block)
// traps, so the launch fails instead of holding the card.
constexpr int kSpinsBeforeClock = 1024;
constexpr unsigned long long kWaitLimitNs = 10000000000ULL;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// after kSpinsBeforeClock tries, sleep between tries and trap past the
// limit
__device__ __forceinline__ void wait_tick(int i, unsigned long long& t0) {
  if (i < kSpinsBeforeClock) return;
  __nanosleep(100);
  if (t0 == 0)
    t0 = global_ns();
  else if (global_ns() - t0 > kWaitLimitNs)
    __trap();
}

__device__ __forceinline__ void wait_epoch(const int* flag, int epoch) {
  unsigned long long t0 = 0;
  for (int i = 0; ld_acquire(flag) != epoch; ++i) wait_tick(i, t0);
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  unsigned long long t0 = 0;
  for (int i = 0; !mbar_try(bar, parity); ++i) wait_tick(i, t0);
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// element i of a page (shared memory, or device memory through L1) as f32
template <int CODE, bool GLOBAL>
__device__ __forceinline__ float page_elem(const void* base, size_t i) {
  if constexpr (CODE == 0) {
    const float* p = static_cast<const float*>(base) + i;
    return GLOBAL ? __ldg(p) : *p;
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(base) + i;
    return decode1<CODE>(GLOBAL ? __ldg(p) : *p);
  }
}

// the filter without branches (FILTER_OPS order: all, ge, lt, eq, ne)
__device__ __forceinline__ bool passes_filter(float key, float thr, int op) {
  const bool ge = key >= thr, lt = key < thr, eq = key == thr;
  return (op == 0) | ((op == 1) & ge) | ((op == 2) & lt) | ((op == 3) & eq) |
         ((op == 4) & !eq);
}

// Column c of one page read from device memory (the direct
// instantiation), its rows in order 0..page_rows-1 from 0: the passing
// rows' count and sum, min and max (rows at or past n_rows never pass).
// Rows go in batches of kScanUnroll, the next batch's loads in flight
// while this one is added (a batch past the page adds nothing).
template <int CODE>
__device__ __forceinline__ void page_column_direct(
    const void* pg, const float* sc, const ScanArgs& a, int c,
    long long row0, float& cnt, float& sum, float& mn, float& mx) {
  constexpr bool Q = CODE != 0;
  constexpr int U = kScanUnroll;
  const int n = a.page_rows, C = a.n_cols;
  const long long left = a.n_rows - row0;
  const int live = left < 0 ? 0 : left < n ? (int)left : n;
  cnt = 0.f;
  sum = 0.f;
  mn = kPosInf;
  mx = kNegInf;
  float va[U], ka[U], sa[U], vb[U], kb[U], sb[U];
  auto load = [&](float (&v)[U], float (&k)[U], float (&s)[U], int r0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = min(r0 + u, n - 1);
      v[u] = page_elem<CODE, true>(pg, (size_t)r * C + c);
      k[u] = page_elem<CODE, true>(pg, (size_t)r * C + a.filter_col);
      s[u] = Q ? __ldg(sc + r) : 1.f;
    }
  };
  auto fold = [&](const float (&v)[U], const float (&k)[U],
                  const float (&s)[U], int r0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float x = Q ? __fmul_rn(v[u], s[u]) : v[u];
      const float key = Q ? __fmul_rn(k[u], s[u]) : k[u];
      // a row that does not pass adds +0 and changes no bound: skipped
      // (the sums start from +0 and never become -0)
      if (r0 + u < live && passes_filter(key, a.thr, a.op)) {
        cnt = __fadd_rn(cnt, 1.f);
        sum = __fadd_rn(sum, x);
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
    }
  };
  load(va, ka, sa, 0);
  for (int r0 = 0; r0 < n; r0 += 2 * U) {
    load(vb, kb, sb, r0 + U);
    fold(va, ka, sa, r0);
    load(va, ka, sa, r0 + 2 * U);
    fold(vb, kb, sb, r0 + U);
  }
}

// Column c of one staged page whose row-filter bits are in mw (the TMA
// instantiation): the passing rows' sum in row order from 0, min, max;
// batched as page_column_direct.
template <int CODE>
__device__ __forceinline__ void page_column_staged(
    const void* pg, const float* sc, const uint32_t* mw, const ScanArgs& a,
    int c, float& sum, float& mn, float& mx) {
  constexpr bool Q = CODE != 0;
  constexpr int U = kScanUnroll;   // divides 32
  const int n = a.page_rows, C = a.n_cols;
  sum = 0.f;
  mn = kPosInf;
  mx = kNegInf;
  float va[U], sa[U], vb[U], sb[U];
  auto load = [&](float (&v)[U], float (&s)[U], int r0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = min(r0 + u, n - 1);
      v[u] = page_elem<CODE, false>(pg, (size_t)r * C + c);
      s[u] = Q ? sc[r] : 1.f;
    }
  };
  auto fold = [&](const float (&v)[U], const float (&s)[U], int r0) {
    const uint32_t bits = r0 < n ? mw[r0 >> 5] >> (r0 & 31) : 0u;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float x = Q ? __fmul_rn(v[u], s[u]) : v[u];
      if ((bits >> u) & 1u) {
        sum = __fadd_rn(sum, x);
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
    }
  };
  load(va, sa, 0);
  for (int r0 = 0; r0 < n; r0 += 2 * U) {
    load(vb, sb, r0 + U);
    fold(va, sa, r0);
    load(va, sa, r0 + 2 * U);
    fold(vb, sb, r0 + U);
  }
}

// Producer block b: chunks b, b + n_prod, ...  The consumer threads form
// G groups (two where a unit has at most 128 (page, column) tasks, so
// two units are walked at once; group 1 starts on warps 6 and 7, so the
// two groups' busy warps sit on other SMSPs), group g taking units g, g
// + G, ... of the block.  In a group, thread (slot s, column c) takes
// pages s, s + S, ... of a unit (S = group threads / C; past that many
// columns S = 1 and a thread takes columns c, c + its group's threads,
// ...), writes their fold values and keeps its min/max in shared memory
// (mm, [2][M]).  After a chunk, every thread fences its writes and
// thread 0 publishes the chunk's flag; after the last, the block's
// min/max and its flag.
template <int CODE, bool TMA>
__device__ void scan_produce(const ScanArgs& a, uint8_t* ring, float* mm,
                             int M, uint64_t* full, uint64_t* empty) {
  constexpr bool Q = CODE != 0;
  constexpr int kElem = CODE == 0 ? 4 : 1;
  const int t = threadIdx.x, lane = t & 31;
  const int b = blockIdx.x - a.n_fold;
  const int C = a.n_cols;
  const int G = TMA && a.unit_pages * C <= kScanThreads / 2 ? 2 : 1;
  const int T = kScanThreads / G;                // threads a group
  const int g = (t >> 5) / (8 / G);
  const int wg = (t >> 5) - g * (8 / G);         // warp in the group
  const int tg = (g ? (wg + 2) % 4 : wg) * 32 + lane;
  const int S = C <= T ? T / C : 1;
  const int s = tg / C, c0 = tg % C;
  const int cstep = C < T ? C : T;
  const size_t page_elems = (size_t)a.page_rows * C;
  const int wpp = (a.page_rows + 31) / 32;   // filter words a page
  uint32_t* masks =
      reinterpret_cast<uint32_t*>(ring + (size_t)a.n_stages * a.stage_bytes);
  if (t == 0) {
    for (int i = 0; i < a.n_stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kScanThreads / 32 / G);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int i = t; i < M; i += blockDim.x) {
    mm[i] = kPosInf;
    mm[M + i] = kNegInf;
  }
  __syncthreads();

  if (TMA && t >= kScanThreads) {
    // producer warp: a stage is the unit's whole pages (at page_stride)
    // and their row scales after them; lane i bulk-copies page i.  The
    // unit's page ids are loaded before the wait for its slot, so their
    // latency hides behind it.
    const int pl = t - kScanThreads;
    const uint32_t page_bytes = (uint32_t)(page_elems * kElem);
    const uint32_t sc_bytes = Q ? a.page_rows * 4 : 0;
    int step = 0;
    for (int c = b; c < a.n_chunks; c += a.n_prod) {
      const int p1 = min((c + 1) * a.chunk_pages, a.n_valid);
      for (int u0 = c * a.chunk_pages; u0 < p1; u0 += a.unit_pages, ++step) {
        const int nu = min(a.unit_pages, p1 - u0);
        const int slot = step % a.n_stages;
        const size_t phys = pl < nu ? (size_t)__ldg(a.table + u0 + pl) : 0;
        if (step >= a.n_stages)
          mbar_wait_bounded(&empty[slot], ((step / a.n_stages) + 1) & 1);
        uint8_t* st = ring + (size_t)slot * a.stage_bytes;
        if (pl == 0) mbar_expect_tx(&full[slot], nu * (page_bytes + sc_bytes));
        __syncwarp();
        if (pl < nu) {
          bulk_load(st + (size_t)pl * a.page_stride,
                    static_cast<const uint8_t*>(a.pages) +
                        phys * page_elems * kElem,
                    page_bytes, &full[slot]);
          if (Q)
            bulk_load(reinterpret_cast<float*>(
                          st + (size_t)a.unit_pages * a.page_stride) +
                          (size_t)pl * a.page_rows,
                      a.scales + phys * a.page_rows, sc_bytes, &full[slot]);
        }
      }
    }
    return;
  }

  int step = 0;
  for (int c = b; c < a.n_chunks; c += a.n_prod) {
    const int p1 = min((c + 1) * a.chunk_pages, a.n_valid);
    for (int u0 = c * a.chunk_pages; u0 < p1; u0 += a.unit_pages) {
      const int nu = min(a.unit_pages, p1 - u0);
      if constexpr (TMA) {
        if (step++ % G != g) continue;
        const int slot = (step - 1) % a.n_stages;
        mbar_wait_bounded(&full[slot], ((step - 1) / a.n_stages) & 1);
        const uint8_t* st = ring + (size_t)slot * a.stage_bytes;
        const float* scs = reinterpret_cast<const float*>(
            st + (size_t)a.unit_pages * a.page_stride);
        uint32_t* mask = masks + (size_t)slot * a.unit_pages * wpp;
        // the unit's row-filter bits: 32-row words, a warp's lanes on a
        // word's rows, four words' loads in flight (rows at or past
        // n_rows, or past the page, are 0)
        constexpr int kWords = 4;
        const int words = nu * wpp;
        const int wstep = T / 32;                    // the group's warps
        for (int w0 = wg; w0 < words; w0 += kWords * wstep) {
          float key[kWords];
          bool ok[kWords];
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            const int w = min(w0 + j * wstep, words - 1);
            const int i = w / wpp;
            const int r = (w - i * wpp) * 32 + lane;
            ok[j] = w0 + j * wstep < words && r < a.page_rows &&
                    (long long)(u0 + i) * a.page_rows + r < a.n_rows;
            const int rc = min(r, a.page_rows - 1);
            key[j] = page_elem<CODE, false>(st + (size_t)i * a.page_stride,
                                            (size_t)rc * C + a.filter_col);
            if (Q) key[j] = __fmul_rn(key[j], scs[(size_t)i * a.page_rows + rc]);
          }
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            const uint32_t bits = __ballot_sync(
                0xffffffffu, ok[j] && passes_filter(key[j], a.thr, a.op));
            if (lane == 0 && w0 + j * wstep < words) mask[w0 + j * wstep] = bits;
          }
        }
        named_sync(kGroupBar + g, T);
        for (int i = s; s < S && i < nu; i += S) {
          const int p = u0 + i;
          const uint32_t* mw = mask + (size_t)i * wpp;
          for (int cc = c0; cc < C; cc += cstep) {
            float sum, mn, mx;
            page_column_staged<CODE>(st + (size_t)i * a.page_stride,
                                     Q ? scs + (size_t)i * a.page_rows
                                       : nullptr,
                                     mw, a, cc, sum, mn, mx);
            a.ws[(size_t)(cc + 1) * a.pad_pages + p] = sum;
            if (cc == 0) {
              int cnt = 0;
              for (int w = 0; w < wpp; ++w) cnt += __popc(mw[w]);
              a.ws[p] = (float)cnt;
            }
            const int idx = (g * S + s) * C + cc;
            mm[idx] = fminf(mm[idx], mn);
            mm[M + idx] = fmaxf(mm[M + idx], mx);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      } else {
        for (int i = s; s < S && i < nu; i += S) {
          const int p = u0 + i;
          const size_t phys = (size_t)__ldg(a.table + p);
          const void* pg = static_cast<const uint8_t*>(a.pages) +
                           phys * page_elems * kElem;
          const float* sc = Q ? a.scales + phys * a.page_rows : nullptr;
          for (int cc = c0; cc < C; cc += cstep) {
            float cnt, sum, mn, mx;
            page_column_direct<CODE>(pg, sc, a, cc,
                                     (long long)p * a.page_rows, cnt, sum,
                                     mn, mx);
            a.ws[(size_t)(cc + 1) * a.pad_pages + p] = sum;
            if (cc == 0) a.ws[p] = cnt;
            const int idx = s * C + cc;
            mm[idx] = fminf(mm[idx], mn);
            mm[M + idx] = fmaxf(mm[M + idx], mx);
          }
        }
      }
    }
    // the chunk's fold values are written: publish them
    __threadfence();
    named_sync(kRowsBar, kScanThreads);
    if (t == 0) st_release(a.flags + c, a.epoch);
  }
  named_sync(kRowsBar, kScanThreads);
  float* blk = a.ws + (size_t)(C + 1) * a.pad_pages + (size_t)b * 2 * C;
  for (int cc = t; cc < C; cc += kScanThreads) {
    float mn = kPosInf, mx = kNegInf;
    for (int s2 = 0; s2 < G * S; ++s2) {
      mn = fminf(mn, mm[s2 * C + cc]);
      mx = fmaxf(mx, mm[M + s2 * C + cc]);
    }
    blk[cc] = mn;
    blk[C + cc] = mx;
  }
  __threadfence();
  named_sync(kRowsBar, kScanThreads);
  if (t == 0) st_release(a.flags + a.n_chunks + b, a.epoch);
}

// One fold value's row of n pages (a ring slot) added to acc in page
// order: 16 pages (four 16-byte loads) in registers while the 16 before
// them are added; loads past the row's end are clamped, not added.
__device__ __forceinline__ float fold_row(const float* row, int n,
                                          float acc) {
  const int last = (n - 1) & ~3;
  auto load = [&](float4 (&x)[4], int j) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = *reinterpret_cast<const float4*>(row + min(j + 4 * u, last));
  };
  auto add = [&](const float4 (&x)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = __fadd_rn(acc, x[u].x);
      acc = __fadd_rn(acc, x[u].y);
      acc = __fadd_rn(acc, x[u].z);
      acc = __fadd_rn(acc, x[u].w);
    }
  };
  const int nb = n >> 4;   // whole batches of 16
  float4 xa[4], xb[4];
  load(xa, 0);
  int i = 0;
  for (; i + 2 <= nb; i += 2) {
    load(xb, (i + 1) * 16);
    add(xa);
    load(xa, (i + 2) * 16);
    add(xb);
  }
  if (i < nb) {
    load(xb, (i + 1) * 16);
    add(xa);
    xa[0] = xb[0];
    xa[1] = xb[1];
    xa[2] = xb[2];
    xa[3] = xb[3];
  }
  const int rem = n & 15;   // the last pages, in xa
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (4 * u < rem) acc = __fadd_rn(acc, xa[u].x);
    if (4 * u + 1 < rem) acc = __fadd_rn(acc, xa[u].y);
    if (4 * u + 2 < rem) acc = __fadd_rn(acc, xa[u].z);
    if (4 * u + 3 < rem) acc = __fadd_rn(acc, xa[u].w);
  }
  return acc;
}

// Fold block f.  Warp 0: lane v adds value (q * n_fold + f) * vw + v of
// pass q, slot by slot, in page order.  Warp 1: its lanes wait for the
// chunks of the next slots (acquire loads, a lane a chunk), then lane v
// bulk-copies value v's row of each slot into the ring.  In block 0 the
// other warps fold the producers' min/max as their blocks finish, and
// block 0 writes the count (value 0), min, max and zero rows.
__device__ void scan_follow(const ScanArgs& a, uint8_t* ring, float* mm,
                            int M, uint64_t* full, uint64_t* empty,
                            float* count) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int f = blockIdx.x;
  const int C = a.n_cols, n_vals = C + 1;
  const int n_slots_total = (a.n_valid + a.slot_pages - 1) / a.slot_pages;
  const int per_slot = a.slot_pages / a.chunk_pages;   // chunks a slot
  const int slot_floats = a.vw * a.slot_stride;
  float* sring = reinterpret_cast<float*>(ring);
  if (t == 0) {
    for (int i = 0; i < a.n_slots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    *count = 0.f;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    const int vr = lane < a.vw ? lane : 0;
    int step = 0;
    for (int q = 0; q < a.passes; ++q) {
      const int g = (q * a.n_fold + f) * a.vw + lane;
      if ((q * a.n_fold + f) * a.vw >= n_vals) break;
      float acc = 0.f;
      for (int k = 0; k < n_slots_total; ++k, ++step) {
        const int slot = step % a.n_slots;
        mbar_wait_bounded(&full[slot], (step / a.n_slots) & 1);
        acc = fold_row(sring + (size_t)slot * slot_floats +
                           (size_t)vr * a.slot_stride,
                       min(a.slot_pages, a.n_valid - k * a.slot_pages), acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
      if (lane < a.vw && g == 0) *count = acc;
      if (lane < a.vw && g >= 1 && g < n_vals) a.out[C + g - 1] = acc;
    }
  } else if (warp == 1) {
    // flags of up to 32 chunks (whole slots) polled at once, a lane each
    const int group = per_slot <= 32 ? 32 / per_slot : 1;
    int step = 0;
    for (int q = 0; q < a.passes; ++q) {
      const int g0 = (q * a.n_fold + f) * a.vw;
      if (g0 >= n_vals) break;
      const int rows = min(a.vw, n_vals - g0);
      for (int k0 = 0; k0 < n_slots_total; k0 += group) {
        const int k1 = min(k0 + group, n_slots_total);
        if (q == 0 && !a.follow_only) {
          const int c_end = min(k1 * per_slot, a.n_chunks);
          for (int c = k0 * per_slot + lane; c < c_end; c += 32)
            wait_epoch(a.flags + c, a.epoch);
          __syncwarp();
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
        }
        for (int k = k0; k < k1; ++k, ++step) {
          const int slot = step % a.n_slots;
          if (step >= a.n_slots)
            mbar_wait_bounded(&empty[slot], ((step / a.n_slots) + 1) & 1);
          const int p0 = k * a.slot_pages;
          const uint32_t bytes =
              (uint32_t)((min(a.slot_pages, a.n_valid - p0) + 3) & ~3) * 4;
          if (lane == 0) mbar_expect_tx(&full[slot], rows * bytes);
          __syncwarp();
          if (lane < rows)
            bulk_load(sring + (size_t)slot * slot_floats +
                          (size_t)lane * a.slot_stride,
                      a.ws + (size_t)(g0 + lane) * a.pad_pages + p0, bytes,
                      &full[slot]);
        }
      }
    }
  } else if (f == 0) {
    // the producers' min/max: wait for each block's flag (a thread a
    // block), then thread (g, c) folds column c over blocks g, g + G, ...
    const int T = blockDim.x - 64;
    const int j = t - 64;
    if (!a.follow_only)
      for (int bb = j; bb < a.n_prod; bb += T)
        wait_epoch(a.flags + a.n_chunks + bb, a.epoch);
    named_sync(kMinMaxBar, T);
    const float* blk = a.ws + (size_t)n_vals * a.pad_pages;
    const int G = C <= T ? T / C : 1;
    const int g = j / C;
    const int cstep = C < T ? C : T;
    if (g < G) {
      for (int cc = j % C; cc < C; cc += cstep) {
        float mn = kPosInf, mx = kNegInf;
        int bb = g;
        for (; bb + 3 * G < a.n_prod; bb += 4 * G) {
          float x[8];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            x[2 * u] = __ldcg(blk + (size_t)(bb + u * G) * 2 * C + cc);
            x[2 * u + 1] = __ldcg(blk + (size_t)(bb + u * G) * 2 * C + C + cc);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            mn = fminf(mn, x[2 * u]);
            mx = fmaxf(mx, x[2 * u + 1]);
          }
        }
        for (; bb < a.n_prod; bb += G) {
          mn = fminf(mn, __ldcg(blk + (size_t)bb * 2 * C + cc));
          mx = fmaxf(mx, __ldcg(blk + (size_t)bb * 2 * C + C + cc));
        }
        mm[g * C + cc] = mn;
        mm[M + g * C + cc] = mx;
      }
    }
    named_sync(kMinMaxBar, T);
    for (int cc = j; cc < C; cc += T)
      for (int g2 = 1; g2 < G; ++g2) {
        mm[cc] = fminf(mm[cc], mm[g2 * C + cc]);
        mm[M + cc] = fmaxf(mm[M + cc], mm[M + g2 * C + cc]);
      }
  }
  __syncthreads();
  if (f != 0) return;
  for (int cc = t; cc < C; cc += blockDim.x) {
    a.out[cc] = *count;
    a.out[2 * C + cc] = mm[cc];
    a.out[3 * C + cc] = mm[M + cc];
    for (int r = 4; r < 8; ++r) a.out[r * C + cc] = 0.f;
  }
}

template <int CODE, bool TMA>
__global__ void __launch_bounds__(kScanThreads + 32, 2)
scan_kernel(const __grid_constant__ ScanArgs a) {
  __shared__ __align__(8) uint64_t full[kScanMaxSlots];
  __shared__ __align__(8) uint64_t empty[kScanMaxSlots];
  __shared__ float count;
  extern __shared__ __align__(16) uint8_t dyn[];
  uint8_t* ring = dyn + ((128u - (smem_u32(dyn) & 127u)) & 127u);
  const size_t stages = (size_t)a.n_stages * a.stage_bytes + 4 * a.mask_words;
  const size_t slots = (size_t)a.n_slots * a.vw * a.slot_stride * 4;
  float* mm = reinterpret_cast<float*>(ring + (stages > slots ? stages : slots));
  const int M = a.n_cols > kScanThreads ? a.n_cols : kScanThreads;
  if (blockIdx.x < a.n_fold)
    scan_follow(a, ring, mm, M, full, empty, &count);
  else
    scan_produce<CODE, TMA>(a, ring, mm, M, full, empty);
}

template <int CODE>
int launch_scan(const void* pages, const void* scales, const void* table,
                void* ws, void* flags, void* out, long long n_rows,
                float thr, int n_valid, int page_rows, int n_cols,
                int filter_col, int op, int tma, int chunk_pages,
                int unit_pages, int n_stages, int page_stride,
                int stage_bytes, int mask_words, int vw, int n_fold,
                int passes, int slot_pages, int slot_stride, int n_slots,
                int n_chunks, int n_prod, int pad_pages, int epoch,
                int follow_only, int smem, void* stream) {
  constexpr bool Q = CODE != 0;
  constexpr int kElem = CODE == 0 ? 4 : 1;
  const long long page_bytes = (long long)page_rows * n_cols * kElem;
  const long long sc_bytes = Q ? page_rows * 4LL : 0;
  const long long stages =
      tma ? (long long)n_stages * stage_bytes + 4LL * mask_words : 0;
  const long long slots = (long long)n_slots * vw * slot_stride * 4;
  const long long need = 128 + (stages > slots ? stages : slots) +
                         8LL * (n_cols > kScanThreads ? n_cols : kScanThreads) +
                         16;
  const bool bad_tma =
      tma && (n_stages < 2 || n_stages > kScanMaxStages || unit_pages < 1 ||
              unit_pages > 32 || chunk_pages % unit_pages || page_bytes % 16 ||
              page_stride < page_bytes || page_stride % 16 ||
              (Q && page_rows % 4) ||
              stage_bytes != unit_pages * (page_stride + sc_bytes) ||
              mask_words < n_stages * unit_pages * ((page_rows + 31) / 32) ||
              reinterpret_cast<uintptr_t>(pages) % 16 ||
              (Q && reinterpret_cast<uintptr_t>(scales) % 16));
  if (n_valid < 1 || page_rows < 1 || n_cols < 1 || filter_col < 0 ||
      filter_col >= n_cols || op < 0 || op > 4 || (Q && scales == nullptr) ||
      reinterpret_cast<uintptr_t>(pages) % kElem ||
      (Q && reinterpret_cast<uintptr_t>(scales) % 4) || bad_tma ||
      vw < 4 || vw % 4 || vw > kScanMaxValues || n_fold < 1 ||
      (long long)passes * n_fold * vw < n_cols + 1 || chunk_pages < 1 ||
      chunk_pages % 4 || slot_pages % chunk_pages || slot_stride % 4 ||
      slot_stride < slot_pages + 4 || n_slots < 2 || n_slots > kScanMaxSlots ||
      n_chunks != (n_valid + chunk_pages - 1) / chunk_pages ||
      pad_pages < n_valid || pad_pages % 4 ||
      (!follow_only && (n_prod < 1 || n_prod > n_chunks)) || epoch < 1 ||
      reinterpret_cast<uintptr_t>(ws) % 16 || smem < need)
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.pages = pages;
  a.scales = static_cast<const float*>(scales);
  a.table = static_cast<const int*>(table);
  a.ws = static_cast<float*>(ws);
  a.flags = static_cast<int*>(flags);
  a.out = static_cast<float*>(out);
  a.n_rows = n_rows;
  a.thr = thr;
  a.n_valid = n_valid;
  a.page_rows = page_rows;
  a.n_cols = n_cols;
  a.filter_col = filter_col;
  a.op = op;
  a.chunk_pages = chunk_pages;
  a.unit_pages = tma ? unit_pages : chunk_pages;
  a.n_stages = tma ? n_stages : 0;
  a.page_stride = page_stride;
  a.stage_bytes = tma ? stage_bytes : 0;
  a.mask_words = tma ? mask_words : 0;
  a.vw = vw;
  a.n_fold = n_fold;
  a.passes = passes;
  a.slot_pages = slot_pages;
  a.slot_stride = slot_stride;
  a.n_slots = n_slots;
  a.n_chunks = n_chunks;
  a.n_prod = follow_only ? 0 : n_prod;
  a.pad_pages = pad_pages;
  a.epoch = epoch;
  a.follow_only = follow_only;
  auto kernel = tma ? scan_kernel<CODE, true> : scan_kernel<CODE, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<follow_only ? n_fold : n_fold + n_prod,
           kScanThreads + (tma ? 32 : 0), smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <int CODE, bool TMA>
int scan_occupancy(int smem) {
  auto kernel = scan_kernel<CODE, TMA>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kScanThreads + (TMA ? 32 : 0), smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Blocks of the scan kernel (page format code 0 f32, 1 int8, 2 fp8; the
// TMA or the direct instantiation) an SM holds at `smem` bytes of
// dynamic shared memory, or -1.
int scan_blocks_per_sm(int code, int tma, int smem) {
  if (code == 0) return tma ? scan_occupancy<0, true>(smem) : scan_occupancy<0, false>(smem);
  if (code == 1) return tma ? scan_occupancy<1, true>(smem) : scan_occupancy<1, false>(smem);
  return tma ? scan_occupancy<2, true>(smem) : scan_occupancy<2, false>(smem);
}


// Each launcher returns cudaGetLastError() right after its launches (0 on
// success), or cudaErrorInvalidValue for arguments the kernels do not take.

#define SCAN(NAME, CODE)                                                    \
  int NAME(const void* pages, const void* scales, const void* table,       \
           void* ws, void* flags, void* out, long long n_rows, float thr,  \
           int n_valid, int page_rows, int n_cols, int filter_col, int op, \
           int tma, int chunk_pages, int unit_pages, int n_stages,         \
           int page_stride, int stage_bytes, int mask_words, int vw,       \
           int n_fold, int passes, int slot_pages, int slot_stride,        \
           int n_slots, int n_chunks, int n_prod, int pad_pages, int epoch, \
           int follow_only, int smem, void* stream) {                      \
    return launch_scan<CODE>(pages, scales, table, ws, flags, out, n_rows, \
                             thr, n_valid, page_rows, n_cols, filter_col,  \
                             op, tma, chunk_pages, unit_pages, n_stages,   \
                             page_stride, stage_bytes, mask_words, vw,     \
                             n_fold, passes, slot_pages, slot_stride,      \
                             n_slots, n_chunks, n_prod, pad_pages, epoch,  \
                             follow_only, smem, stream);                   \
  }
SCAN(scan_filter_reduce_f32, 0)
SCAN(scan_filter_reduce_int8, 1)
SCAN(scan_filter_reduce_fp8, 2)
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
