// Paged GQA attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernels in
// repro/kernels/paged_attention.py:
//   * _paged_kernel (:39)     -> paged_decode_f32, paged_chunk_f32, and
//                                on bf16 pages paged_decode_bf16,
//                                paged_chunk_bf16
//   * _paged_q8_kernel (:77)  -> paged_decode_q8_{int8,fp8},
//                                paged_chunk_q8_{int8,fp8}
// plus paged_combine_f32, the merge of the decode form's split partials,
// and the pool form of both (paged_pool_decode_*, paged_pool_chunk_*).
// The bf16 exports are built from this file by paged_attention_bf16.cu
// (PAGED_BF16 defined), a library of their own, so the two nvcc runs go
// side by side; each library holds only its exports' instantiations.
// Same function: for each (query row, query head), a softmax over the
// positions below the row's length of the pages its table row names
// (pages at or past the length are never read), out = acc / max(l,
// 1e-30), so a length-0 row writes zeros.  For quantized pages the k
// scale multiplies the logit and the v scale the probability; codes are
// converted in registers or in shared memory, never to a page.
//
// Two forms behind the same wrappers (kernels/paged_attention.py):
//
// Decode form (any table): grid (B, Hkv, S).  Bound on this card: the
// k/v bytes of the valid pages, about 4*D flops per (query head, key),
// far below the flops-per-byte balance; at decode shapes the time is
// the latency of each block's chain of dependent page loads.  So:
//   * split-K over pages: split s walks `per` consecutive pages of its
//     row and writes the un-normalised partials (acc [G, D], m [G],
//     l [G]); paged_combine_f32 merges the splits by max-rebase (the
//     reference's combine_partials).  The wrapper picks S on the host
//     from B, Hkv, pps and the SM count (never from lengths, which would
//     sync), so short rows leave their late splits empty and cheap;
//   * a ring of kStages tiles in shared memory filled by 16-byte
//     cp.async copies, so the next tiles load while one is scored, with
//     one barrier per tile.  A tile is a page, or the largest half,
//     quarter, ... of one where kStages pages would not fit (f32 at
//     D 256 and pages above 32);
//   * codes stay bytes in shared memory (a quarter of the f32 traffic),
//     converted where they are read, the tile's scales beside them;
//   * one warp per query head of the kv head, lanes over tokens for the
//     scores (a tile of 16 splits each dot over two lanes), lanes over D
//     for P.V; the G heads share each staged tile.  A group above 32
//     heads is cut into ceil(G / 32) equal parts, one block each (grid
//     (B, Hkv * parts, S)); each part stages the tiles itself;
//   * pages above kMaxTile (64) tokens are staged as several tiles.
//
// Chunk form (a table whose rows are all one row, page_table.stride(0)
// == 0: the rows of one prefill chunk): grid (ceil(C / R), Hkv).  Bound:
// operations, 4*D f32 flops per kept (position, head, key) against K/V
// read once.  A decode-shaped grid re-reads every page once per query
// position; here a block's 64 rows are R consecutive positions times the
// G query heads of the kv head, and they share every K/V tile:
//   * tiles of KT consecutive keys (64, or 32 at D > 128; four pages at
//     page 16, part of one at pages above KT) gathered through the table,
//     converted to f32 once when staged (each staged element is read by
//     16 threads, so converting it where read would cost more than the
//     FMAs), into a double-buffered shared ring: the next tile's loads
//     are in flight in registers while this one is computed, one barrier
//     a tile;
//   * 4x4 register tiles of scalar f32 FMAs for the scores and 4 x D/16
//     for P.V, as in flash_attention.cu (f32 contract, TF32 off);
//   * each row's own length masks its keys, so the chunk's causality
//     falls out of the lengths; tiles past the block's largest length
//     are never loaded.
//
// Pool form (the reference's paged_attention_partial per node, merged by
// its combine_partials; repro/runtime/serve.py:78, :130): N nodes of
// n_local pages each share one store, node s holding the physical pages
// [s * n_local, (s + 1) * n_local).  Both kernels take it as their POOL
// instantiation, a node dimension in the grid's z:
//   * node compaction: a block first lists, in shared memory, the logical
//     pages of its row (table columns below the length) whose physical
//     page lies in its node's window, in ascending order (a warp ballot
//     and __popc prefix a round of columns), and walks only those.  The
//     decode form's split t of node s takes the listed pages of rank
//     [t * per, (t + 1) * per); the chunk form's KT-key tiles run over the
//     node's listed keys (compacted key i: page list[i / page], slot i %
//     page, position list[i / page] * page + i % page, which the length
//     mask reads).  So the N nodes together do the single form's work
//     once, and a (node, split) that owns nothing of its row writes (0,
//     -1e30, 0) after reading a row of ints.  A list longer than the
//     room left in shared memory is walked in windows of `cap` pages;
//   * partials at node offset s of one workspace: split t of node s at
//     s * S + t of acc [B, H, N * S, d], the chunk form's one partial a
//     node at acc [C, H, N, d] (m, l beside them);
//   * the merge inside the launch: each block of a group (the N * S
//     blocks of one (b, kv head part), the N node blocks of one (row
//     tile, kv head)) writes its partials, and one thread fences for the
//     block and takes a ticket with atomicAdd; the block that draws the
//     last merges the group's partials into `out` (read through L2,
//     __ldcg: other blocks of this launch wrote them), its weights over
//     the then idle ring or tiles, and resets its ticket to 0, so no
//     memset is needed between launches.  The decode form merges with the
//     combine kernel's own per-warp body (merge_partials); the chunk
//     form's 64 rows of N partials go at once (merge_rows: the same
//     arithmetic, its loads in flight together).  Without `out` the
//     partials are the result;
//   * dispatch order: the decode grid's z is split-major (a row's first
//     splits, the ones its length fills, go first whatever node owns
//     them; node-major, the last node's work starts last); the pool chunk kernel
//     asks for one block a SM (held to two, its codes' instantiations
//     spilled) and has only its general instantiation (d not a constant:
//     half the build of the pool chunk kernels).
// At one node whose window is the store the list is 0, 1, ... and the
// tiles, the splits and the merge are the single forms': the pool form
// then computes their bits (the chunk form's one partial merges to acc *
// 1 / max(l * 1, 1e-30), its own acc / max(l, 1e-30)).  The single-device
// forms (POOL = false) have no window test and no list.
//
// Head dims: any multiple of 8 from 8 to 256 (kernel_takes in
// kernels/paged_attention.py).  Both forms are instantiated at D = 32*NV,
// NV = ceil(d / 32) in 1..8; the columns d..D-1 of every staged row (and
// of q) are zero, so they add nothing to a dot, and only the d real
// columns are read and written.  A row of codes whose d bytes are not a
// multiple of 16 (int8/fp8 at d = 8 mod 16) is copied in 8-byte pieces.
//
// bf16 pages are unquantized (Q = false): each element is widened to f32
// where it is read (decode form) or staged (chunk form), as the Pallas
// body widens its pages, and every product and sum is f32.  A bf16 row
// of d (a multiple of 8) elements is a whole number of 16-byte chunks.
//
// Layouts (row-major): q/out [B, H, d] f32; k/v pages [P, page, Hkv, d]
// of T, 16-byte aligned (8 for such rows of codes); scales [P, page, Hkv]
// f32; page_table [B, pps] int32 (the chunk form reads one row); lengths
// [B] int32; partials acc [B, H, S, d], m/l [B, H, S] f32; tickets (pool
// form with `out`) one zeroed uint32 a group.  page <= kMaxPage, G <=
// kMaxGroup.  Page ids named below ceil(length/page) must lie in [0, P);
// entries past it are never read.

#include <climits>
#include <cmath>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxPage = 1024;
constexpr int kMaxGroup = 64;
constexpr int kBlockHeads = 32;    // decode form: query heads (warps) a block
constexpr int kMaxTile = 64;       // decode form: tokens of a ring slot
constexpr int kMaxSmem = 232448;   // bytes a block can use on sm_90
constexpr int kStages = 3;         // decode form: tiles in the ring

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int e) {
  return to_f32(reinterpret_cast<const T*>(&raw)[e]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// pool form: the owned-page list and the merge of a row's partials

// Pool form: the ordered list of the columns c < n_cols of a table row
// whose physical page lies in [base, base + n_local), ranks [w0, w0 + cap)
// into lst[rank - w0].  Returns how many columns are owned.  Every thread
// of the block calls it (blockDim.x a multiple of 32); warp_n holds a
// count a warp.  Ends with a barrier, so lst is then readable by all.
__device__ int owned_list(const int* __restrict__ tab, int n_cols, int base,
                          int n_local, int w0, int cap, int* lst, int* warp_n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;     // the lanes under this one
  int total = 0;
  for (int c0 = 0; c0 < n_cols; c0 += blockDim.x) {
    const int c = c0 + tid;
    const bool own = c < n_cols && (unsigned)(tab[c] - base) < (unsigned)n_local;
    const unsigned vote = __ballot_sync(0xffffffffu, own);
    if (lane == 0) warp_n[warp] = __popc(vote);
    __syncthreads();
    int rank = total + __popc(vote & below);
    for (int w = 0; w < n_warps; ++w) {
      const int x = warp_n[w];
      rank += w < warp ? x : 0;
      total += x;
    }
    if (own && rank >= w0 && rank - w0 < cap) lst[rank - w0] = c;
    __syncthreads();                       // warp_n is rewritten next round
  }
  return total;
}


// Max-rebase merge of the n partials of one row by one warp:
// m* = max m_s, l = sum l_s e^(m_s - m*), out = sum acc_s e^(m_s - m*) / max(l, 1e-30).
// The partials' m and l are read in one round trip (a lane per partial),
// the weights go through w (n floats of shared memory), and each lane's acc
// loads are issued kUnroll partials at a time so their latencies overlap.
// L2: the partials were written by other blocks of the same launch, so
// they are read through L2 (__ldcg), never the read-only path, which may
// hold lines from before their stores; else (a launch after theirs) m
// and l by plain loads and acc through the read-only path.
// paged_combine_f32's kernel and the pool decode form's merge both run
// this, so their bits agree (the pool chunk form's merge_rows computes
// the same arithmetic).
constexpr int kUnroll = 8;

template <bool L2>
__device__ __forceinline__ void merge_partials(const float* a, const float* m,
                                               const float* l, float* w,
                                               float* o, int n, int d, int lane) {
  float mx = kNegInf;
  for (int s = lane; s < n; s += 32) {
    w[s] = L2 ? __ldcg(m + s) : m[s];
    mx = fmaxf(mx, w[s]);
  }
  mx = warp_max(mx);
  float lsum = 0.f;
  for (int s = lane; s < n; s += 32) {
    const float e = expf(w[s] - mx);
    w[s] = e;
    lsum = fmaf(L2 ? __ldcg(l + s) : l[s], e, lsum);
  }
  const float denom = fmaxf(warp_sum(lsum), 1e-30f);
  __syncwarp();
  for (int c = lane; c < d; c += 32) {
    float x = 0.f;
    int s = 0;
    for (; s + kUnroll <= n; s += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* p = a + (size_t)(s + u) * d + c;
        v[u] = L2 ? __ldcg(p) : __ldg(p);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x = fmaf(v[u], w[s + u], x);
    }
    for (; s < n; ++s) {
      const float* p = a + (size_t)s * d + c;
      x = fmaf(L2 ? __ldcg(p) : __ldg(p), w[s], x);
    }
    o[c] = x / denom;
  }
  if (L2) __syncwarp();                   // w is rewritten for the warp's next row
}

// Pool form: the rows the last block of a group merges, r = 0 .. rows-1:
// the decode form's head rows row0 + r below `valid`, the chunk form's
// (position q0 + r % bq, head kvh * group + r / bq) below position
// c_rows.  -1: no row.
struct RowMap {
  long long row0;
  int valid, q0, bq, c_rows, h, head0;
  int lg;                                // log2(bq) where bq is a power of two
  __device__ __forceinline__ long long operator()(int r) const {
    if (bq == 0) return r < valid ? row0 + r : -1LL;
    const int pos = q0 + (lg >= 0 ? r & (bq - 1) : r % bq);
    const int hd = lg >= 0 ? r >> lg : r / bq;
    return pos < c_rows ? (long long)pos * h + head0 + hd : -1LL;
  }
};

// Pool form: the last block's merge of the n <= NB partials of each of
// `rows` rows into out (row r: partials at map(r) * n of p_m / p_l, times
// d of p_acc, output at map(r) * d), by every thread of the block.  The
// merge sits at the end of the launch's critical path and its cost is
// round trips to L2, so it takes all the rows at once: the weights g
// lanes a row (g: the power of two >= n; m and l loaded together, the max
// and the sum by xor shuffles within the g lanes) into sh with each row's
// id and denominator, then each (row, column) item is one thread's, IB
// items a thread at a time with their IB * NB partial loads in flight
// together, the first batch issued before the weights.  The same
// arithmetic as merge_partials, whose lane s holds partial s (its warp
// sum adds exact zeros from the lanes past g, so its association is the
// g-lane butterfly's) and whose fmas run over s in order: the same bits.
// sh: (rows + 1) * 32 + 3 * rows + 1 floats.
template <int NB, int IB>
__device__ __forceinline__ void merge_rows(const float* p_acc, const float* p_m,
                                           const float* p_l, float* out, int rows,
                                           RowMap map, int n, int d, float* sh) {
  const int tid = threadIdx.x, T = blockDim.x;
  int g = 1;
  while (g < n) g *= 2;
  float* w = sh;                         // [rows][g] weights
  float* den = w + rows * g;             // [rows] max(l, 1e-30)
  long long* rid = reinterpret_cast<long long*>(   // [rows], 8-byte aligned
      sh + ((rows * g + rows + 1) & ~1));
  // items i = tid + k * T, walked as (r, c) without a division each
  const int step_r = T / d, step_c = T - step_r * d;
  int r0 = tid / d, c0 = tid - r0 * d;
  long long ri[IB];
  int r[IB], c[IB];
  float v[IB][NB];
  auto load = [&](bool mapped) {         // the next batch: items and partials
#pragma unroll
    for (int k = 0; k < IB; ++k) {
      r[k] = r0;
      c[k] = c0;
      ri[k] = r0 < rows ? (mapped ? rid[r0] : map(r0)) : -1LL;
      const float* a = p_acc + (ri[k] >= 0 ? ri[k] * n * d + c[k] : 0);
#pragma unroll
      for (int s = 0; s < NB; ++s)
        v[k][s] = ri[k] >= 0 && s < n ? __ldcg(a + s * d) : 0.f;
      c0 += step_c;
      r0 += step_r + (c0 >= d);
      if (c0 >= d) c0 -= d;
    }
  };
  load(false);                           // in flight while the weights are made

  const int slots = (rows * g + 31) / 32 * 32;   // whole warps: the shuffles
  for (int i = tid; i < slots; i += T) {
    const int rr = i / g, s = i - rr * g;
    const long long ro = rr < rows ? map(rr) : -1LL;
    const bool has = ro >= 0 && s < n;
    const float mv = has ? __ldcg(p_m + ro * n + s) : kNegInf;
    const float lv = has ? __ldcg(p_l + ro * n + s) : 0.f;
    float mx = mv;
    for (int o = g / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e = expf(mv - mx);
    float t = has ? fmaf(lv, e, 0.f) : 0.f;
    for (int o = g / 2; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (has) w[i] = e;
    if (rr < rows && s == 0) {
      den[rr] = fmaxf(t, 1e-30f);
      rid[rr] = ro;
    }
  }
  __syncthreads();

  for (bool first = true; first || r0 < rows; first = false) {
    if (!first) load(true);
#pragma unroll
    for (int k = 0; k < IB; ++k) {
      if (ri[k] < 0) continue;
      float x = 0.f;
#pragma unroll
      for (int s = 0; s < NB; ++s)
        if (s < n) x = fmaf(v[k][s], w[r[k] * g + s], x);
      out[ri[k] * d + c[k]] = x / den[r[k]];
    }
  }
}

// The merge of a group.  The chunk form (64 rows of N partials):
// merge_rows for N <= 8 (64 loads a thread: one batch for its rows at
// d <= 64); the decode form (the heads of a part, N * S partials):
// merge_partials a row per warp, as paged_combine_f32 does (measured as
// fast there, and its 64 registers a thread hold no batch); else
// merge_partials a row per warp, the first mw warps (sh: n floats each).
template <bool CHUNK>
__device__ __forceinline__ void merge_block(const float* p_acc, const float* p_m,
                                            const float* p_l, float* out, int rows,
                                            RowMap map, int n, int d, float* sh,
                                            int mw) {
  if constexpr (CHUNK) {
    if (n <= 4) return merge_rows<4, 16>(p_acc, p_m, p_l, out, rows, map, n, d, sh);
    if (n <= 8) return merge_rows<8, 8>(p_acc, p_m, p_l, out, rows, map, n, d, sh);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= mw) return;
  for (int rr = warp; rr < rows; rr += mw) {
    const long long ro = map(rr);
    if (ro < 0) continue;
    merge_partials<true>(p_acc + ro * n * d, p_m + ro * n, p_l + ro * n,
                         sh + warp * n, out + ro * d, n, d, lane);
  }
}

// Pool form: the group's ticket after every thread's stores; true in the
// block that drew the last one (which resets it).  Called by every thread.
// One thread fences for the block, after the barrier that orders the
// block's stores before it (as a grid barrier does): a fence in every
// thread costs more than the merge.
__device__ __forceinline__ bool last_of_group(unsigned* tickets, unsigned group,
                                              unsigned size) {
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    __threadfence();                     // the block's partials, device-wide
    last = atomicAdd(tickets + group, 1u) == size - 1;
    if (last) {
      __threadfence();                   // the other blocks' partials, seen
      tickets[group] = 0u;
    }
  }
  return __syncthreads_or(last);
}

// ---------------------------------------------------------------------------
// decode form

// bytes of one staged token row (codes + 16 of padding: rows of
// consecutive lanes start 4 banks apart, and stay 16-byte aligned)
template <typename T, int NV>
struct Row {
  static constexpr int kChunks = NV * 32 * (int)sizeof(T) / 16;   // 16B a row
  static constexpr int kBytes = kChunks * 16 + 16;
};

// bytes of one ring slot: `tile` k rows and v rows, then (quantized) their
// k and v scales, rounded up so the next slot stays 16-byte aligned
template <typename T, bool Q, int NV>
__host__ __device__ __forceinline__ size_t slot_bytes(int tile) {
  const size_t raw = (size_t)2 * tile * Row<T, NV>::kBytes +
                     (Q ? (size_t)2 * tile * sizeof(float) : 0);
  return (raw + 15) / 16 * 16;
}

template <typename T, bool Q, int NV>
size_t decode_smem(int tile, int heads) {
  return kStages * slot_bytes<T, Q, NV>(tile) +
         sizeof(float) * ((size_t)heads * NV * 32 + (size_t)heads * tile);
}

// tokens of a ring slot: the page (at most kMaxTile), or the largest
// half, quarter, ... of it at which the block's shared memory fits
template <typename T, bool Q, int NV>
int decode_tile(int page, int heads) {
  int tile = page < kMaxTile ? page : kMaxTile;
  while (tile > 1 && decode_smem<T, Q, NV>(tile, heads) > (size_t)kMaxSmem)
    tile = (tile + 1) / 2;
  return tile;
}

// Block (b, kv head * parts + part, node * splits + split): `heads` warps,
// the query heads part * heads .. of the kv head's group (a warp past the
// group idles but helps stage the tiles).  d: the head dim, D = 32 * NV >=
// d.  FULL: d == D and one part (the instantiation every configuration's
// full width takes: constants where the general one has runtime values).
// POOL: the pool form (the node's owned-page list, `cap` pages of it at a
// time; with `out`, the group's merge by the last block, `merge_warps`
// warps of it holding weights); else the single-device form (splits walk
// table columns, n_local, cap, out and tickets unused).
template <typename T, bool Q, int NV, bool FULL, bool POOL>
__global__ void __launch_bounds__(kBlockHeads * 32)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ p_acc,
                    float* __restrict__ p_m, float* __restrict__ p_l,
                    float* __restrict__ out, unsigned* __restrict__ tickets,
                    int pps, int page, int tile, int hkv, int group, int parts,
                    int d_, int per, int splits, int n_local, int cap,
                    int merge_warps, float sm_scale) {
  constexpr int D = NV * 32;
  const int d = FULL ? D : d_;
  constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  constexpr int CH = Row<T, NV>::kChunks;
  constexpr int RB = Row<T, NV>::kBytes;
  extern __shared__ __align__(16) unsigned char ring_sh[];
  const size_t slot_b = slot_bytes<T, Q, NV>(tile);
  const int heads = blockDim.x >> 5;
  float* q_sh = reinterpret_cast<float*>(ring_sh + kStages * slot_b);      // [heads][D]
  float* p_sh = q_sh + heads * D;                                       // [heads][tile]
  int* lst = reinterpret_cast<int*>(p_sh + heads * tile);   // pool: [cap] pages

  const int b = blockIdx.x;
  // pool form: z split-major (a row's first splits, which its length
  // fills, are dispatched first, whatever node owns them)
  const int n_nodes = gridDim.z / splits;
  const int node = POOL ? blockIdx.z % n_nodes : 0;
  const int split = POOL ? blockIdx.z / n_nodes : blockIdx.z;
  const int kvh = FULL ? blockIdx.y : blockIdx.y / parts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = hkv * group;
  const int gh = FULL ? warp : (blockIdx.y - kvh * parts) * heads + warp;   // head in the group
  const bool active = FULL || gh < group;
  const int head = kvh * group + (active ? gh : 0);
  const int length = lengths[b];
  int n_pages = (length + page - 1) / page;
  n_pages = n_pages < pps ? n_pages : pps;
  const int* tab = page_table + (size_t)b * pps;
  // this split's pages: table columns [r0, r_end), or (pool) the ranks
  // [r0, r_end) of the node's owned pages, listed `cap` at a time (p_sh
  // holds the list's warp counts: it is free outside the walk)
  const int r0 = split * per;
  int r_end = r0 + per < n_pages ? r0 + per : n_pages;
  if (POOL) {
    const int n_own = owned_list(tab, n_pages, node * n_local, n_local, r0, cap,
                                 lst, reinterpret_cast<int*>(p_sh));
    r_end = r0 + per < n_own ? r0 + per : n_own;
  }
  const int tpp = (page + tile - 1) / tile;   // tiles a page
  const size_t row = (size_t)b * h + head;
  const size_t ps = row * gridDim.z + node * splits + split;   // node-major

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;             // l: this lane's tokens; summed at the end

  if (r0 < r_end) {                       // else: past the length, or not owned
    // a staged row holds the d real columns; the rest of its CH chunks
    // stay zero (set once here: the copies never write them)
    const int rb = d * (int)sizeof(T);
    const bool narrow = rb % 16 != 0;     // codes at d = 8 mod 16: 8-byte copies
    const int n_units = narrow ? rb / 8 : rb / 16;
    if (rb < CH * 16) {
      const int pad = CH * 16 - rb;       // a multiple of 8
      for (int e = threadIdx.x; e < kStages * 2 * tile * (pad / 8); e += blockDim.x) {
        const int r = e / (pad / 8), o = e % (pad / 8);
        const int s_ = r / (2 * tile), rr = r % (2 * tile);
        *reinterpret_cast<uint2*>(ring_sh + s_ * slot_b + rr * RB + rb + o * 8) =
            make_uint2(0u, 0u);
      }
    }
    const size_t tok_stride = (size_t)hkv * d;

    // scores: `sub` lanes share a token's dot (chunks split between them)
    int sub = 1;
    while (2 * sub * tile <= 32 && CH % (2 * sub) == 0) sub *= 2;
    const int span = sub > 1 ? tile : 32;   // tokens scored in one pass
    const int part = lane / span, tok = lane % span;
    const int c0 = part * (CH / sub), c1 = c0 + CH / sub;
    const bool scorer = part < sub;
    const float* qw = q_sh + warp * D;
    float* pw = p_sh + warp * tile;

    const int step = POOL ? cap : per;
    for (int w0 = r0; w0 < r_end; w0 += step) {
      if (POOL && w0 != r0) {             // the list's next window
        __syncthreads();
        owned_list(tab, n_pages, node * n_local, n_local, w0, cap, lst,
                   reinterpret_cast<int*>(p_sh));
      }
      const int w1 = w0 + step < r_end ? w0 + step : r_end;
      // the logical page of the window's pg-th page
      auto page_of = [&](int pg) { return POOL ? lst[pg] : w0 + pg; };
      // the window's tiles (none past the row's length): tpp a page, fewer
      // on the row's last page where the length cuts it
      const int n = (w1 - 1 - w0) * tpp +
                    (min(length - page_of(w1 - 1 - w0) * page, page) + tile - 1) / tile;
      // tile j: its page within the window, its first token in that page
      // and its tokens below the length (no division where a tile is a page)
      auto locate = [&](int j, int& pg, int& t0) {
        pg = tpp == 1 ? j : j / tpp;
        t0 = tpp == 1 ? 0 : (j - pg * tpp) * tile;
        const int rest = length - page_of(pg) * page - t0;
        const int in_page = page - t0 < tile ? page - t0 : tile;
        return rest < in_page ? rest : in_page;
      };
      auto issue = [&](int j) {      // tile j of the window into slot j % kStages
        unsigned char* slot = ring_sh + (j % kStages) * slot_b;
        int pg, t0;
        const int nv = locate(j, pg, t0);
        const size_t slot0 = (size_t)tab[page_of(pg)] * page + t0;
        const size_t base = slot0 * tok_stride + (size_t)kvh * d;
        if (rb == CH * 16) {                 // full rows: a constant divisor
          for (int e = threadIdx.x; e < nv * CH; e += blockDim.x) {
            const int t = e / CH, c = e % CH;
            const size_t g = base + (size_t)t * tok_stride + (size_t)c * kVec;
            cp_async16(slot + t * RB + c * 16, k_pages + g);
            cp_async16(slot + (tile + t) * RB + c * 16, v_pages + g);
          }
        } else if (!narrow) {
          for (int e = threadIdx.x; e < nv * n_units; e += blockDim.x) {
            const int t = e / n_units, c = e % n_units;
            const size_t g = base + (size_t)t * tok_stride + (size_t)c * kVec;
            cp_async16(slot + t * RB + c * 16, k_pages + g);
            cp_async16(slot + (tile + t) * RB + c * 16, v_pages + g);
          }
        } else {
          for (int e = threadIdx.x; e < nv * n_units; e += blockDim.x) {
            const int t = e / n_units, c = e % n_units;
            const size_t g = base + (size_t)t * tok_stride + (size_t)c * (kVec / 2);
            cp_async8(slot + t * RB + c * 8, k_pages + g);
            cp_async8(slot + (tile + t) * RB + c * 8, v_pages + g);
          }
        }
        if (Q) {
          float* sc = reinterpret_cast<float*>(slot + 2 * tile * RB);
          for (int t = threadIdx.x; t < nv; t += blockDim.x) {
            const size_t g = (slot0 + t) * hkv + kvh;
            cp_async4(sc + t, k_scale + g);
            cp_async4(sc + tile + t, v_scale + g);
          }
        }
      };

#pragma unroll
      for (int j = 0; j < kStages - 1; ++j) {
        if (j < n) issue(j);
        cp_async_commit();
      }
      if (w0 == r0)
        for (int c = lane; c < D; c += 32) q_sh[warp * D + c] = c < d ? q[row * d + c] : 0.f;

      for (int j = 0; j < n; ++j) {
        cp_async_wait<kStages - 2>();       // tile j has landed (this thread's part)
        __syncthreads();                    // ... everyone's; slot j-1 is free
        if (j + kStages - 1 < n) issue(j + kStages - 1);
        cp_async_commit();
        if (!active) continue;              // the warp only helps stage tiles

        const unsigned char* slot = ring_sh + (j % kStages) * slot_b;
        const float* sc = reinterpret_cast<const float*>(slot + 2 * tile * RB);
        int pg, t0;
        const int nv = locate(j, pg, t0);

        float m_loc = kNegInf;
        for (int t0 = 0; t0 < nv; t0 += span) {
          const int t = t0 + tok;
          float s = 0.f;
          if (scorer && t < nv) {
            const unsigned char* kr = slot + t * RB;
            for (int c = c0; c < c1; ++c) {
              const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 16);
#pragma unroll
              for (int e = 0; e < kVec; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qw + c * kVec + e);
                s = fmaf(qv.x, elem<T>(raw, e), s);
                s = fmaf(qv.y, elem<T>(raw, e + 1), s);
                s = fmaf(qv.z, elem<T>(raw, e + 2), s);
                s = fmaf(qv.w, elem<T>(raw, e + 3), s);
              }
            }
          }
          for (int w = sub / 2; w >= 1; w >>= 1) s += __shfl_down_sync(0xffffffffu, s, w * span);
          if (scorer && part == 0 && t < nv) {
            s = Q ? s * sc[t] * sm_scale : s * sm_scale;
            pw[t] = s;
            m_loc = fmaxf(m_loc, s);
          }
        }
        const float m_new = fmaxf(m, warp_max(m_loc));
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] *= alpha;
        __syncwarp();
        for (int t = lane; t < nv; t += 32) {   // lane t owns token t's p
          const float p = expf(pw[t] - m_new);
          l += p;
          pw[t] = Q ? p * sc[tile + t] : p;
        }
        __syncwarp();
        const unsigned char* vrow = slot + tile * RB;
#pragma unroll 4
        for (int t = 0; t < nv; ++t) {
          const float p = pw[t];
          const T* vr = reinterpret_cast<const T*>(vrow + t * RB);
#pragma unroll
          for (int i = 0; i < NV; ++i) acc[i] = fmaf(p, to_f32(vr[lane + 32 * i]), acc[i]);
        }
        m = m_new;
        __syncwarp();                       // pw is rewritten by the next tile
      }
      cp_async_wait<0>();
    }
  }

  // this (node, split)'s partial; (0, -1e30, 0) where it walked nothing
  l = warp_sum(l);
  if (active) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < d) p_acc[ps * d + lane + 32 * i] = acc[i];
    if (lane == 0) { p_m[ps] = m; p_l[ps] = l; }
  }
  if (!POOL || out == nullptr) return;

  // pool form: the last of the (b, kv head part)'s N * S blocks merges
  // every head row of the part, a warp a row, over the idle ring
  if (!last_of_group(tickets, blockIdx.x * gridDim.y + blockIdx.y, gridDim.z)) return;
  const int gh0 = FULL ? 0 : (blockIdx.y - kvh * parts) * heads;
  const RowMap map{(long long)b * h + kvh * group + gh0, group - gh0, 0, 0, 0, 0, 0, -1};
  merge_block<false>(p_acc, p_m, p_l, out, heads, map, gridDim.z, d,
                     reinterpret_cast<float*>(ring_sh), merge_warps);
}

// paged_combine_f32: the decode form's split partials merged, one warp per
// (b, head) row (merge_partials)
constexpr int kCombineWarps = 4;

__global__ void __launch_bounds__(kCombineWarps * 32)
paged_combine_kernel(const float* __restrict__ p_acc, const float* __restrict__ p_m,
                     const float* __restrict__ p_l, float* __restrict__ out,
                     int rows, int n_split, int d) {
  extern __shared__ float w_sh[];          // [kCombineWarps][S] weights
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kCombineWarps + warp;
  if (row >= rows) return;
  merge_partials<false>(p_acc + (size_t)row * n_split * d, p_m + (size_t)row * n_split,
                        p_l + (size_t)row * n_split, w_sh + warp * n_split,
                        out + (size_t)row * d, n_split, d, lane);
}

// ---------------------------------------------------------------------------
// chunk form

constexpr int kRows = 64;      // rows of a block: G heads x R positions
constexpr int kThreads = 256;

template <int D>
struct Chunk {
  static constexpr int KT = D <= 128 ? 64 : 32;        // keys of a tile (any page)
  static constexpr int KJ = KT / 16;                   // keys a thread scores
  static constexpr int VW = D % 64 == 0 ? 4 : 2;       // floats per output vector
  static constexpr int NG = D / (16 * VW);             // output vectors a row
  static constexpr int LD = D + 4;                     // padded f32 row
  static constexpr int LDP = KT + 16;                  // p_sh row stride
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kRows * LD + (size_t)2 * 2 * KT * LD +
                       (size_t)2 * 2 * KT + (size_t)kRows * LDP);
};

template <int VW>
struct Vec;
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

// chunk c of a staged row of d elements of T at p (the row's start):
// 16 bytes, or two 8-byte pieces for codes at d = 8 mod 16 (the row is
// only 8-byte aligned; its last chunk is half a chunk, zero above)
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int c, int d, bool narrow) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (sizeof(T) == 4 || !narrow)
    return __ldg(reinterpret_cast<const uint4*>(p + c * kVec));
  const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p + c * kVec));
  const uint2 hi = (c + 1) * kVec <= d
                       ? __ldg(reinterpret_cast<const uint2*>(p + c * kVec + kVec / 2))
                       : make_uint2(0u, 0u);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

// 16 bytes of T -> 16/sizeof(T) floats at dst (16-byte aligned)
__device__ __forceinline__ void cvt_store(float* dst, const uint4& raw, float) {
  *reinterpret_cast<uint4*>(dst) = raw;
}
template <typename T>
__device__ __forceinline__ void cvt_store(float* dst, const uint4& raw, T) {
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(elem<T>(raw, e), elem<T>(raw, e + 1), elem<T>(raw, e + 2),
                    elem<T>(raw, e + 3));
}

// POOL: the pool form (the node's owned-page list, `cap` pages of it at a
// time, its keys' positions staged beside each tile; partials out and,
// with `out`, the group's merge by the last node block, `merge_warps`
// warps of it holding weights); the single-device form compiles without
// them.
#define CHUNK_PARAMS                                                          \
  const float* __restrict__ q, const T* __restrict__ k_pages,                 \
      const T* __restrict__ v_pages, const float* __restrict__ k_scale,       \
      const float* __restrict__ v_scale, const int* __restrict__ table_row,   \
      const int* __restrict__ lengths, float* __restrict__ out,               \
      float* __restrict__ p_acc, float* __restrict__ p_m,                     \
      float* __restrict__ p_l, unsigned* __restrict__ tickets, int c_rows,    \
      int pps, int page, int hkv, int group, int bq, int d_, int n_nodes,     \
      int n_local, int cap, int merge_warps, float sm_scale
#define CHUNK_ARGS                                                            \
  q, k_pages, v_pages, k_scale, v_scale, table_row, lengths, out, p_acc, p_m, \
      p_l, tickets, c_rows, pps, page, hkv, group, bq, d_, n_nodes, n_local,  \
      cap, merge_warps, sm_scale

template <typename T, bool Q, int D, bool FULL, bool POOL>
__device__ __forceinline__ void chunk_body(CHUNK_PARAMS) {
  const int d = FULL ? D : d_;
  using S = Chunk<D>;
  constexpr int KT = S::KT, KJ = S::KJ, LD = S::LD, LDP = S::LDP;
  constexpr int VW = S::VW, NG = S::NG, NV4 = D / 4;
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int CH = D / kVec;                          // 16-byte loads a row
  constexpr int NL = (KT * CH + kThreads - 1) / kThreads;   // loads a thread
  extern __shared__ __align__(16) float tile_sh[];
  float* q_sh = tile_sh;                                   // [kRows][LD]
  float* kv_sh = q_sh + kRows * LD;                     // [2][2][KT][LD]
  float* sc_sh = kv_sh + 2 * 2 * KT * LD;               // [2][2][KT] scales
  float* p_sh = sc_sh + 2 * 2 * KT;                     // [kRows][LDP]
  int* pos_sh = reinterpret_cast<int*>(p_sh + kRows * LDP);   // pool: [2][KT]
  int* lst = pos_sh + 2 * KT;                           // pool: [cap] pages

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;     // longest rows first
  // pool form: node blockIdx.z owns the physical pages [base, base + n_local)
  const int node = POOL ? blockIdx.z : 0;
  const int base = node * n_local;
  const int h = hkv * group;
  const int rows = group * bq;
  const size_t tok_stride = (size_t)hkv * d;
  // chunks of a row holding real columns (the rest are staged as zeros)
  const int ch_real = (d + kVec - 1) / kVec;
  const bool narrow = d % kVec != 0;

  auto stage_q = [&] {
    for (int e = tid; e < kRows * NV4; e += kThreads) {
      const int r = e / NV4, d4 = (e % NV4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && q0 + r % bq < c_rows && d4 < d) {
        const int head = kvh * group + r / bq;
        x = __ldg(reinterpret_cast<const float4*>(
            q + ((size_t)(q0 + r % bq) * h + head) * d + d4));
      }
      *reinterpret_cast<float4*>(q_sh + r * LD + d4) = x;
    }
  };
  if (!POOL) stage_q();

  int len[4];
  float m[4], l[4], acc[4][NG * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int pos = q0 + r % bq;
    len[i] = r < rows && pos < c_rows ? min(lengths[pos], pps * page) : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * VW; ++c) acc[i][c] = 0.f;
  }
  int kmax = 0;                                         // the block's longest row
  for (int p = q0; p < q0 + bq && p < c_rows; ++p) kmax = max(kmax, lengths[p]);
  kmax = min(kmax, pps * page);
  // the keys this block walks: positions [0, kmax), or (pool) the node's
  // owned keys below kmax in ascending order, `cap` pages of them a
  // window (p_sh holds the list's warp counts: it is free outside a tile)
  int n_keys = kmax;
  const int n_cols = (kmax + page - 1) / page;
  if (POOL) {
    const int n_own = owned_list(table_row, n_cols, base, n_local, 0, cap, lst,
                                 reinterpret_cast<int*>(p_sh));
    n_keys = n_own * page;
    if (n_own > 0 && (unsigned)(table_row[n_cols - 1] - base) < (unsigned)n_local)
      n_keys -= n_cols * page - kmax;     // the row's last page, cut at kmax
    if (n_keys > 0) stage_q();            // a node that owns nothing stops here
  }
  const int win = POOL ? cap * page : kmax;   // keys a window (a multiple of KT)

  uint4 kr[NL], vr[NL];
  float ksr = 0.f, vsr = 0.f;
  int kps = INT_MAX;
  for (int w0 = 0; w0 < n_keys; w0 += win) {
    const int keys = n_keys - w0 < win ? n_keys - w0 : win;   // this window's
    if (POOL && w0 > 0) {                 // the list's next window
      __syncthreads();
      owned_list(table_row, n_cols, base, n_local, w0 / page, cap, lst,
                 reinterpret_cast<int*>(p_sh));
    }
    const int n_tiles = (keys + KT - 1) / KT;
    // key kw of the window: its logical page, page list[kw / page] (pool)
    auto page_of = [&](int pg) { return POOL ? lst[pg] : pg; };
    auto load = [&](int it) {      // tile it's codes into registers (0 past the keys)
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int e = tid + j * kThreads;
        const int c = e / CH, ch = e % CH;
        const int kw = it * KT + c;
        kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
        if (e < KT * CH && kw < keys && ch < ch_real) {
          const int pg = kw / page;
          const size_t g = ((size_t)table_row[page_of(pg)] * page + kw - pg * page) *
                               tok_stride + (size_t)kvh * d;
          kr[j] = load_chunk(k_pages + g, ch, d, narrow);
          vr[j] = load_chunk(v_pages + g, ch, d, narrow);
        }
      }
      if ((Q || POOL) && tid < KT) {
        const int kw = it * KT + tid;
        ksr = vsr = 0.f;
        kps = INT_MAX;
        if (kw < keys) {
          const int pg = kw / page, lp = page_of(pg);
          if (Q) {
            const size_t g = ((size_t)table_row[lp] * page + kw - pg * page) * hkv + kvh;
            ksr = __ldg(k_scale + g);
            vsr = __ldg(v_scale + g);
          }
          kps = lp * page + kw - pg * page;   // the key's position
        }
      }
    };
    auto store = [&](int buf) {
      float* k_sh = kv_sh + (size_t)buf * 2 * KT * LD;
      float* v_sh = k_sh + KT * LD;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int e = tid + j * kThreads;
        if (e < KT * CH) {
          const int o = (e / CH) * LD + (e % CH) * kVec;
          cvt_store(k_sh + o, kr[j], T());
          cvt_store(v_sh + o, vr[j], T());
        }
      }
      if (Q && tid < KT) {
        sc_sh[buf * 2 * KT + tid] = ksr;
        sc_sh[buf * 2 * KT + KT + tid] = vsr;
      }
      if (POOL && tid < KT) pos_sh[buf * KT + tid] = kps;
    };

    load(0);
    store(0);
    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      __syncthreads();             // tile it staged; tile it-1's buffer is free
      const bool more = it + 1 < n_tiles;
      if (more) load(it + 1);      // in flight while this tile is computed
      const float* k_sh = kv_sh + (size_t)buf * 2 * KT * LD;
      const float* v_sh = k_sh + KT * LD;
      const float* ks_sh = sc_sh + buf * 2 * KT;
      const float* vs_sh = ks_sh + KT;
      const int k0 = it * KT;

      float s[4][KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qa[4], kb[KJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[i] = *reinterpret_cast<const float4*>(q_sh + (ty + 16 * i) * LD + d);
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          kb[j] = *reinterpret_cast<const float4*>(k_sh + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
          }
      }

      // online softmax: the 16 lanes of a row hold the tile's keys, each
      // kept below the row's length (pool: at its staged position; a key
      // past the node's keys is at INT_MAX)
      int kp[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kp[j] = POOL ? pos_sh[buf * KT + tx + 16 * j] : k0 + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool keep[KJ];
        float mc = kNegInf;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int col = tx + 16 * j;
          keep[j] = kp[j] < len[i];
          const float x = Q ? s[i][j] * ks_sh[col] * sm_scale : s[i][j] * sm_scale;
          s[i][j] = keep[j] ? x : kNegInf;
          mc = fmaxf(mc, s[i][j]);
        }
        const float m_new = fmaxf(m[i], half_warp_max(mc));
        const float alpha = expf(m[i] - m_new);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int col = tx + 16 * j;
          const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
          ls += p;
          p_sh[(ty + 16 * i) * LDP + col] = Q ? p * vs_sh[col] : p;
        }
        l[i] = l[i] * alpha + ls;    // this lane's keys; summed at the end
#pragma unroll
        for (int c = 0; c < NG * VW; ++c) acc[i][c] *= alpha;
        m[i] = m_new;
      }
      __syncwarp();                  // a row's p is written and read by one half-warp

      for (int c = 0; c < KT; c += 4) {     // past the keys: p = 0, v = 0
        float4 pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pr[i] = *reinterpret_cast<const float4*>(p_sh + (ty + 16 * i) * LDP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float vv[NG * VW];
#pragma unroll
          for (int g = 0; g < NG; ++g)
            Vec<VW>::load(v_sh + (c + cc) * LD + tx * VW + g * 16 * VW, vv + g * VW);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = comp(pr[i], cc);
#pragma unroll
            for (int x = 0; x < NG * VW; ++x) acc[i][x] = fmaf(pc, vv[x], acc[i][x]);
          }
        }
      }
      __syncwarp();
      if (more) store(buf ^ 1);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsum = half_warp_sum(l[i]);
    const float denom = fmaxf(lsum, 1e-30f);
    const int r = ty + 16 * i;
    const int pos = q0 + r % bq;
    if (r >= rows || pos >= c_rows) continue;
    const int head = kvh * group + r / bq;
    if (POOL) {                  // this node's partial, un-normalised
      const size_t pi = ((size_t)pos * h + head) * n_nodes + node;
      float* a_row = p_acc + pi * d;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int w = 0; w < VW; ++w)
          if (tx * VW + g * 16 * VW + w < d)
            a_row[tx * VW + g * 16 * VW + w] = acc[i][g * VW + w];
      if (tx == 0) { p_m[pi] = m[i]; p_l[pi] = lsum; }
      continue;
    }
    float* o_row = out + ((size_t)pos * h + head) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int w = 0; w < VW; ++w)
        if (tx * VW + g * 16 * VW + w < d)
          o_row[tx * VW + g * 16 * VW + w] = acc[i][g * VW + w] / denom;
  }
  if (!POOL || out == nullptr) return;

  // pool form: the last of the (row tile, kv head)'s N node blocks merges
  // the N partials of each of its rows, over the idle tiles
  if (!last_of_group(tickets, blockIdx.x * gridDim.y + blockIdx.y, n_nodes)) return;
  const RowMap map{0, 0, q0, bq, c_rows, h, kvh * group,
                   (bq & (bq - 1)) == 0 ? __ffs(bq) - 1 : -1};
  merge_block<true>(p_acc, p_m, p_l, out, rows, map, n_nodes, d, tile_sh,
                    merge_warps);
}

template <typename T, bool Q, int D, bool FULL>
__global__ void __launch_bounds__(kThreads) paged_chunk_kernel(CHUNK_PARAMS) {
  chunk_body<T, Q, D, FULL, false>(CHUNK_ARGS);
}

// The pool form asks for one block a SM: held to two, the allocator
// spills the codes' instantiations at 128 registers, and a placed row's
// node blocks then share their SMs with the other nodes' exiting blocks.
template <typename T, bool Q, int D, bool FULL>
__global__ void __launch_bounds__(kThreads, 1) paged_pool_chunk_kernel(CHUNK_PARAMS) {
  chunk_body<T, Q, D, FULL, true>(CHUNK_ARGS);
}
#undef CHUNK_PARAMS
#undef CHUNK_ARGS

// ---------------------------------------------------------------------------
// launchers

// Lets `kernel` take `smem` bytes of dynamic shared memory; `granted`
// (one per kernel instantiation) remembers the largest value set so far.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t& granted) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024 || smem <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

// the most pages a pool block lists at a time (then walked in windows);
// a multiple of 64, so a window's keys are whole chunk tiles
constexpr int kListCap = 512;

// Pool form with `out`: grows a block's `smem` bytes to hold its merge's
// weights (merge_rows, the chunk form's `rows` rows of n_part <= 8: (rows
// + 1) * 32 + 3 * rows + 1 floats; else merge_partials: n_part floats a
// warp, at least one warp's).  Returns the warps that merge by
// merge_partials.
int fit_merge(size_t& smem, int n_part, int warps, int rows) {
  const size_t need = rows > 0 && n_part <= 8
                          ? sizeof(float) * (32 * ((size_t)rows + 1) + 3 * (size_t)rows + 1)
                          : sizeof(float) * (size_t)n_part;
  if (smem < need) smem = need;
  const size_t fit = smem / (sizeof(float) * (size_t)n_part);
  return fit < (size_t)warps ? (int)fit : warps;
}

template <typename T, bool Q, int NV, bool POOL>
cudaError_t decode_nv(const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* table,
                      const void* lengths, void* pacc, void* pm, void* pl,
                      void* out, void* tickets, int b, int hkv, int group,
                      int d, int pps, int page, int per, int n_split,
                      int n_nodes, int n_local, cudaStream_t stream) {
  // the group in equal parts of at most kBlockHeads heads, a block each
  const int parts = (group + kBlockHeads - 1) / kBlockHeads;
  const int heads = (group + parts - 1) / parts;
  const bool full = d == NV * 32 && parts == 1;
  auto kernel = full ? paged_decode_kernel<T, Q, NV, true, POOL>
                     : paged_decode_kernel<T, Q, NV, false, POOL>;
  // the single form's tile, so that one node computes its bits; the list
  // takes what shared memory is left (at least 24 bytes at every shape
  // kernel_takes)
  const int tile = decode_tile<T, Q, NV>(page, heads);
  size_t smem = decode_smem<T, Q, NV>(tile, heads);
  int cap = 0, mw = 0;
  if (POOL) {
    const size_t room = ((size_t)kMaxSmem - smem) / sizeof(int);
    cap = per < kListCap ? per : kListCap;
    if ((size_t)cap > room) cap = (int)room;
    if (cap < 1) return cudaErrorInvalidValue;
    smem += sizeof(int) * cap;
    if (out != nullptr) mw = fit_merge(smem, n_nodes * n_split, heads, 0);
  }
  static size_t granted[2] = {0, 0};
  cudaError_t err = allow_smem(kernel, smem, granted[full]);
  if (err != cudaSuccess) return err;
  dim3 grid(b, hkv * parts, n_nodes * n_split);
  kernel<<<grid, heads * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(pacc),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<float*>(POOL ? out : nullptr), static_cast<unsigned*>(tickets),
      pps, page, tile, hkv, group, parts, d, per, n_split, n_local, cap, mw,
      1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <typename T, bool Q, int NV, bool POOL>
cudaError_t chunk_nv(const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const void* table_row, const void* lengths,
                     void* out, void* pacc, void* pm, void* pl, void* tickets,
                     int c, int hkv, int group, int d, int pps, int page,
                     int n_nodes, int n_local, cudaStream_t stream) {
  constexpr int D = NV * 32;
  // the pool form has only the general instantiation (half its build; the
  // same arithmetic, so one node still computes the single form's bits)
  const bool full = !POOL && d == D;
  auto kernel = paged_chunk_kernel<T, Q, D, false>;
  if constexpr (POOL) kernel = paged_pool_chunk_kernel<T, Q, D, false>;
  else if (full) kernel = paged_chunk_kernel<T, Q, D, true>;
  size_t smem = Chunk<D>::kSmem;
  int cap = 0, mw = 0;
  if (POOL) {                  // the keys' positions and the list
    cap = pps < kListCap ? pps : kListCap;
    smem += sizeof(int) * (2 * Chunk<D>::KT + cap);
    if (out != nullptr) mw = fit_merge(smem, n_nodes, kThreads / 32, kRows);
  }
  static size_t granted[2] = {0, 0};
  cudaError_t err = allow_smem(kernel, smem, granted[full]);
  if (err != cudaSuccess) return err;
  const int bq = kRows / group;
  dim3 grid((c + bq - 1) / bq, hkv, n_nodes);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table_row),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(pacc), static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<unsigned*>(tickets), c, pps, page, hkv, group, bq, d, n_nodes,
      n_local, cap, mw, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

// the rule of kernel_takes (kernels/paged_attention.py), and the grid's
bool bad_shape(int b, int h, int hkv, int d, int pps, int page) {
  return hkv <= 0 || h < hkv || h % hkv || h / hkv > kMaxGroup || d % 8 || d < 8 ||
         d > 256 || page < 1 || page > kMaxPage || pps < 1 || b < 1 ||
         hkv > 65535 / 2;
}

// the most partials a row the combine takes: its weights in shared memory
constexpr int kMaxCombine = kMaxSmem / (int)(sizeof(float) * 4);

bool bad_pool(int n_nodes, int n_local) {
  return n_nodes < 1 || n_local < 1 || n_nodes > 65535 ||
         (long)n_nodes * n_local > INT_MAX;
}

// Pool form with `out`: tickets for `groups` groups are given
bool bad_tickets(const void* out, const void* tickets, int n_tickets, long groups) {
  return out != nullptr && (tickets == nullptr || (long)n_tickets < groups);
}

int combine(const void* pacc, const void* pm, const void* pl, void* out,
            int rows, int n_split, int d, void* stream) {
  if (rows < 1 || n_split < 1 || n_split > kMaxCombine || d < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kCombineWarps * n_split;
  static size_t granted = 0;
  cudaError_t err = allow_smem(paged_combine_kernel, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int grid = (rows + kCombineWarps - 1) / kCombineWarps;
  paged_combine_kernel<<<grid, kCombineWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pacc), static_cast<const float*>(pm),
      static_cast<const float*>(pl), static_cast<float*>(out), rows, n_split, d);
  return (int)cudaGetLastError();
}

// Decode form.  Single device (POOL = false): the split partials, then,
// with `out`, paged_combine_f32's kernel merges them into it.  Pool: the
// kernel's last block of each group merges them into `out` when given.
template <typename T, bool Q, bool POOL>
int decode(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths, void* pacc,
           void* pm, void* pl, void* out, void* tickets, int b, int h, int hkv,
           int d, int pps, int page, int per, int n_split, int n_nodes,
           int n_local, int n_tickets, void* stream) {
  const int group = hkv > 0 ? h / hkv : 0;
  const long parts = (group + kBlockHeads - 1) / kBlockHeads;
  if (bad_shape(b, h, hkv, d, pps, page) || bad_pool(n_nodes, n_local) ||
      per < 1 || n_split < 1 || (long)n_nodes * n_split > 65535 ||
      (long)per * n_split < pps ||
      (out != nullptr && (long)n_nodes * n_split > kMaxCombine) ||
      (POOL && bad_tickets(out, tickets, n_tickets, (long)b * hkv * parts)))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((d + 31) / 32) {
#define CASE(NV) \
    case NV: err = decode_nv<T, Q, NV, POOL>(q, k, v, ks, vs, table, lengths,   \
                                             pacc, pm, pl, out, tickets, b, hkv, \
                                             group, d, pps, page, per, n_split,  \
                                             n_nodes, n_local, st);              \
      break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  if (POOL || err != cudaSuccess || out == nullptr) return (int)err;
  return combine(pacc, pm, pl, out, b * h, n_split, d, stream);
}

// Chunk form.  Single device (POOL = false): writes `out`.  Pool: each
// node's partial into `pacc`, merged into `out` by the kernel's last node
// block of each (row tile, kv head) when `out` is given.
template <typename T, bool Q, bool POOL>
int chunk(const void* q, const void* k, const void* v, const void* ks,
          const void* vs, const void* table_row, const void* lengths, void* pacc,
          void* pm, void* pl, void* out, void* tickets, int c, int h, int hkv,
          int d, int pps, int page, int n_nodes, int n_local, int n_tickets,
          void* stream) {
  const int group = hkv > 0 ? h / hkv : 0;
  if (bad_shape(c, h, hkv, d, pps, page) || bad_pool(n_nodes, n_local) ||
      n_nodes > kMaxCombine || (!POOL && (out == nullptr || n_nodes != 1)) ||
      (POOL && (pacc == nullptr || pm == nullptr || pl == nullptr ||
                bad_tickets(out, tickets, n_tickets,
                            (long)((c + kRows / group - 1) / (kRows / group)) * hkv))))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((d + 31) / 32) {
#define CASE(NV)                                                                  \
    case NV: err = chunk_nv<T, Q, NV, POOL>(q, k, v, ks, vs, table_row, lengths,  \
                                            out, pacc, pm, pl, tickets, c, hkv,   \
                                            group, d, pps, page, n_nodes,         \
                                            n_local, st);                         \
      break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take.
//
// Decode form: writes the split partials; with `out` given it then
// launches paged_combine_f32's kernel, which merges them into `out`.

#define DECODE(NAME, T, Q)                                                     \
  int NAME(const void* q, const void* k_pages, const void* v_pages,            \
           const void* k_scale, const void* v_scale, const void* page_table,   \
           const void* lengths, void* p_acc, void* p_m, void* p_l, void* out,  \
           int b, int h, int hkv, int d, int pps, int page, int per,           \
           int n_split, void* stream) {                                        \
    return decode<T, Q, false>(q, k_pages, v_pages, k_scale, v_scale,          \
                               page_table, lengths, p_acc, p_m, p_l, out,      \
                               nullptr, b, h, hkv, d, pps, page, per, n_split, \
                               1, INT_MAX, 0, stream);                         \
  }
#ifdef PAGED_BF16
DECODE(paged_decode_bf16, __nv_bfloat16, false)
#else
DECODE(paged_decode_f32, float, false)
DECODE(paged_decode_q8_int8, int8_t, true)
DECODE(paged_decode_q8_fp8, __nv_fp8_e4m3, true)
#endif
#undef DECODE

// Pool decode form: n_nodes windows of n_local pages; the partials are
// [B, H, n_nodes * n_split] (node-major), merged into `out` when given by
// the launch itself (tickets: n_tickets >= B * Hkv * ceil(G / 32) zeroed
// uint32, left zeroed).
#define POOL_DECODE(NAME, T, Q)                                                \
  int NAME(const void* q, const void* k_pages, const void* v_pages,            \
           const void* k_scale, const void* v_scale, const void* page_table,   \
           const void* lengths, void* p_acc, void* p_m, void* p_l, void* out,  \
           void* tickets, int b, int h, int hkv, int d, int pps, int page,     \
           int per, int n_split, int n_nodes, int n_local, int n_tickets,      \
           void* stream) {                                                     \
    return decode<T, Q, true>(q, k_pages, v_pages, k_scale, v_scale,           \
                              page_table, lengths, p_acc, p_m, p_l, out,       \
                              tickets, b, h, hkv, d, pps, page, per, n_split,  \
                              n_nodes, n_local, n_tickets, stream);            \
  }
#ifdef PAGED_BF16
POOL_DECODE(paged_pool_decode_bf16, __nv_bfloat16, false)
#else
POOL_DECODE(paged_pool_decode_f32, float, false)
POOL_DECODE(paged_pool_decode_q8_int8, int8_t, true)
POOL_DECODE(paged_pool_decode_q8_fp8, __nv_fp8_e4m3, true)
#endif
#undef POOL_DECODE

// Chunk form: table_row is the one [pps] row every query row shares.
#define CHUNK(NAME, T, Q)                                                      \
  int NAME(const void* q, const void* k_pages, const void* v_pages,            \
           const void* k_scale, const void* v_scale, const void* table_row,    \
           const void* lengths, void* out, int c, int h, int hkv, int d,       \
           int pps, int page, void* stream) {                                  \
    return chunk<T, Q, false>(q, k_pages, v_pages, k_scale, v_scale,           \
                              table_row, lengths, nullptr, nullptr, nullptr,   \
                              out, nullptr, c, h, hkv, d, pps, page, 1,        \
                              INT_MAX, 0, stream);                             \
  }
#ifdef PAGED_BF16
CHUNK(paged_chunk_bf16, __nv_bfloat16, false)
#else
CHUNK(paged_chunk_f32, float, false)
CHUNK(paged_chunk_q8_int8, int8_t, true)
CHUNK(paged_chunk_q8_fp8, __nv_fp8_e4m3, true)
#endif
#undef CHUNK

// Pool chunk form: each node's partial into p_acc [C, H, n_nodes, d], p_m,
// p_l [C, H, n_nodes]; merged into `out` [C, H, d] when given by the launch
// itself (tickets: n_tickets >= ceil(C / (64 / G)) * Hkv zeroed uint32).
#define POOL_CHUNK(NAME, T, Q)                                                 \
  int NAME(const void* q, const void* k_pages, const void* v_pages,            \
           const void* k_scale, const void* v_scale, const void* table_row,    \
           const void* lengths, void* p_acc, void* p_m, void* p_l, void* out,  \
           void* tickets, int c, int h, int hkv, int d, int pps, int page,     \
           int n_nodes, int n_local, int n_tickets, void* stream) {            \
    return chunk<T, Q, true>(q, k_pages, v_pages, k_scale, v_scale,            \
                             table_row, lengths, p_acc, p_m, p_l, out,         \
                             tickets, c, h, hkv, d, pps, page, n_nodes,        \
                             n_local, n_tickets, stream);                      \
  }
#ifdef PAGED_BF16
POOL_CHUNK(paged_pool_chunk_bf16, __nv_bfloat16, false)
#else
POOL_CHUNK(paged_pool_chunk_f32, float, false)
POOL_CHUNK(paged_pool_chunk_q8_int8, int8_t, true)
POOL_CHUNK(paged_pool_chunk_q8_fp8, __nv_fp8_e4m3, true)
#endif
#undef POOL_CHUNK

#ifndef PAGED_BF16
int paged_combine_f32(const void* p_acc, const void* p_m, const void* p_l,
                      void* out, int rows, int n_split, int d, void* stream) {
  return combine(p_acc, p_m, p_l, out, rows, n_split, d, stream);
}
#endif

}  // extern "C"
