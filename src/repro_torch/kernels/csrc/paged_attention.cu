// Paged GQA attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernels in
// repro/kernels/paged_attention.py:
//   * _paged_kernel (:39)     -> paged_decode_f32, paged_chunk_f32
//   * _paged_q8_kernel (:77)  -> paged_decode_q8_{int8,fp8},
//                                paged_chunk_q8_{int8,fp8}
// plus paged_combine_f32, the merge of the decode form's split partials,
// and the pool form of both (paged_pool_decode_*, paged_pool_chunk_*).
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
// [s * n_local, (s + 1) * n_local).  A node dimension joins the grid; node
// s's blocks skip every page whose physical id lies outside its window,
// as they skip the pages past a row's length, and write its partials at
// node offset s of one workspace: the decode form's S splits of node s at
// split s * S + split of acc [B, H, N * S, d], the chunk form's one
// partial a node at acc [C, H, N, d] (m, l beside them, a node that owns
// nothing writes (0, -1e30, 0)).  paged_combine_f32 then merges all N * S
// (or N) partials of a row in one launch.  The single-device decode form
// is the same kernel at one node whose window holds every page (n_local
// = INT_MAX); the single-device chunk form is its instantiation without
// the window test (POOL = false), the same arithmetic.  So the pool form
// at N = 1 computes their bits: the decode form is the same launch, and
// the chunk form's partial is merged by a combine of one split, which
// computes acc * 1 / max(l * 1, 1e-30), the chunk form's own
// acc / max(l, 1e-30).
//
// Head dims: any multiple of 8 from 8 to 256 (kernel_takes in
// kernels/paged_attention.py).  Both forms are instantiated at D = 32*NV,
// NV = ceil(d / 32) in 1..8; the columns d..D-1 of every staged row (and
// of q) are zero, so they add nothing to a dot, and only the d real
// columns are read and written.  A row of codes whose d bytes are not a
// multiple of 16 (int8/fp8 at d = 8 mod 16) is copied in 8-byte pieces.
//
// Layouts (row-major): q/out [B, H, d] f32; k/v pages [P, page, Hkv, d]
// of T, 16-byte aligned (8 for such rows of codes); scales [P, page, Hkv]
// f32; page_table [B, pps] int32 (the chunk form reads one row); lengths
// [B] int32; partials acc [B, H, S, d], m/l [B, H, S] f32.  page <=
// kMaxPage, G <= kMaxGroup.  Page ids named below ceil(length/page) must
// lie in [0, P); entries past it are never read.

#include <climits>
#include <cmath>

#include <cuda_runtime.h>
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

// Block (b, kv head * parts + part, split): `heads` warps, the query heads
// part * heads .. of the kv head's group (a warp past the group idles but
// helps stage the tiles).  d: the head dim, D = 32 * NV >= d.  FULL:
// d == D and one part (the instantiation every configuration's full
// width takes: constants where the general one has runtime values).
template <typename T, bool Q, int NV, bool FULL>
__global__ void __launch_bounds__(kBlockHeads * 32)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ p_acc,
                    float* __restrict__ p_m, float* __restrict__ p_l, int pps,
                    int page, int tile, int hkv, int group, int parts, int d_,
                    int per, int splits, int n_local, float sm_scale) {
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

  const int b = blockIdx.x;
  // pool form: node `node` of the grid's z, its window of physical pages
  // [base, base + n_local)
  const int node = blockIdx.z / splits, split = blockIdx.z - node * splits;
  const int base = node * n_local;
  auto owned = [&](int phys) { return (unsigned)(phys - base) < (unsigned)n_local; };
  const int kvh = FULL ? blockIdx.y : blockIdx.y / parts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = hkv * group;
  const int gh = FULL ? warp : (blockIdx.y - kvh * parts) * heads + warp;   // head in the group
  const bool active = FULL || gh < group;
  const int head = kvh * group + (active ? gh : 0);
  const int length = lengths[b];
  int n_pages = (length + page - 1) / page;
  n_pages = n_pages < pps ? n_pages : pps;
  const int p0 = split * per;
  const int p1 = p0 + per < n_pages ? p0 + per : n_pages;
  const int tpp = (page + tile - 1) / tile;   // tiles a page
  // this split's tiles (none past the row's length): tpp a page, fewer
  // on its last page where the length cuts it
  const int n = p1 <= p0 ? 0
                         : (p1 - 1 - p0) * tpp +
                               (min(length - (p1 - 1) * page, page) + tile - 1) / tile;
  const size_t row = (size_t)b * h + head;
  const size_t ps = row * gridDim.z + blockIdx.z;   // this (node, split)'s partial

  if (n <= 0) {                           // past the row's length: (0, -inf, 0)
    if (!active) return;
    for (int c = lane; c < d; c += 32) p_acc[ps * d + c] = 0.f;
    if (lane == 0) { p_m[ps] = kNegInf; p_l[ps] = 0.f; }
    return;
  }

  // a staged row holds the d real columns; the rest of its CH chunks stay
  // zero (set once here: the copies never write them)
  const int rb = d * (int)sizeof(T);
  const bool narrow = rb % 16 != 0;      // codes at d = 8 mod 16: 8-byte copies
  const int n_units = narrow ? rb / 8 : rb / 16;
  if (rb < CH * 16) {
    const int pad = CH * 16 - rb;        // a multiple of 8
    for (int e = threadIdx.x; e < kStages * 2 * tile * (pad / 8); e += blockDim.x) {
      const int r = e / (pad / 8), o = e % (pad / 8);
      const int s_ = r / (2 * tile), rr = r % (2 * tile);
      *reinterpret_cast<uint2*>(ring_sh + s_ * slot_b + rr * RB + rb + o * 8) =
          make_uint2(0u, 0u);
    }
  }

  const size_t tok_stride = (size_t)hkv * d;
  const int* tab = page_table + (size_t)b * pps + p0;
  // tile j: its page within the split, its first token in that page and
  // its tokens below the length (no division where a tile is a page)
  auto locate = [&](int j, int& pg, int& t0) {
    pg = tpp == 1 ? j : j / tpp;
    t0 = tpp == 1 ? 0 : (j - pg * tpp) * tile;
    const int rest = length - (p0 + pg) * page - t0;
    const int in_page = page - t0 < tile ? page - t0 : tile;
    return rest < in_page ? rest : in_page;
  };
  auto issue = [&](int j) {      // tile j of the split into slot j % kStages
    unsigned char* slot = ring_sh + (j % kStages) * slot_b;
    int pg, t0;
    const int nv = locate(j, pg, t0);
    if (!owned(tab[pg])) return;         // another node's page: never read
    const size_t slot0 = (size_t)tab[pg] * page + t0;
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
  for (int c = lane; c < D; c += 32) q_sh[warp * D + c] = c < d ? q[row * d + c] : 0.f;

  // scores: `sub` lanes share a token's dot (chunks split between them)
  int sub = 1;
  while (2 * sub * tile <= 32 && CH % (2 * sub) == 0) sub *= 2;
  const int span = sub > 1 ? tile : 32;   // tokens scored in one pass
  const int part = lane / span, tok = lane % span;
  const int c0 = part * (CH / sub), c1 = c0 + CH / sub;
  const bool scorer = part < sub;
  const float* qw = q_sh + warp * D;
  float* pw = p_sh + warp * tile;

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;             // l: this lane's tokens; summed at the end

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();         // tile j has landed (this thread's part)
    __syncthreads();                      // ... everyone's; slot j-1 is free
    if (j + kStages - 1 < n) issue(j + kStages - 1);
    cp_async_commit();
    if (!active) continue;                // the warp only helps stage tiles

    const unsigned char* slot = ring_sh + (j % kStages) * slot_b;
    const float* sc = reinterpret_cast<const float*>(slot + 2 * tile * RB);
    int pg, t0;
    const int nv = locate(j, pg, t0);
    if (!owned(tab[pg])) continue;       // not staged; no weight

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
    __syncwarp();                         // pw is rewritten by the next tile
  }
  cp_async_wait<0>();
  if (!active) return;

  l = warp_sum(l);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < d) p_acc[ps * d + lane + 32 * i] = acc[i];
  if (lane == 0) { p_m[ps] = m; p_l[ps] = l; }
}

// Max-rebase merge of S splits, one warp per (b, head):
// m* = max m_s, l = sum l_s e^(m_s - m*), out = sum acc_s e^(m_s - m*) / max(l, 1e-30).
// The splits' m and l are read in one round trip (a lane per split), the
// weights go through shared memory, and each lane's acc loads are issued
// kUnroll splits at a time so their latencies overlap.
constexpr int kCombineWarps = 4;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kCombineWarps * 32)
paged_combine_kernel(const float* __restrict__ p_acc, const float* __restrict__ p_m,
                     const float* __restrict__ p_l, float* __restrict__ out,
                     int rows, int n_split, int d) {
  extern __shared__ float w_sh[];          // [kCombineWarps][S] weights
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kCombineWarps + warp;
  if (row >= rows) return;
  float* w = w_sh + warp * n_split;
  const float* m = p_m + (size_t)row * n_split;
  const float* l = p_l + (size_t)row * n_split;
  float mx = kNegInf;
  for (int s = lane; s < n_split; s += 32) {
    w[s] = m[s];
    mx = fmaxf(mx, w[s]);
  }
  mx = warp_max(mx);
  float lsum = 0.f;
  for (int s = lane; s < n_split; s += 32) {
    const float e = expf(w[s] - mx);
    w[s] = e;
    lsum += l[s] * e;
  }
  const float denom = fmaxf(warp_sum(lsum), 1e-30f);
  __syncwarp();
  const float* a = p_acc + (size_t)row * n_split * d;
  for (int c = lane; c < d; c += 32) {
    float x = 0.f;
    int s = 0;
    for (; s + kUnroll <= n_split; s += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(a + (size_t)(s + u) * d + c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x = fmaf(v[u], w[s + u], x);
    }
    for (; s < n_split; ++s) x = fmaf(__ldg(a + (size_t)s * d + c), w[s], x);
    out[(size_t)row * d + c] = x / denom;
  }
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
  for (int e = 0; e < 16; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(elem<T>(raw, e), elem<T>(raw, e + 1), elem<T>(raw, e + 2),
                    elem<T>(raw, e + 3));
}

// POOL: the pool form (a window test on every key, partials out); the
// single-device form compiles without the test.
template <typename T, bool Q, int D, bool FULL, bool POOL>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table_row,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   float* __restrict__ p_acc, float* __restrict__ p_m,
                   float* __restrict__ p_l, int c_rows, int pps, int page,
                   int hkv, int group, int bq, int d_, int n_local,
                   float sm_scale) {
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

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;     // longest rows first
  // pool form: node blockIdx.z owns the physical pages [base, base + n_local)
  const int base = POOL ? blockIdx.z * n_local : 0;
  auto owned = [&](int phys) {
    return !POOL || (unsigned)(phys - base) < (unsigned)n_local;
  };
  const int h = hkv * group;
  const int rows = group * bq;
  const size_t tok_stride = (size_t)hkv * d;
  // chunks of a row holding real columns (the rest are staged as zeros)
  const int ch_real = (d + kVec - 1) / kVec;
  const bool narrow = d % kVec != 0;

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
  const int n_tiles = (kmax + KT - 1) / KT;

  uint4 kr[NL], vr[NL];
  float ksr = 0.f, vsr = 0.f;
  auto load = [&](int it) {      // tile it's codes into registers (0 past kmax)
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int e = tid + j * kThreads;
      const int c = e / CH, ch = e % CH;
      const int pos = it * KT + c;
      kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      const int phys = e < KT * CH && pos < kmax ? table_row[pos / page] : base;
      if (e < KT * CH && pos < kmax && ch < ch_real && owned(phys)) {
        const size_t g = ((size_t)phys * page + pos % page) * tok_stride +
                         (size_t)kvh * d;
        kr[j] = load_chunk(k_pages + g, ch, d, narrow);
        vr[j] = load_chunk(v_pages + g, ch, d, narrow);
      }
    }
    if (Q && tid < KT) {
      const int pos = it * KT + tid;
      ksr = vsr = 0.f;
      if (pos < kmax && owned(table_row[pos / page])) {
        const size_t g = ((size_t)table_row[pos / page] * page + pos % page) * hkv + kvh;
        ksr = __ldg(k_scale + g);
        vsr = __ldg(v_scale + g);
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
  };

  if (n_tiles > 0) {
    load(0);
    store(0);
  }
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

    // online softmax: the 16 lanes of a row hold the tile's keys; a key
    // on another node's page carries no weight
    bool own[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int kp = k0 + tx + 16 * j;
      own[j] = !POOL || (kp < kmax && owned(table_row[kp / page]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool keep[KJ];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int col = tx + 16 * j;
        keep[j] = own[j] && k0 + col < len[i];
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

    for (int c = 0; c < KT; c += 4) {     // past kmax: p = 0, v = 0
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsum = half_warp_sum(l[i]);
    const float denom = fmaxf(lsum, 1e-30f);
    const int r = ty + 16 * i;
    const int pos = q0 + r % bq;
    if (r >= rows || pos >= c_rows) continue;
    const int head = kvh * group + r / bq;
    if (POOL) {                  // this node's partial, un-normalised
      const size_t pi = ((size_t)pos * h + head) * gridDim.z + blockIdx.z;
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
}

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

template <typename T, bool Q, int NV>
cudaError_t decode_nv(const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* table,
                      const void* lengths, void* pacc, void* pm, void* pl,
                      int b, int hkv, int group, int d, int pps, int page,
                      int per, int n_split, int n_nodes, int n_local,
                      cudaStream_t stream) {
  // the group in equal parts of at most kBlockHeads heads, a block each
  const int parts = (group + kBlockHeads - 1) / kBlockHeads;
  const int heads = (group + parts - 1) / parts;
  const bool full = d == NV * 32 && parts == 1;
  auto kernel = full ? paged_decode_kernel<T, Q, NV, true>
                     : paged_decode_kernel<T, Q, NV, false>;
  const int tile = decode_tile<T, Q, NV>(page, heads);
  const size_t smem = decode_smem<T, Q, NV>(tile, heads);
  static size_t granted[2] = {0, 0};
  cudaError_t err = allow_smem(kernel, smem, granted[full]);
  if (err != cudaSuccess) return err;
  dim3 grid(b, hkv * parts, n_nodes * n_split);
  kernel<<<grid, heads * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(pacc),
      static_cast<float*>(pm), static_cast<float*>(pl), pps, page, tile, hkv,
      group, parts, d, per, n_split, n_local, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <typename T, bool Q, int NV>
cudaError_t chunk_nv(const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const void* table_row, const void* lengths,
                     void* out, void* pacc, void* pm, void* pl, int c, int hkv,
                     int group, int d, int pps, int page, int n_nodes,
                     int n_local, cudaStream_t stream) {
  constexpr int D = NV * 32;
  const bool pool = pacc != nullptr;
  auto kernel = d == D ? (pool ? paged_chunk_kernel<T, Q, D, true, true>
                               : paged_chunk_kernel<T, Q, D, true, false>)
                       : (pool ? paged_chunk_kernel<T, Q, D, false, true>
                               : paged_chunk_kernel<T, Q, D, false, false>);
  const size_t smem = Chunk<D>::kSmem;
  static size_t granted[4] = {0, 0, 0, 0};
  cudaError_t err = allow_smem(kernel, smem, granted[2 * (d == D) + pool]);
  if (err != cudaSuccess) return err;
  const int bq = kRows / group;
  dim3 grid((c + bq - 1) / bq, hkv, n_nodes);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table_row),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(pacc), static_cast<float*>(pm), static_cast<float*>(pl),
      c, pps, page, hkv, group, bq, d, n_local, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

// the rule of kernel_takes (kernels/paged_attention.py), and the grid's
bool bad_shape(int b, int h, int hkv, int d, int pps, int page) {
  return hkv <= 0 || h % hkv || h / hkv > kMaxGroup || d % 8 || d < 8 ||
         d > 256 || page < 1 || page > kMaxPage || pps < 1 || b < 1 ||
         hkv > 65535 / 2;
}

// the most partials a row the combine takes: its weights in shared memory
constexpr int kMaxCombine = kMaxSmem / (int)(sizeof(float) * 4);

bool bad_pool(int n_nodes, int n_local) {
  return n_nodes < 1 || n_local < 1 || n_nodes > 65535 ||
         (long)n_nodes * n_local > INT_MAX;
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

template <typename T, bool Q>
int decode(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths, void* pacc,
           void* pm, void* pl, void* out, int b, int h, int hkv, int d,
           int pps, int page, int per, int n_split, int n_nodes, int n_local,
           void* stream) {
  if (bad_shape(b, h, hkv, d, pps, page) || bad_pool(n_nodes, n_local) ||
      per < 1 || n_split < 1 || (long)n_nodes * n_split > 65535 ||
      (long)per * n_split < pps ||
      (out != nullptr && (long)n_nodes * n_split > kMaxCombine))
    return (int)cudaErrorInvalidValue;
  const int group = h / hkv;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((d + 31) / 32) {
#define CASE(NV) \
    case NV: err = decode_nv<T, Q, NV>(q, k, v, ks, vs, table, lengths, pacc, \
                                       pm, pl, b, hkv, group, d, pps, page,   \
                                       per, n_split, n_nodes, n_local, st);   \
      break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  if (err != cudaSuccess || out == nullptr) return (int)err;
  return combine(pacc, pm, pl, out, b * h, n_nodes * n_split, d, stream);
}

// With `pacc` given (the pool form) the kernel writes each node's partial
// there and the combine merges them into `out`; else it writes `out`.
template <typename T, bool Q>
int chunk(const void* q, const void* k, const void* v, const void* ks,
          const void* vs, const void* table_row, const void* lengths, void* pacc,
          void* pm, void* pl, void* out, int c, int h, int hkv, int d, int pps,
          int page, int n_nodes, int n_local, void* stream) {
  if (bad_shape(c, h, hkv, d, pps, page) || bad_pool(n_nodes, n_local) ||
      n_nodes > kMaxCombine || (pacc == nullptr && n_nodes != 1))
    return (int)cudaErrorInvalidValue;
  const int group = h / hkv;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((d + 31) / 32) {
#define CASE(NV)                                                                 \
    case NV: err = chunk_nv<T, Q, NV>(q, k, v, ks, vs, table_row, lengths,       \
                                      pacc == nullptr ? out : nullptr, pacc, pm, \
                                      pl, c, hkv, group, d, pps, page, n_nodes,  \
                                      n_local, st);                              \
      break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  if (err != cudaSuccess || pacc == nullptr) return (int)err;
  return combine(pacc, pm, pl, out, c * h, n_nodes, d, stream);
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
    return decode<T, Q>(q, k_pages, v_pages, k_scale, v_scale, page_table,     \
                        lengths, p_acc, p_m, p_l, out, b, h, hkv, d, pps, page, \
                        per, n_split, 1, INT_MAX, stream);                     \
  }
DECODE(paged_decode_f32, float, false)
DECODE(paged_decode_q8_int8, int8_t, true)
DECODE(paged_decode_q8_fp8, __nv_fp8_e4m3, true)
#undef DECODE

// Pool decode form: n_nodes windows of n_local pages; the partials are
// [B, H, n_nodes * n_split] (node-major), merged into `out` when given.
#define POOL_DECODE(NAME, T, Q)                                                \
  int NAME(const void* q, const void* k_pages, const void* v_pages,            \
           const void* k_scale, const void* v_scale, const void* page_table,   \
           const void* lengths, void* p_acc, void* p_m, void* p_l, void* out,  \
           int b, int h, int hkv, int d, int pps, int page, int per,           \
           int n_split, int n_nodes, int n_local, void* stream) {              \
    return decode<T, Q>(q, k_pages, v_pages, k_scale, v_scale, page_table,     \
                        lengths, p_acc, p_m, p_l, out, b, h, hkv, d, pps, page, \
                        per, n_split, n_nodes, n_local, stream);               \
  }
POOL_DECODE(paged_pool_decode_f32, float, false)
POOL_DECODE(paged_pool_decode_q8_int8, int8_t, true)
POOL_DECODE(paged_pool_decode_q8_fp8, __nv_fp8_e4m3, true)
#undef POOL_DECODE

// Chunk form: table_row is the one [pps] row every query row shares.
#define CHUNK(NAME, T, Q)                                                      \
  int NAME(const void* q, const void* k_pages, const void* v_pages,            \
           const void* k_scale, const void* v_scale, const void* table_row,    \
           const void* lengths, void* out, int c, int h, int hkv, int d,       \
           int pps, int page, void* stream) {                                  \
    return chunk<T, Q>(q, k_pages, v_pages, k_scale, v_scale, table_row,       \
                       lengths, nullptr, nullptr, nullptr, out, c, h, hkv, d,  \
                       pps, page, 1, INT_MAX, stream);                         \
  }
CHUNK(paged_chunk_f32, float, false)
CHUNK(paged_chunk_q8_int8, int8_t, true)
CHUNK(paged_chunk_q8_fp8, __nv_fp8_e4m3, true)
#undef CHUNK

// Pool chunk form: each node's partial into p_acc [C, H, n_nodes, d], p_m,
// p_l [C, H, n_nodes], then the combine merges them into `out` [C, H, d].
#define POOL_CHUNK(NAME, T, Q)                                                 \
  int NAME(const void* q, const void* k_pages, const void* v_pages,            \
           const void* k_scale, const void* v_scale, const void* table_row,    \
           const void* lengths, void* p_acc, void* p_m, void* p_l, void* out,  \
           int c, int h, int hkv, int d, int pps, int page, int n_nodes,       \
           int n_local, void* stream) {                                        \
    if (p_acc == nullptr || p_m == nullptr || p_l == nullptr || out == nullptr) \
      return (int)cudaErrorInvalidValue;                                       \
    return chunk<T, Q>(q, k_pages, v_pages, k_scale, v_scale, table_row,       \
                       lengths, p_acc, p_m, p_l, out, c, h, hkv, d, pps, page, \
                       n_nodes, n_local, stream);                              \
  }
POOL_CHUNK(paged_pool_chunk_f32, float, false)
POOL_CHUNK(paged_pool_chunk_q8_int8, int8_t, true)
POOL_CHUNK(paged_pool_chunk_q8_fp8, __nv_fp8_e4m3, true)
#undef POOL_CHUNK

int paged_combine_f32(const void* p_acc, const void* p_m, const void* p_l,
                      void* out, int rows, int n_split, int d, void* stream) {
  return combine(p_acc, p_m, p_l, out, rows, n_split, d, stream);
}

}  // extern "C"
