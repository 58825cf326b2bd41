// Embedding bag and batched row gather for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernels in
// repro/kernels/embed_agg.py:
//   * _embed_kernel (:23)  -> embed_agg: out[b] = sum over l = 0..L-1, in
//     lookup order from 0, of w[b, l] * table[idx[b, l]] (each code
//     widened to f32, which is exact but for int32 codes past 2^24, which
//     round as the plain version rounds them; the product rounded before
//     its add; unweighted: the rows themselves), [B, D] f32.  Tables of
//     f32, bf16, f16, fp8 e4m3 / e5m2, int8, uint8, int16 or int32 codes;
//     f32 weights (the wrapper widens other dtypes).
//   * _gather_kernel (:94) -> embed_gather: out[b, k] = table[idx[b, k]],
//     [B, K, D]: a copy of the row's bytes, blind to the dtype, which is
//     kept.
// The order of the bag's adds is the contract: __fmul_rn / __fadd_rn, so
// nvcc cannot contract them into an FMA and the result equals the plain
// version (kernels/ref.py) bit for bit.
//
// Bound on this card: memory bytes (each distinct looked-up row once, the
// ids, the weights and the output), and below the launch and two
// dependent trips to memory, an id and then its row (the floors that
// chip_smoke.py measures).  Between the two, a bag's time goes in moving
// every lookup's row through L2 and L1, repeats of a hot row included
// (scripts/embed_sweep.py: Zipf bags beat uniform ones of the same size,
// and rows past L1 are slower).  The split is kernels/ref.py:embed_plan,
// which the wrapper passes here and the CPU emulations follow:
//   * a row is cut in pieces of `vec` bytes (16 where the row bytes, the
//     table's base and its row stride allow it, else 8, 4, 2 or 1), read
//     on the read-only path; a group of `lanes` lanes (8, 16 or 32, one
//     piece a lane) takes a bag, 32 / lanes bags a warp; a row of more
//     than 32 pieces is cut in column slices of 32 pieces, a group each;
//   * a bag's lookups go in stages of 8 rows: lane j < 8 of the group
//     loads the id and weight of row j (one coalesced load), which every
//     lane takes by __shfl_sync; each stage issues all its row loads
//     before the first add, and the next stage's rows and the ids of the
//     stage after go out before this stage's adds, so a bag of up to 16
//     lookups costs two dependent trips (ids, rows), not one a row;
//   * the gather: a group a (row, slice); its lane 0 reads the id and
//     shuffles it to the group, which copies the row's pieces.
// Ids are checked in [0, V) by the wrapper before launch.
//
// Beside them, two floors for the timing (chip_smoke.py), never on the
// serving path: an empty kernel on the same grid, and a probe of the
// dependent pair (each group loads its first id, then a 16-byte piece of
// that row).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStage = 8;          // rows a stage (ref.EMBED_STAGE_ROWS)
constexpr int kSlice = 32;         // pieces a slice (ref.EMBED_SLICE_PIECES)
constexpr int kThreads = 128;      // threads a block (ref.EMBED_BLOCK_THREADS)
// blocks an SM the bag kernel must fit (at most 128 registers a thread):
// 16 warps an SM hold the 2048 bags of 32 lanes of the smoke bag at once
constexpr int kMinBlocks = 4;

// table codes, in the order of kernels/embed_agg.py:AGG_DTYPES
enum Code { F32, BF16, F16, E4M3, E5M2, I8, U8, I16, I32 };

// a code's storage and its widening to f32
template <int C> struct Elem;
template <> struct Elem<F32> {
  using T = uint32_t;
  static __device__ __forceinline__ float widen(T u) { return __uint_as_float(u); }
};
template <> struct Elem<BF16> {
  using T = uint16_t;
  static __device__ __forceinline__ float widen(T u) {
    return __uint_as_float(static_cast<uint32_t>(u) << 16);
  }
};
template <> struct Elem<F16> {
  using T = uint16_t;
  static __device__ __forceinline__ float widen(T u) {
    return __half2float(__ushort_as_half(u));
  }
};
template <> struct Elem<E4M3> {
  using T = uint8_t;
  static __device__ __forceinline__ float widen(T u) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(u, __NV_E4M3)));
  }
};
template <> struct Elem<E5M2> {    // e5m2 is the high byte of an f16
  using T = uint8_t;
  static __device__ __forceinline__ float widen(T u) {
    return __half2float(__ushort_as_half(static_cast<uint16_t>(u << 8)));
  }
};
template <> struct Elem<I8> {
  using T = uint8_t;
  static __device__ __forceinline__ float widen(T u) {
    return static_cast<float>(static_cast<int8_t>(u));
  }
};
template <> struct Elem<U8> {
  using T = uint8_t;
  static __device__ __forceinline__ float widen(T u) { return static_cast<float>(u); }
};
template <> struct Elem<I16> {
  using T = uint16_t;
  static __device__ __forceinline__ float widen(T u) {
    return static_cast<float>(static_cast<int16_t>(u));
  }
};
template <> struct Elem<I32> {
  using T = uint32_t;
  static __device__ __forceinline__ float widen(T u) {
    return __int2float_rn(static_cast<int>(u));
  }
};

// the load type of a piece of VB bytes
template <int VB> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<1> { using T = uint8_t; };

template <int C, int VB>
union Piece {
  typename Vec<VB>::T raw;
  typename Elem<C>::T code[VB / sizeof(typename Elem<C>::T)];
};

// the mask of this thread's group of `lanes` lanes in its warp
__device__ __forceinline__ unsigned group_mask(int lanes) {
  return lanes == 32 ? 0xffffffffu
                     : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
}

// One bag's walk: a stage's ids and weights, its rows, its adds.
template <int C, int VB, bool W>
struct Bag {
  using P = Piece<C, VB>;
  static constexpr int N = VB / sizeof(typename Elem<C>::T);   // codes a piece

  // a stage's rows in registers and their weights
  struct Stage {
    P r[kStage];
    float w[kStage];
  };

  const int* ids;
  const float* ws;                 // the bag's weights (W)
  const uint8_t* col;              // this lane's piece of row 0
  long long ld;                    // row stride, bytes
  int n_look, lane, lanes;
  unsigned mask;
  bool live;                       // the lane holds a piece of the row
  float acc[N];

  // lane j < kStage: the id and weight of row l + j
  __device__ __forceinline__ void fetch_ids(int l, int& id, float& wt) const {
    id = 0;
    wt = 1.f;
    if (lane < kStage && l + lane < n_look) {
      id = __ldg(ids + l + lane);
      if constexpr (W) wt = __ldg(ws + l + lane);
    }
  }

  // every row load of the stage at l, before any add
  __device__ __forceinline__ void fetch_rows(int l, int id, float wt,
                                             Stage& s) const {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int rid = __shfl_sync(mask, id, j, lanes);
      if constexpr (W) s.w[j] = __shfl_sync(mask, wt, j, lanes);
      if (live && l + j < n_look)
        s.r[j].raw = __ldg(reinterpret_cast<const typename Vec<VB>::T*>(
            col + static_cast<long long>(rid) * ld));
    }
  }

  // the stage's adds, in lookup order
  __device__ __forceinline__ void add(int l, const Stage& s) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (live && l + j < n_look) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float x = Elem<C>::widen(s.r[j].code[e]);
          acc[e] = __fadd_rn(acc[e], W ? __fmul_rn(s.w[j], x) : x);
        }
      }
    }
  }
};

template <int N>
__device__ __forceinline__ void store_f32(float* o, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(o + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
  } else {
    o[0] = v[0];
  }
}

template <int C, int VB, bool W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
embed_agg_kernel(const uint8_t* __restrict__ table, long long ld,
                 const int* __restrict__ idx, const float* __restrict__ w,
                 float* __restrict__ out, long long n_items, int n_look,
                 int d, int pieces, int lg_lanes, int slices) {
  using B = Bag<C, VB, W>;
  const int lanes = 1 << lg_lanes;
  const long long step = (static_cast<long long>(gridDim.x) * kThreads) >> lg_lanes;
  for (long long item = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> lg_lanes;
       item < n_items; item += step) {
    const long long bag = slices == 1 ? item : item / slices;
    B g;
    g.lane = threadIdx.x & (lanes - 1);
    g.lanes = lanes;
    g.mask = group_mask(lanes);
    const int p = static_cast<int>(item - bag * slices) * kSlice + g.lane;
    g.live = p < pieces;
    g.ids = idx + bag * n_look;
    g.ws = W ? w + bag * n_look : nullptr;
    g.col = table + static_cast<long long>(p) * VB;
    g.ld = ld;
    g.n_look = n_look;
#pragma unroll
    for (int e = 0; e < B::N; ++e) g.acc[e] = 0.f;

    // two stages in flight: a's rows and b's ids out before a's adds
    typename B::Stage sa, sb;
    int id_a, id_b;
    float w_a, w_b;
    g.fetch_ids(0, id_a, w_a);
    g.fetch_ids(kStage, id_b, w_b);
    g.fetch_rows(0, id_a, w_a, sa);
    for (int l = 0; l < n_look; l += 2 * kStage) {
      g.fetch_rows(l + kStage, id_b, w_b, sb);
      g.fetch_ids(l + 2 * kStage, id_a, w_a);
      g.add(l, sa);
      g.fetch_rows(l + 2 * kStage, id_a, w_a, sa);
      g.fetch_ids(l + 3 * kStage, id_b, w_b);
      g.add(l + kStage, sb);
    }
    if (g.live) store_f32<B::N>(out + bag * d + static_cast<long long>(p) * B::N, g.acc);
  }
}

template <int VB>
__global__ void __launch_bounds__(kThreads)
embed_gather_kernel(const uint8_t* __restrict__ table, long long ld,
                    const int* __restrict__ idx, uint8_t* __restrict__ out,
                    long long n_items, long long row_bytes, int pieces,
                    int lg_lanes, int slices) {
  using V = typename Vec<VB>::T;
  const int lanes = 1 << lg_lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const unsigned mask = group_mask(lanes);
  const long long step = (static_cast<long long>(gridDim.x) * kThreads) >> lg_lanes;
  for (long long item = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> lg_lanes;
       item < n_items; item += step) {
    const long long row = slices == 1 ? item : item / slices;
    const int p = static_cast<int>(item - row * slices) * kSlice + lane;
    int id = 0;
    if (lane == 0) id = __ldg(idx + row);
    id = __shfl_sync(mask, id, 0, lanes);
    if (p < pieces)
      reinterpret_cast<V*>(out + row * row_bytes)[p] =
          __ldg(reinterpret_cast<const V*>(table + static_cast<long long>(id) * ld) + p);
  }
}

__global__ void embed_empty_kernel() {}

// the dependent pair: a group's first id, then a 16-byte piece of its row
__global__ void __launch_bounds__(kThreads)
embed_pair_kernel(const uint8_t* __restrict__ table, long long ld,
                  const int* __restrict__ idx, int n_look, long long n_items,
                  int pieces, int lg_lanes, int slices,
                  unsigned* __restrict__ sink) {
  const int lanes = 1 << lg_lanes;
  const long long item = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> lg_lanes;
  if (item >= n_items) return;
  const long long bag = slices == 1 ? item : item / slices;
  const int p = static_cast<int>(item - bag * slices) * kSlice + (threadIdx.x & (lanes - 1));
  const int id = __ldg(idx + bag * n_look);
  if (p < pieces) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(table + static_cast<long long>(id) * ld) + p);
    if ((v.x ^ v.y ^ v.z ^ v.w) == 0x9e3779b9u) atomicAdd(sink, 1u);
  }
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

int lg2(int lanes) {
  return lanes == 8 ? 3 : lanes == 16 ? 4 : lanes == 32 ? 5 : -1;
}

// the plan's arguments against the row: ref.embed_plan's rule
bool bad_plan(const void* table, long long ld, long long row_bytes, int vec,
              int lanes, int slices, int blocks) {
  if (vec != 16 && vec != 8 && vec != 4 && vec != 2 && vec != 1) return true;
  if (row_bytes < 1 || row_bytes % vec || ld % vec ||
      reinterpret_cast<uintptr_t>(table) % vec)
    return true;
  const long long pieces = row_bytes / vec;
  const long long want = (pieces + kSlice - 1) / kSlice;
  return lg2(lanes) < 0 || blocks < 1 || slices != want ||
         (slices > 1 && lanes != kSlice) || (slices == 1 && lanes < pieces);
}

template <int C, int VB>
int launch_agg(const void* table, long long ld, const void* idx,
               const void* w, void* out, long long b, int n_look, int d,
               int lanes, int slices, int blocks, cudaStream_t st) {
  const int pieces = static_cast<int>(static_cast<long long>(d) *
                                      sizeof(typename Elem<C>::T) / VB);
  auto kernel = w != nullptr ? embed_agg_kernel<C, VB, true>
                             : embed_agg_kernel<C, VB, false>;
  kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(table), ld, static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), b * slices,
      n_look, d, pieces, lg2(lanes), slices);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_agg_code(int vec, const void* table, long long ld,
                    const void* idx, const void* w, void* out, long long b,
                    int n_look, int d, int lanes, int slices, int blocks,
                    cudaStream_t st) {
  constexpr int S = sizeof(typename Elem<C>::T);
  switch (vec) {
    case 16:
      return launch_agg<C, 16>(table, ld, idx, w, out, b, n_look, d, lanes, slices, blocks, st);
    case 8:
      if constexpr (S <= 8)
        return launch_agg<C, 8>(table, ld, idx, w, out, b, n_look, d, lanes, slices, blocks, st);
      break;
    case 4:
      if constexpr (S <= 4)
        return launch_agg<C, 4>(table, ld, idx, w, out, b, n_look, d, lanes, slices, blocks, st);
      break;
    case 2:
      if constexpr (S <= 2)
        return launch_agg<C, 2>(table, ld, idx, w, out, b, n_look, d, lanes, slices, blocks, st);
      break;
    case 1:
      if constexpr (S <= 1)
        return launch_agg<C, 1>(table, ld, idx, w, out, b, n_look, d, lanes, slices, blocks, st);
      break;
  }
  return kInvalid;
}

template <int VB>
int launch_gather(const void* table, long long ld, const void* idx,
                  void* out, long long n_rows, long long row_bytes,
                  int lanes, int slices, int blocks, cudaStream_t st) {
  embed_gather_kernel<VB><<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(table), ld, static_cast<const int*>(idx),
      static_cast<uint8_t*>(out), n_rows * slices, row_bytes,
      static_cast<int>(row_bytes / VB), lg2(lanes), slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after its launch (0 on
// success), or cudaErrorInvalidValue for arguments its plan does not fit.
// table: the first row; ld: the row stride in bytes; vec, lanes, slices,
// blocks: ref.embed_plan and ref.embed_blocks for this table.

int embed_agg(const void* table, long long ld, int code, const void* idx,
              const void* weights, void* out, long long b, int n_look,
              int d, int vec, int lanes, int slices, int blocks,
              void* stream) {
  static const int size[] = {4, 2, 2, 1, 1, 1, 1, 2, 4};
  if (code < F32 || code > I32 || b < 1 || n_look < 1 || d < 1 ||
      bad_plan(table, ld, static_cast<long long>(d) * size[code], vec, lanes,
               slices, blocks))
    return kInvalid;
  auto st = static_cast<cudaStream_t>(stream);
#define EMBED_AGG_CODE(C)                                                    \
  case C:                                                                    \
    return launch_agg_code<C>(vec, table, ld, idx, weights, out, b, n_look, \
                              d, lanes, slices, blocks, st);
  switch (code) {
    EMBED_AGG_CODE(F32)
    EMBED_AGG_CODE(BF16)
    EMBED_AGG_CODE(F16)
    EMBED_AGG_CODE(E4M3)
    EMBED_AGG_CODE(E5M2)
    EMBED_AGG_CODE(I8)
    EMBED_AGG_CODE(U8)
    EMBED_AGG_CODE(I16)
    EMBED_AGG_CODE(I32)
  }
#undef EMBED_AGG_CODE
  return kInvalid;
}

int embed_gather(const void* table, long long ld, const void* idx, void* out,
                 long long n_rows, long long row_bytes, int vec, int lanes,
                 int slices, int blocks, void* stream) {
  if (n_rows < 1 || bad_plan(table, ld, row_bytes, vec, lanes, slices, blocks))
    return kInvalid;
  auto st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return launch_gather<16>(table, ld, idx, out, n_rows, row_bytes, lanes, slices, blocks, st);
    case 8: return launch_gather<8>(table, ld, idx, out, n_rows, row_bytes, lanes, slices, blocks, st);
    case 4: return launch_gather<4>(table, ld, idx, out, n_rows, row_bytes, lanes, slices, blocks, st);
    case 2: return launch_gather<2>(table, ld, idx, out, n_rows, row_bytes, lanes, slices, blocks, st);
    default: return launch_gather<1>(table, ld, idx, out, n_rows, row_bytes, lanes, slices, blocks, st);
  }
}

// The floors: the empty kernel on `blocks` blocks, and the dependent pair
// over n_items groups (16-byte pieces: vec must be 16).
int embed_floor_empty(int blocks, void* stream) {
  if (blocks < 1) return kInvalid;
  embed_empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int embed_floor_pair(const void* table, long long ld, const void* idx,
                     int n_look, long long n_items, long long row_bytes,
                     int lanes, int slices, int blocks, void* sink,
                     void* stream) {
  if (n_look < 1 || n_items < 1 || bad_plan(table, ld, row_bytes, 16, lanes, slices, blocks))
    return kInvalid;
  embed_pair_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), ld, static_cast<const int*>(idx),
      n_look, n_items, static_cast<int>(row_bytes / 16), lg2(lanes), slices,
      static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
