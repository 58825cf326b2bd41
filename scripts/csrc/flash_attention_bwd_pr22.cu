// The flash-attention backward's first tensor-core design, kept for
// comparison with src/repro_torch/kernels/csrc/flash_attention_bwd.cu on
// the card (scripts/redesign_check.py train).  Not part of the package:
// the package's build never compiles it.  Its dK/dV kernel is a block per
// (batch, kv head, key tile) walking the G heads' query tiles one after
// another, with synchronous tile loads.  Its C entry point takes no
// workspace and no tickets.
//
// Backward of the blockwise GQA attention (flash_attention.cu) for Hopper
// (sm_90a), hand-written CUDA C++: dQ, dK, dV from q, k, v, out, dout and
// the forward's row logsumexp.
//
// The JAX package has no Pallas backward: its training gradient is
// autodiff of chunked_attention (repro/models/layers.py:125), a masked
// softmax over f32 scores.  This computes the same gradient, for causal
// (Sq == Sk) and full attention with GQA (dK and dV sum over the G query
// heads of a kv head), by the textbook recompute:
//   P = exp(S * scale - lse), dV = P^T dO, dP = dO V^T,
//   Di = rowsum(dO o O), dS = P o (dP - Di),
//   dQ = dS K * scale, dK = dS^T Q * scale,
// in three launches on the caller's stream:
//   * flash_bwd_di_kernel: Di, a warp a row;
//   * a dK/dV kernel: a block per (batch, kv head, key tile), K and V
//     kept; it walks the query tiles of its G heads (from the tile's
//     diagonal when causal), rebuilds P and dS for each and accumulates
//     dK and dV in registers;
//   * a dQ kernel: a block per (batch, head(s), query tile), Q and dO
//     kept; it walks the key tiles (up to its diagonal when causal) and
//     accumulates dQ in registers.
// Every sum runs in a fixed order and no block writes what another block
// writes (no atomics): two runs on the same inputs give the same bits,
// which resumed training needs to be bit-identical to uninterrupted.
//
// Bound on this card: operations.  The gradient needs five products a
// (query, key) pair kept (S, dP, dV, dK, dQ: 10 * D f32 operations); at
// granite-3-2b's shape (B=8, H=32, Hkv=8, S=512, D=64, causal) 21.5
// GFLOP, 0.32 ms on the CUDA cores' 67 TFLOP/s, 0.13 ms as 3xTF32 on the
// tensor cores.  Both routes recompute S and dP in both kernels (seven
// products a pair).
//   * D <= 128 (every head_dim of the catalog's transformers but
//     paligemma's 256) and G <= 64: the forward's tensor-core route,
//     3xTF32 mma.sync.m16n8k8 (f32 accuracy, tf32_mma.cuh), four warps
//     of 16 rows a block.  Each product keeps its 16-row side as the mma
//     M side, so no tile is transposed: the dK/dV kernel computes
//     S^T = K Q^T and dP^T = V dO^T with keys as rows, and feeds P^T and
//     dS^T from their accumulators straight into dV += P^T dO and dK +=
//     dS^T Q as A fragments (a thread's accumulator holds columns 2tg,
//     2tg+1 of each 8-column tile, so the k index tg stands for column
//     2tg and tg + 4 for 2tg + 1, and the B fragment reads rows 2tg and
//     2tg + 1 to match: the forward's P V).  The dQ kernel's 64 rows
//     are the forward's: the G heads of a kv head times 64 / G
//     positions, so each K/V tile serves the whole group.  Rows padded
//     to D + 4 floats: fragment reads hit 32 distinct banks.  dK, dV and
//     dQ take a walked tile at a time: its share is summed in the mma's
//     C operand from zero and joined to the running sums by f32 adds
//     (tile_times_rows).  Kept in C across every tile, the running sums
//     ended 7-15x further from float64 than the plain f32 backward
//     (scripts/flash_bwd_accuracy.py).
//   * otherwise: plain f32 FMA from shared memory, 32 x 32 tiles, 256
//     threads (8 a tile row), accumulators of D / 8 columns a thread.
//
// Layouts (row-major, contiguous, 16-byte aligned): q, out, dout, dq
// [B, H, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D]; lse, di [B, H, Sq]; all
// f32.  D % 8 == 0, 8 <= D <= 256 (columns up to the next multiple of 32
// zero-filled in shared memory); H % Hkv == 0.

#include <cmath>

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// -- the FMA route (D > 128 or G > 64) ---------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 32;      // query rows and keys of a tile
constexpr int kLanes = 8;      // threads sharing a tile row in the products

template <int DP>
struct Cfg {
  static constexpr int LD = DP + 1;          // odd stride: no bank conflicts
  static constexpr int LP = kTile + 1;
  static constexpr int PER = DP / kLanes;    // d columns a thread owns
  // Q, dO, K, V tiles, P and dS, lse * log2(e) and Di of the query tile
  static constexpr size_t kSmem =
      sizeof(float) * (4 * (size_t)kTile * LD + 2 * (size_t)kTile * LP + 2 * kTile);
};

// rows [r0, r0 + 32) of a [n, d] matrix into a [32][DP + 1] tile, rows past
// n and columns past d zero
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int r0, int n, int d) {
  constexpr int LD = DP + 1, C4 = DP / 4;
  for (int e = threadIdx.x; e < kTile * C4; e += kThreads) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n && c < d)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * d + c);
    float* o = dst + r * LD + c;
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
}

// lse * log2(e) and Di of query rows [i0, i0 + 32) of one head (0 past sq)
__device__ __forceinline__ void load_rows(float* lse2_s, float* di_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ di, int i0,
                                          int sq) {
  if (threadIdx.x < kTile) {
    const int i = i0 + threadIdx.x;
    lse2_s[threadIdx.x] = i < sq ? lse[i] * 1.4426950408889634f : 0.f;
    di_s[threadIdx.x] = i < sq ? di[i] : 0.f;
  }
}

// P and dS of a (query tile i0, key tile j0) pair into ps, dss [32][33]:
// thread (row t / 8, keys t % 8 + 8c); masked entries are 0
template <int DP>
__device__ __forceinline__ void tile_scores(const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            const float* lse2_s, const float* di_s,
                                            float* ps, float* dss, int i0, int j0,
                                            int sq, int sk, int causal,
                                            float scale_log2) {
  constexpr int LD = DP + 1, LP = kTile + 1;
  const int r = threadIdx.x / kLanes, l8 = threadIdx.x % kLanes;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int dd = 0; dd < DP; ++dd) {
    const float qv = qs[r * LD + dd], ov = dos[r * LD + dd];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = fmaf(qv, ks[(l8 + 8 * c) * LD + dd], s[c]);
      dp[c] = fmaf(ov, vs[(l8 + 8 * c) * LD + dd], dp[c]);
    }
  }
  const int i = i0 + r;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int jj = l8 + 8 * c, j = j0 + jj;
    const bool ok = i < sq && j < sk && (!causal || j <= i);
    const float p = ok ? exp2f(fmaf(s[c], scale_log2, -lse2_s[r])) : 0.f;
    ps[r * LP + jj] = p;
    dss[r * LP + jj] = p * (dp[c] - di_s[r]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_di_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                    float* __restrict__ di, long rows, int d) {
  const long row = (long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* o = out + row * d;
  const float* g = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[row] = acc;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      float* __restrict__ dk, float* __restrict__ dv, int h, int hkv,
                      int sq, int sk, int d, int causal, float scale,
                      float scale_log2) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, LP = C::LP, PER = C::PER;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  float* dss = ps + kTile * LP;
  float* lse2_s = dss + kTile * LP;
  float* di_s = lse2_s + kTile;

  const int b = blockIdx.z, kvh = blockIdx.y, j0 = blockIdx.x * kTile;
  const int group = h / hkv;
  const size_t kv_off = ((size_t)b * hkv + kvh) * sk * d;
  load_tile<DP>(ks, k + kv_off, j0, sk, d);
  load_tile<DP>(vs, v + kv_off, j0, sk, d);

  const int jr = threadIdx.x / kLanes, l8 = threadIdx.x % kLanes;  // key, columns
  float acc_k[PER], acc_v[PER];
#pragma unroll
  for (int c = 0; c < PER; ++c) acc_k[c] = acc_v[c] = 0.f;

  const int t0 = causal ? j0 / kTile : 0;           // first query tile
  const int n_qt = (sq + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const size_t head = (size_t)b * h + kvh * group + g;
    const float* qh = q + head * sq * d;
    const float* doh = dout + head * sq * d;
    for (int t = t0; t < n_qt; ++t) {
      const int i0 = t * kTile;
      __syncthreads();                 // the last tile's products are done
      load_tile<DP>(qs, qh, i0, sq, d);
      load_tile<DP>(dos, doh, i0, sq, d);
      load_rows(lse2_s, di_s, lse + head * sq, di + head * sq, i0, sq);
      __syncthreads();
      tile_scores<DP>(qs, dos, ks, vs, lse2_s, di_s, ps, dss, i0, j0, sq, sk,
                      causal, scale_log2);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i]; dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        const float p = ps[i * LP + jr], ds = dss[i * LP + jr];
#pragma unroll
        for (int c = 0; c < PER; ++c) {
          acc_v[c] = fmaf(p, dos[i * LD + l8 + kLanes * c], acc_v[c]);
          acc_k[c] = fmaf(ds, qs[i * LD + l8 + kLanes * c], acc_k[c]);
        }
      }
    }
  }
  const int j = j0 + jr;
  if (j >= sk) return;
  float* dk_row = dk + kv_off + (size_t)j * d;
  float* dv_row = dv + kv_off + (size_t)j * d;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int col = l8 + kLanes * c;
    if (col < d) {
      dk_row[col] = acc_k[c] * scale;
      dv_row[col] = acc_v[c];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    float* __restrict__ dq, int h, int hkv, int sq, int sk, int d,
                    int causal, float scale, float scale_log2) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, LP = C::LP, PER = C::PER;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  float* dss = ps + kTile * LP;
  float* lse2_s = dss + kTile * LP;
  float* di_s = lse2_s + kTile;

  const int b = blockIdx.z, hh = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;   // longest tiles first
  const int kvh = hh / (h / hkv);
  const size_t head = (size_t)b * h + hh;
  const size_t kv_off = ((size_t)b * hkv + kvh) * sk * d;
  load_tile<DP>(qs, q + head * sq * d, i0, sq, d);
  load_tile<DP>(dos, dout + head * sq * d, i0, sq, d);
  load_rows(lse2_s, di_s, lse + head * sq, di + head * sq, i0, sq);

  const int ir = threadIdx.x / kLanes, l8 = threadIdx.x % kLanes;  // row, columns
  float acc[PER];
#pragma unroll
  for (int c = 0; c < PER; ++c) acc[c] = 0.f;

  int kmax = sk;                       // keys this tile needs
  if (causal) {
    const int last = i0 + kTile < sq ? i0 + kTile : sq;
    kmax = last < sk ? last : sk;
  }
  const int n_kt = (kmax + kTile - 1) / kTile;
  for (int t = 0; t < n_kt; ++t) {
    const int j0 = t * kTile;
    __syncthreads();
    load_tile<DP>(ks, k + kv_off, j0, sk, d);
    load_tile<DP>(vs, v + kv_off, j0, sk, d);
    __syncthreads();
    tile_scores<DP>(qs, dos, ks, vs, lse2_s, di_s, ps, dss, i0, j0, sq, sk,
                    causal, scale_log2);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float ds = dss[ir * LP + j];
#pragma unroll
      for (int c = 0; c < PER; ++c)
        acc[c] = fmaf(ds, ks[j * LD + l8 + kLanes * c], acc[c]);
    }
  }
  const int i = i0 + ir;
  if (i >= sq) return;
  float* dq_row = dq + (head * sq + i) * d;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int col = l8 + kLanes * c;
    if (col < d) dq_row[col] = acc[c] * scale;
  }
}

// -- the tensor-core route (D <= 128, G <= 64) ------------------------------

constexpr int kMmaThreads = 128;   // four warps of 16 rows
constexpr int kMmaRows = 64;       // the kept side of a block
constexpr int kMmaCols = 32;       // the walked side's tile

template <int DP>
struct MmaCfg {
  static constexpr int LD = DP + 4;       // padded row stride (floats)
  static constexpr int KT = DP / 8;       // k-steps over d, n-tiles over d
  static constexpr int NT = kMmaCols / 8; // n-tiles over the walked side
  static constexpr int CH = DP / 4;       // 16-byte chunks of a padded row
  // two kept [64][LD] tiles, two walked [32][LD] tiles, lse * log2(e)
  // and Di of up to 64 rows
  static constexpr size_t kSmem =
      sizeof(float) * (2 * (size_t)kMmaRows * LD + 2 * (size_t)kMmaCols * LD +
                       2 * kMmaRows);
};

// an A fragment split once, for every n-tile it multiplies (as in
// flash_attention.cu)
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float* a) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
  }
};

// acc[n] += a * B_n for n < N at f32 accuracy, B_n's fragment being
// (b[2n], b[2n + 1]) (as in flash_attention.cu)
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*acc)[4], const SplitA& a,
                                           const float* b) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[2 * n], bh[n][0], bl[n][0]);
    split(b[2 * n + 1], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.lo, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, bh[n]);
}

// rows [r0, r0 + ROWS) of a [n, d] matrix into [ROWS][LD], zero past n, d
template <int DP, int ROWS>
__device__ __forceinline__ void mma_load(float* dst, const float* __restrict__ src,
                                         int r0, int n, int d) {
  using C = MmaCfg<DP>;
  for (int e = threadIdx.x; e < ROWS * C::CH; e += kMmaThreads) {
    const int r = e / C::CH, c = (e % C::CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n && c < d)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * d + c);
    *reinterpret_cast<float4*>(dst + r * C::LD + c) = x;
  }
}

// A fragment of rows (r0, r0 + 8), k-step kk, of a [*][LD] tile
template <int LD>
__device__ __forceinline__ void a_frag(float* a, const float* t, int r0, int kk,
                                       int tg) {
  a[0] = t[r0 * LD + 8 * kk + tg];
  a[1] = t[(r0 + 8) * LD + 8 * kk + tg];
  a[2] = t[r0 * LD + 8 * kk + tg + 4];
  a[3] = t[(r0 + 8) * LD + 8 * kk + tg + 4];
}

// B fragments of X^T for k-step kk over d: column n of tile n is row
// 8n + g of the [*][LD] tile t (rows c0 .. c0 + 8 NT)
template <int LD, int NT>
__device__ __forceinline__ void bt_frags(float* b, const float* t, int kk, int g,
                                         int tg) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float* r = t + (8 * n + g) * LD + 8 * kk + tg;
    b[2 * n] = r[0];
    b[2 * n + 1] = r[4];
  }
}

// acc[n] += A * X[8 kk .. 8 kk + 8, n-tile n] for every d n-tile, A given
// as accumulator entries (c0..c3 of tile kk of the walked side): the k
// index tg stands for row 2tg of X and tg + 4 for row 2tg + 1
template <int LD, int KT>
__device__ __forceinline__ void acc_times_rows(float (*acc)[4], const float* c,
                                               const float* t, int kk, int g,
                                               int tg) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  const SplitA sa(a);
  const float* r = t + (8 * kk + 2 * tg) * LD + g;
#pragma unroll
  for (int n0 = 0; n0 < KT; n0 += 4) {
    float bf[8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      bf[2 * n] = r[8 * (n0 + n)];
      bf[2 * n + 1] = r[LD + 8 * (n0 + n)];
    }
    mma_3xtf32<4>(acc + n0, sa, bf);
  }
}

// acc += (the walked tile's C entries c[0..NT)) * X over the tile, the
// tile's sum formed in zeroed registers and added to acc by f32 adds.
// The tensor core does not round the sum it adds into its C operand to
// nearest (published measurements of these units find truncation), so a
// long sum kept in C drifts with its length (dK and dV take 3 mma a
// k-step over every query of the G heads); here C holds one tile's 32
// rows and the tiles join by rounded adds, as the FMA route's sums do.
template <int LD, int KT, int NT>
__device__ __forceinline__ void tile_times_rows(float (*acc)[4], const float (*c)[4],
                                                const float* t, int g, int tg) {
  float part[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) acc_times_rows<LD, KT>(part, c[kk], t, kk, g, tg);
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv, int h,
                          int hkv, int sq, int sk, int d, int causal, float scale,
                          float scale_log2) {
  using C = MmaCfg<DP>;
  constexpr int LD = C::LD, KT = C::KT, NT = C::NT;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [64][LD] keys of the block
  float* vs = ks + kMmaRows * LD;
  float* qs = vs + kMmaRows * LD;         // [32][LD] queries of a tile
  float* dos = qs + kMmaCols * LD;
  float* lse2_s = dos + kMmaCols * LD;    // [32]
  float* di_s = lse2_s + kMmaRows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kMmaRows;
  const int group = h / hkv;
  const size_t kv_off = ((size_t)b * hkv + kvh) * sk * d;
  mma_load<DP, kMmaRows>(ks, k + kv_off, k0, sk, d);
  mma_load<DP, kMmaRows>(vs, v + kv_off, k0, sk, d);

  const int r0 = warp * 16 + g;                  // this thread's keys r0, r0 + 8
  const int key0 = k0 + r0, key1 = key0 + 8;
  float acc_k[KT][4], acc_v[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;

  const int t0 = causal ? k0 / kMmaCols : 0;    // first query tile
  const int n_qt = (sq + kMmaCols - 1) / kMmaCols;
  for (int gi = 0; gi < group; ++gi) {
    const size_t head = (size_t)b * h + kvh * group + gi;
    for (int t = t0; t < n_qt; ++t) {
      const int i0 = t * kMmaCols;
      __syncthreads();                 // the last tile's reads are done
      mma_load<DP, kMmaCols>(qs, q + head * sq * d, i0, sq, d);
      mma_load<DP, kMmaCols>(dos, dout + head * sq * d, i0, sq, d);
      if (tid < kMmaCols) {
        const int i = i0 + tid;
        lse2_s[tid] = i < sq ? lse[head * sq + i] * 1.4426950408889634f : 0.f;
        di_s[tid] = i < sq ? di[head * sq + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys as rows, the tile's queries
      // as columns
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        float a[4], bf[2 * NT];
        a_frag<LD>(a, ks, r0, kk, tg);
        bt_frags<LD, NT>(bf, qs, kk, g, tg);
        mma_3xtf32<NT>(st, SplitA(a), bf);
        a_frag<LD>(a, vs, r0, kk, tg);
        bt_frags<LD, NT>(bf, dos, kk, g, tg);
        mma_3xtf32<NT>(dpt, SplitA(a), bf);
      }
      // P^T and dS^T in place: c0, c1 are key r0's queries 8n + 2tg, +1;
      // c2, c3 key r0 + 8's
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = 8 * n + 2 * tg + (c & 1), i = i0 + qi;
          const int key = c < 2 ? key0 : key1;
          const bool ok = i < sq && key < sk && (!causal || key <= i);
          const float p = ok ? exp2f(fmaf(st[n][c], scale_log2, -lse2_s[qi])) : 0.f;
          st[n][c] = p;
          dpt[n][c] = p * (dpt[n][c] - di_s[qi]);
        }
      }
      // dV += P^T dO, dK += dS^T Q over the tile's queries
      tile_times_rows<LD, KT, NT>(acc_v, st, dos, g, tg);
      tile_times_rows<LD, KT, NT>(acc_k, dpt, qs, g, tg);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    if (key >= sk) continue;
    float* dk_row = dk + kv_off + (size_t)key * d;
    float* dv_row = dv + kv_off + (size_t)key * d;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      if (8 * n >= d) break;
      *reinterpret_cast<float2*>(dk_row + 8 * n + 2 * tg) =
          make_float2(acc_k[n][2 * half] * scale, acc_k[n][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dv_row + 8 * n + 2 * tg) =
          make_float2(acc_v[n][2 * half], acc_v[n][2 * half + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        float* __restrict__ dq, int h, int hkv, int sq, int sk, int d,
                        int group, int bq, int causal, float scale, float scale_log2) {
  using C = MmaCfg<DP>;
  constexpr int LD = C::LD, KT = C::KT, NT = C::NT, CH = C::CH;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [64][LD] rows of the block
  float* dos = qs + kMmaRows * LD;
  float* ks = dos + kMmaRows * LD;        // [32][LD] keys of a tile
  float* vs = ks + kMmaCols * LD;
  float* lse2_s = vs + kMmaCols * LD;     // [64]
  float* di_s = lse2_s + kMmaRows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;   // longest tiles first
  const int rows = group * bq;
  // block row r = (head kvh * group + r / bq, position q0 + r % bq)
  for (int e = tid; e < kMmaRows * CH; e += kMmaThreads) {
    const int r = e / CH, c = (e % CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r < rows && q0 + r % bq < sq && c < d) {
      const size_t off =
          (((size_t)b * h + kvh * group + r / bq) * sq + q0 + r % bq) * d + c;
      x = *reinterpret_cast<const float4*>(q + off);
      y = *reinterpret_cast<const float4*>(dout + off);
    }
    *reinterpret_cast<float4*>(qs + r * LD + c) = x;
    *reinterpret_cast<float4*>(dos + r * LD + c) = y;
  }
  if (tid < kMmaRows) {
    const bool ok = tid < rows && q0 + tid % bq < sq;
    const size_t row = ((size_t)b * h + kvh * group + tid / bq) * sq + q0 + tid % bq;
    lse2_s[tid] = ok ? lse[row] * 1.4426950408889634f : 0.f;
    di_s[tid] = ok ? di[row] : 0.f;
  }

  int kmax = sk;                        // keys this block needs
  if (causal) {
    const int last = q0 + bq < sq ? q0 + bq : sq;
    kmax = last < sk ? last : sk;
  }
  const int n_tiles = (kmax + kMmaCols - 1) / kMmaCols;
  const size_t kv_off = ((size_t)b * hkv + kvh) * sk * d;
  const int r0 = warp * 16 + g, r1 = r0 + 8;   // this thread's two rows
  const int pos0 = q0 + r0 % bq, pos1 = q0 + r1 % bq;
  const bool row0 = r0 < rows && pos0 < sq, row1 = r1 < rows && pos1 < sq;
  float acc[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kMmaCols;
    __syncthreads();                   // the last tile's reads are done
    mma_load<DP, kMmaCols>(ks, k + kv_off, k0, kmax, d);
    mma_load<DP, kMmaCols>(vs, v + kv_off, k0, kmax, d);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[4], bf[2 * NT];
      a_frag<LD>(a, qs, r0, kk, tg);
      bt_frags<LD, NT>(bf, ks, kk, g, tg);
      mma_3xtf32<NT>(s, SplitA(a), bf);
      a_frag<LD>(a, dos, r0, kk, tg);
      bt_frags<LD, NT>(bf, vs, kk, g, tg);
      mma_3xtf32<NT>(dp, SplitA(a), bf);
    }
    // dS in place: c0, c1 are row r0's keys 8n + 2tg, +1; c2, c3 row r1's
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + 8 * n + 2 * tg + (c & 1);
        const int r = c < 2 ? r0 : r1;
        const int pos = c < 2 ? pos0 : pos1;
        const bool ok = (c < 2 ? row0 : row1) && col < kmax && (!causal || col <= pos);
        const float p = ok ? exp2f(fmaf(s[n][c], scale_log2, -lse2_s[r])) : 0.f;
        s[n][c] = p * (dp[n][c] - di_s[r]);
      }
    }
    // dQ += dS K over the tile's keys
    tile_times_rows<LD, KT, NT>(acc, s, ks, g, tg);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? row1 : row0)) continue;
    const int r = half ? r1 : r0;
    const int pos = half ? pos1 : pos0;
    float* dq_row = dq + (((size_t)b * h + kvh * group + r / bq) * sq + pos) * d;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      if (8 * n >= d) break;
      *reinterpret_cast<float2*>(dq_row + 8 * n + 2 * tg) =
          make_float2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
  }
}

// -- the launchers -------------------------------------------------------------

struct Args {
  const float *q, *k, *v, *out, *dout, *lse;
  float *di, *dq, *dk, *dv;
  int b, h, hkv, sq, sk, d, causal;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DP>
cudaError_t launch_mma(const Args& a, int group, float scale, float scale_log2,
                       cudaStream_t stream) {
  const size_t smem = MmaCfg<DP>::kSmem;
  static bool smem_set = false;      // once per instantiation
  cudaError_t err;
  if (!smem_set) {
    if ((err = allow_smem(flash_bwd_dkdv_mma_kernel<DP>, smem)) != cudaSuccess) return err;
    if ((err = allow_smem(flash_bwd_dq_mma_kernel<DP>, smem)) != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid_kv((a.sk + kMmaRows - 1) / kMmaRows, a.hkv, a.b);
  flash_bwd_dkdv_mma_kernel<DP><<<grid_kv, kMmaThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.di, a.dk, a.dv, a.h, a.hkv, a.sq, a.sk, a.d,
      a.causal, scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int bq = kMmaRows / group;
  dim3 grid_q((a.sq + bq - 1) / bq, a.hkv, a.b);
  flash_bwd_dq_mma_kernel<DP><<<grid_q, kMmaThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.di, a.dq, a.h, a.hkv, a.sq, a.sk, a.d, group, bq,
      a.causal, scale, scale_log2);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_fma(const Args& a, float scale, float scale_log2,
                       cudaStream_t stream) {
  const size_t smem = Cfg<DP>::kSmem;
  static bool smem_set = false;      // once per instantiation
  cudaError_t err;
  if (!smem_set) {
    if ((err = allow_smem(flash_bwd_dkdv_kernel<DP>, smem)) != cudaSuccess) return err;
    if ((err = allow_smem(flash_bwd_dq_kernel<DP>, smem)) != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid_kv((a.sk + kTile - 1) / kTile, a.hkv, a.b);
  flash_bwd_dkdv_kernel<DP><<<grid_kv, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.di, a.dk, a.dv, a.h, a.hkv, a.sq, a.sk, a.d,
      a.causal, scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 grid_q((a.sq + kTile - 1) / kTile, a.h, a.b);
  flash_bwd_dq_kernel<DP><<<grid_q, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.di, a.dq, a.h, a.hkv, a.sq, a.sk, a.d, a.causal,
      scale, scale_log2);
  return cudaGetLastError();
}

// Di, then the tensor-core route where it takes the shape, else FMA
template <int DP>
cudaError_t launch_dp(const Args& a, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)a.d);
  const float scale_log2 = 1.4426950408889634f * scale;
  const long rows = (long)a.b * a.h * a.sq;
  const int warps = kThreads / 32;
  flash_bwd_di_kernel<<<(unsigned)((rows + warps - 1) / warps), kThreads, 0, stream>>>(
      a.out, a.dout, a.di, rows, a.d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int group = a.h / a.hkv;
  if constexpr (DP <= 128) {
    if (group <= kMmaRows) return launch_mma<DP>(a, group, scale, scale_log2, stream);
  }
  return launch_fma<DP>(a, scale, scale_log2, stream);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// di is scratch [B, H, Sq] f32 the caller allocates.  Returns
// cudaGetLastError() after the last launch (0 on success), the first
// launch error, or cudaErrorInvalidValue for a shape the kernels do not
// take.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* lse,
                            void* di, void* dq, void* dk, void* dv, int b, int h,
                            int hkv, int sq, int sk, int d, int causal,
                            void* stream) {
  if (b < 1 || hkv < 1 || h % hkv || sq < 1 || sk < 1 || b > 65535 ||
      h > 65535 || (causal && sq != sk) || d < 8 || d > 256 || d % 8 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      !aligned(dout) || !aligned(dq) || !aligned(dk) || !aligned(dv) ||
      lse == nullptr || di == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),   static_cast<const float*>(k),
               static_cast<const float*>(v),   static_cast<const float*>(out),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(di),        static_cast<float*>(dq),
               static_cast<float*>(dk),        static_cast<float*>(dv),
               b, h, hkv, sq, sk, d, causal};
  auto st = static_cast<cudaStream_t>(stream);
  switch ((d + 31) / 32) {
    case 1: return (int)launch_dp<32>(a, st);
    case 2: return (int)launch_dp<64>(a, st);
    case 3: return (int)launch_dp<96>(a, st);
    case 4: return (int)launch_dp<128>(a, st);
    case 5: return (int)launch_dp<160>(a, st);
    case 6: return (int)launch_dp<192>(a, st);
    case 7: return (int)launch_dp<224>(a, st);
    case 8: return (int)launch_dp<256>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
