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
// in two launches on the caller's stream: Di (flash_bwd_di_kernel, a warp
// a row), then the dK/dV and dQ blocks (flash_bwd_mma_kernel; the FMA
// route launches them apart).  No float atomics, and every sum runs in a
// fixed order: two runs on the same inputs give the same bits, which
// resumed training needs to be bit-identical to uninterrupted.
//
// Bound on this card: operations.  The gradient needs five products a
// (query, key) pair kept (S, dP, dV, dK, dQ: 10 * D f32 operations); at
// granite-3-2b's shape (B=8, H=32, Hkv=8, S=512, D=64, causal) 21.5
// GFLOP: 0.32 ms on the CUDA cores' 67 TFLOP/s, 0.1304 ms as 3xTF32 on
// the tensor cores (three TF32 products each at 495 TFLOP/s).
//
// The tensor-core route (D <= 128, every head_dim of the catalog's
// transformers but paligemma's 256; G <= 64): 3xTF32 mma.sync.m16n8k8,
// four warps of 16 rows a block; each product keeps its 16-row side as
// the mma M side, so no tile is transposed (S^T = K Q^T and dP^T = V dO^T
// with keys as rows, P^T and dS^T fed from their accumulators into dV +=
// P^T dO and dK += dS^T Q as A fragments; the dQ blocks' rows are the
// forward's).  What the design does about what held the first design
// (kept in scripts/csrc/flash_attention_bwd_pr22.cu) at 8.1x its bound:
//   * blocks in flight and the walk: a dK/dV block per (batch, head, key
//     tile of 64), every key-tile-0 block (the longest walk, causal)
//     first; it walks only its head's query tiles, 16 at most at S = 512
//     (the first design: a block per kv head walked its G heads one after
//     another, 64 tiles).  Each head's f32 share of dK and dV goes to a
//     workspace [2, G, B, Hkv, Sk, D]; the last block of each (batch, kv
//     head, key tile) group (a ticket, as the pool forms' merge in
//     paged_attention.cu) sums the G shares head 0 first and writes dK,
//     dV; at G = 1 a block writes them itself.  The dQ blocks (B * Hkv a
//     query tile, the last, longest, first) follow the dK/dV blocks in
//     the same launch and fill their tail;
//   * the walked tiles (Q, dO, their lse and Di rows for dK/dV; K, V for
//     dQ) come through a two-stage cp.async ring, 16-byte copies (4-byte
//     ones for the lse and Di rows, which start at any float), with one
//     barrier a tile: the next tile's copy overlaps this tile's products;
//     rows padded to D + 4 floats, so fragment reads hit 32 distinct
//     banks.  A third stage measured slower (shared memory for fewer
//     blocks; scripts/flash_bwd_accuracy.py);
//   * registers with no spills at D = 32-128: a tile's share sums 4 d
//     n-tiles at a time above D = 64 (tile_times_rows), the merge takes
//     2 float4 a thread a pass there; the walked tile is 16 rows at D =
//     128 (32 below), so two blocks fit a SM; at D = 64 the kernel is
//     held to 168 registers, three blocks a SM;
//   * operand splits: lo = x - hi is left in f32 (split_lo_cut): the
//     tensor core reads an operand's top 19 bits, so lo enters the
//     products cut to TF32; two integer operations an operand fewer than
//     rounding it (tf32_mma.cuh's split); errors against float64 within
//     1.3x of the plain f32 backward's (scripts/flash_bwd_accuracy.py);
//   * f32 sums: each walked tile's share is summed in the mma's C from
//     zero and joined to the running sums by f32 adds (tile_times_rows).
//     Kept in C across every tile, the running sums ended 7-15x further
//     from float64 than the plain f32 backward;
//   * recompute kept: the dQ blocks compute S and dP again (seven
//     products a pair where the bound counts five).  Writing dQ from the
//     dK/dV blocks in a fixed order needs either a workspace a key tile
//     (8x dQ at S = 512) or blocks that wait on each other's turns.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 7): granite causal
// B=8 0.63 ms, 4.8x the bound (SDPA's backward 0.92, the first design
// 1.04 in turns), phi3-mini D=96 0.99 ms (SDPA 1.66); in the dK/dV and dQ
// blocks ~44% of the card's mma.sync TF32 rate (318 TFLOP/s,
// scripts/flash_sweep.py).
//
// The FMA route (D > 128 or G > 64): plain f32 FMA from shared memory,
// 32 x 32 tiles, 256 threads (8 a tile row), accumulators of D / 8
// columns a thread; its dK/dV blocks walk the G heads one after another.
//
// Layouts (row-major, contiguous, 16-byte aligned): q, out, dout, dq
// [B, H, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D]; lse, di [B, H, Sq]; all
// f32.  D % 8 == 0, 8 <= D <= 256 (columns up to the next multiple of 32
// zero-filled in shared memory); H % Hkv == 0.  kernels/ref.py:
// flash_bwd_plan is this route's schedule, flash_attention_bwd_emulated
// its sum order.

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
constexpr int kStages = 2;         // the walked tiles' cp.async ring

// Shared memory and fragment counts of one head-dim instantiation
// (kernels/ref.py: flash_bwd_plan mirrors COLS)
template <int DP>
struct MmaCfg {
  static constexpr int LD = DP + 4;               // padded row stride (floats)
  static constexpr int KT = DP / 8;               // k-steps over d, n-tiles over d
  static constexpr int COLS = DP <= 96 ? 32 : 16; // the walked side's tile
  static constexpr int CH = DP / 4;               // 16-byte chunks of a padded row
  static constexpr int CW = KT <= 8 ? KT : 4;     // d n-tiles a tile's share sums at once
  // blocks a SM the kernel's registers must allow (its shared memory
  // allows three up to D = 64)
  static constexpr int KV_BLOCKS = DP <= 64 ? 3 : 1;
  // dK/dV: K and V [64][LD] kept; a stage holds Q and dO [COLS][LD], the
  // tile's lse and Di
  static constexpr int kKvStage = 2 * COLS * LD + 2 * COLS;
  static constexpr size_t kKvSmem =
      sizeof(float) * (2 * (size_t)kMmaRows * LD + kStages * (size_t)kKvStage);
  // dQ: Q and dO [64][LD], lse and Di of the 64 rows kept; a stage holds K
  // and V [COLS][LD]
  static constexpr int kQStage = 2 * COLS * LD;
  static constexpr size_t kQSmem =
      sizeof(float) * (2 * (size_t)kMmaRows * LD + 2 * kMmaRows +
                       kStages * (size_t)kQStage);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, or a zero when !valid (lse and Di rows start
// at any float)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo with hi = tf32(x) (tf32_mma.cuh) and lo = x - hi left in
// f32: the tensor core reads an operand's top 19 bits, so lo enters its
// products cut to TF32 toward zero (kernels/ref.py: tf32_cut), at most
// 2^-21 |x| from lo rounded; one rounding (two integer operations) fewer
// an operand than split()
__device__ __forceinline__ void split_lo_cut(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// an A fragment split once, for every n-tile it multiplies
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float* a) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_lo_cut(a[i], hi[i], lo[i]);
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
    split_lo_cut(b[2 * n], bh[n][0], bl[n][0]);
    split_lo_cut(b[2 * n + 1], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.lo, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, bh[n]);
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
// 8n + g of the [*][LD] tile t
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

// X A^T and Y B^T over d for this warp's 16 rows (r0, r0 + 8) of the kept
// tiles xs, ys and the walked tile's rows of as, bs: S^T = K Q^T and
// dP^T = V dO^T (dK/dV), S = Q K^T and dP = dO V^T (dQ)
template <int LD, int KT, int NT>
__device__ __forceinline__ void two_products(float (*s)[4], float (*dp)[4],
                                             const float* xs, const float* ys,
                                             const float* as, const float* bs,
                                             int r0, int g, int tg) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    float a[4], bf[2 * NT];
    a_frag<LD>(a, xs, r0, kk, tg);
    bt_frags<LD, NT>(bf, as, kk, g, tg);
    mma_3xtf32<NT>(s, SplitA(a), bf);
    a_frag<LD>(a, ys, r0, kk, tg);
    bt_frags<LD, NT>(bf, bs, kk, g, tg);
    mma_3xtf32<NT>(dp, SplitA(a), bf);
  }
}

// acc += (the walked tile's C entries c[0..NT)) * X over the tile, its rows
// the walked side: the tile's share summed in zeroed registers, CW d n-tiles
// at a time, and added to acc by f32 adds.  The tensor core does not round
// the sum it adds into its C operand to nearest (published measurements of
// these units find truncation), so a long sum kept in C drifts with its
// length; here C holds one tile's rows and the tiles join by rounded adds.
// A is given as accumulator entries: the k index tg stands for row 2tg of X
// and tg + 4 for row 2tg + 1.
template <int LD, int KT, int NT, int CW>
__device__ __forceinline__ void tile_times_rows(float (*acc)[4], const float (*c)[4],
                                                const float* t, int g, int tg) {
#pragma unroll
  for (int n0 = 0; n0 < KT; n0 += CW) {
    float part[CW][4];
#pragma unroll
    for (int n = 0; n < CW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float a[4] = {c[kk][0], c[kk][2], c[kk][1], c[kk][3]};
      const SplitA sa(a);
      const float* r = t + (8 * kk + 2 * tg) * LD + g + 8 * n0;
#pragma unroll
      for (int m0 = 0; m0 < CW; m0 += 4) {
        float bf[8];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          bf[2 * n] = r[8 * (m0 + n)];
          bf[2 * n + 1] = r[LD + 8 * (m0 + n)];
        }
        mma_3xtf32<4>(part + m0, sa, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < CW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + n][i] += part[n][i];
  }
}

// The group's ticket after every thread's stores; true in the block that
// drew the last one (which resets it).  Called by every thread.  One
// thread fences for the block, after the barrier that orders the block's
// stores before it (as paged_attention.cu's pool merge does).
__device__ __forceinline__ bool last_of_group(unsigned* tickets, size_t group,
                                              unsigned size) {
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    __threadfence();                     // the block's share, device-wide
    last = atomicAdd(tickets + group, 1u) == size - 1;
    if (last) {
      __threadfence();                   // the other blocks' shares, seen
      tickets[group] = 0u;
    }
  }
  return __syncthreads_or(last);
}

// out rows (key0, key0 + 8) of [*][d] from this thread's fragment entries
// of acc, times mul
template <int KT>
__device__ __forceinline__ void store_rows(float* out, const float (*acc)[4], int key0,
                                           int n_rows, int d, int tg, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + 8 * half;
    if (key >= n_rows) continue;
    float* row = out + (size_t)key * d;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      if (8 * n >= d) break;
      *reinterpret_cast<float2*>(row + 8 * n + 2 * tg) =
          make_float2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

// dk = scale * (share 0 + share 1 + ... + share G-1) and dv the same
// unscaled, in that order, over the block's rows [0, n_rows) of [*][d]
// (ws_k, ws_v: share 0 of those rows, share g at + g * stride): a thread a
// float4 of a row, in passes of PER float4 a thread whose loads of one
// share are all in flight at once (2 above D = 64, where 4 spilled)
template <int DP>
__device__ __forceinline__ void merge_shares(float* dk, float* dv, const float* ws_k,
                                             const float* ws_v, size_t stride,
                                             int group, int n_rows, int d, float scale) {
  constexpr int CH = DP / 4, ALL = kMmaRows * CH / kMmaThreads;
  constexpr int PER = ALL < 8 ? ALL : DP > 64 ? 2 : 8;
  const int nd4 = d / 4;
#pragma unroll 1
  for (int m0 = 0; m0 < ALL; m0 += PER) {
    float4 sk[PER], sv[PER];
    for (int gg = 0; gg < group; ++gg) {
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int e = threadIdx.x + kMmaThreads * (m0 + m), r = e / CH, c = e % CH;
        if (r >= n_rows || c >= nd4) continue;
        const size_t at = gg * stride + (size_t)r * d + 4 * c;
        const float4 xk = __ldcg(reinterpret_cast<const float4*>(ws_k + at));
        const float4 xv = __ldcg(reinterpret_cast<const float4*>(ws_v + at));
        if (gg == 0) {
          sk[m] = xk;
          sv[m] = xv;
        } else {
          sk[m] = make_float4(sk[m].x + xk.x, sk[m].y + xk.y, sk[m].z + xk.z,
                              sk[m].w + xk.w);
          sv[m] = make_float4(sv[m].x + xv.x, sv[m].y + xv.y, sv[m].z + xv.z,
                              sv[m].w + xv.w);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = threadIdx.x + kMmaThreads * (m0 + m), r = e / CH, c = e % CH;
      if (r >= n_rows || c >= nd4) continue;
      const size_t at = (size_t)r * d + 4 * c;
      *reinterpret_cast<float4*>(dk + at) = make_float4(
          sk[m].x * scale, sk[m].y * scale, sk[m].z * scale, sk[m].w * scale);
      *reinterpret_cast<float4*>(dv + at) = sv[m];
    }
  }
}

// The entry point's arguments (layouts: the note at the top)
struct Args {
  const float *q, *k, *v, *out, *dout, *lse;
  float *di, *dq, *dk, *dv, *ws;
  unsigned* tickets;
  int b, h, hkv, sq, sk, d, causal;
};

// dK/dV shares: a block per (batch, head bh, key tile kt of 64), the
// blocks of key tile 0 (the longest walk when causal) first.  It keeps its
// keys' K and V and walks its head's query tiles (from the key tile's
// diagonal when causal) through the ring; at G = 1 it writes dK and dV,
// else its share into ws and the last block of the (batch, kv head, key
// tile) group sums the G shares in head order.
template <int DP>
__device__ __forceinline__ void dkdv_block(const Args& a, int bh, int kt, float scale,
                                           float scale_log2) {
  const float* __restrict__ q = a.q;
  const float* __restrict__ k = a.k;
  const float* __restrict__ v = a.v;
  const float* __restrict__ dout = a.dout;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ di = a.di;
  float* __restrict__ ws = a.ws;
  unsigned* __restrict__ tickets = a.tickets;
  const int h = a.h, hkv = a.hkv, sq = a.sq, sk = a.sk, d = a.d, causal = a.causal;
  using C = MmaCfg<DP>;
  constexpr int LD = C::LD, KT = C::KT, COLS = C::COLS, NT = COLS / 8, CH = C::CH;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [64][LD] keys of the block
  float* vs = ks + kMmaRows * LD;
  float* ring = vs + kMmaRows * LD;       // kStages x (Q, dO, lse, Di)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int group = h / hkv;
  const int b = bh / h, head = bh % h, kvh = head / group, gi = head % group;
  const int k0 = kt * kMmaRows, nd4 = d / 4;
  const size_t kv_off = ((size_t)b * hkv + kvh) * sk * d;
  const float* qh = q + (size_t)bh * sq * d;
  const float* doh = dout + (size_t)bh * sq * d;
  const float* lseh = lse + (size_t)bh * sq;
  const float* dih = di + (size_t)bh * sq;

  for (int e = tid; e < kMmaRows * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    const bool ok = k0 + r < sk && c < nd4;
    const size_t off = kv_off + (size_t)(k0 + r) * d + 4 * c;
    cp16(ks + r * LD + 4 * c, ok ? k + off : k, ok);
    cp16(vs + r * LD + 4 * c, ok ? v + off : v, ok);
  }
  const int t0 = causal ? k0 / COLS : 0;  // first query tile with a kept pair
  const int n_walk = (sq + COLS - 1) / COLS - t0;
  auto load_tile = [&](int j) {           // walked tile j into its stage
    float* qs = ring + (j % kStages) * C::kKvStage;
    float* dos = qs + COLS * LD;
    const int i0 = (t0 + j) * COLS;
    for (int e = tid; e < COLS * CH; e += kMmaThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = i0 + r < sq && c < nd4;
      const size_t off = (size_t)(i0 + r) * d + 4 * c;
      cp16(qs + r * LD + 4 * c, ok ? qh + off : q, ok);
      cp16(dos + r * LD + 4 * c, ok ? doh + off : q, ok);
    }
    float* rows = dos + COLS * LD;        // lse [COLS], then Di [COLS]
    if (tid < 2 * COLS) {
      const int r = tid % COLS;
      const bool ok = i0 + r < sq;
      cp4(rows + tid, ok ? (tid < COLS ? lseh : dih) + i0 + r : lse, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {  // the K/V copies ride with tile 0
    if (j < n_walk) load_tile(j);
    cp_commit();
  }

  const int r0 = warp * 16 + g;           // this thread's keys r0, r0 + 8
  const int key0 = k0 + r0, key1 = key0 + 8;
  float acc_k[KT][4], acc_v[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;

  for (int j = 0; j < n_walk; ++j) {
    cp_wait<kStages - 2>();               // tile j has landed (this thread's copies)
    __syncthreads();                      // ... everyone's; tile j - 1's reads done
    if (j + kStages - 1 < n_walk) load_tile(j + kStages - 1);
    cp_commit();
    const float* qs = ring + (j % kStages) * C::kKvStage;
    const float* dos = qs + COLS * LD;
    const float* lse_s = dos + COLS * LD;
    const float* di_s = lse_s + COLS;
    const int i0 = (t0 + j) * COLS;

    // S^T = K Q^T and dP^T = V dO^T: keys as rows, the tile's queries as
    // columns
    float st[NT][4], dpt[NT][4];
    two_products<LD, KT, NT>(st, dpt, ks, vs, qs, dos, r0, g, tg);
    // P^T and dS^T in place: c0, c1 are key r0's queries 8n + 2tg, +1;
    // c2, c3 key r0 + 8's
    const bool need_mask = i0 + COLS > sq || k0 + kMmaRows > sk ||
                           (causal && i0 < k0 + kMmaRows - 1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = 8 * n + 2 * tg + (c & 1);
        float p = exp2f(fmaf(st[n][c], scale_log2, -(lse_s[qi] * 1.4426950408889634f)));
        if (need_mask) {
          const int i = i0 + qi, key = c < 2 ? key0 : key1;
          if (!(i < sq && key < sk && (!causal || key <= i))) p = 0.f;
        }
        st[n][c] = p;
        dpt[n][c] = p * (dpt[n][c] - di_s[qi]);
      }
    }
    // dV += P^T dO, dK += dS^T Q over the tile's queries
    tile_times_rows<LD, KT, NT, C::CW>(acc_v, st, dos, g, tg);
    tile_times_rows<LD, KT, NT, C::CW>(acc_k, dpt, qs, g, tg);
  }

  if (group == 1) {
    store_rows<KT>(a.dk + kv_off, acc_k, key0, sk, d, tg, scale);
    store_rows<KT>(a.dv + kv_off, acc_v, key0, sk, d, tg, 1.f);
    return;
  }
  // this head's share: ws [2][G][B][Hkv][Sk][D] (dK's shares, then dV's)
  const size_t stride = (size_t)a.b * hkv * sk * d;
  float* wk = ws + kv_off;
  float* wv = wk + group * stride;
  store_rows<KT>(wk + gi * stride, acc_k, key0, sk, d, tg, 1.f);
  store_rows<KT>(wv + gi * stride, acc_v, key0, sk, d, tg, 1.f);
  const int n_kt = (sk + kMmaRows - 1) / kMmaRows;
  if (!last_of_group(tickets, ((size_t)b * hkv + kvh) * n_kt + kt, group)) return;
  const size_t row0 = kv_off + (size_t)k0 * d;
  merge_shares<DP>(a.dk + row0, a.dv + row0, ws + row0, ws + group * stride + row0,
                   stride, group, min(kMmaRows, sk - k0), d, scale);
}

// dQ: a block per (batch, kv head bkvh, positions [q0, q0 + bq)), the
// last (longest, causal) positions first; its 64 rows are the G heads of
// the kv head times bq = 64 / G positions (each K/V tile serves the
// group), Q and dO kept; it walks the key tiles (up to its last row when
// causal) through the ring.
template <int DP>
__device__ __forceinline__ void dq_block(const Args& a, int bkvh, int q0, float scale,
                                         float scale_log2) {
  const float* __restrict__ q = a.q;
  const float* __restrict__ k = a.k;
  const float* __restrict__ v = a.v;
  const float* __restrict__ dout = a.dout;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ di = a.di;
  const int h = a.h, hkv = a.hkv, sq = a.sq, sk = a.sk, d = a.d, causal = a.causal;
  const int group = h / hkv, bq = kMmaRows / group;
  using C = MmaCfg<DP>;
  constexpr int LD = C::LD, KT = C::KT, COLS = C::COLS, NT = COLS / 8, CH = C::CH;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [64][LD] rows of the block
  float* dos = qs + kMmaRows * LD;
  float* lse_s = dos + kMmaRows * LD;     // [64]
  float* di_s = lse_s + kMmaRows;
  float* ring = di_s + kMmaRows;          // kStages x (K, V)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = bkvh / hkv, kvh = bkvh % hkv;
  const int rows = group * bq, nd4 = d / 4;
  const size_t head0 = (size_t)b * h + kvh * group;
  // block row r = (head head0 + r / bq, position q0 + r % bq)
  for (int e = tid; e < kMmaRows * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < rows && q0 + r % bq < sq && c < nd4;
    const size_t off = ((head0 + r / bq) * sq + q0 + r % bq) * d + 4 * c;
    cp16(qs + r * LD + 4 * c, ok ? q + off : q, ok);
    cp16(dos + r * LD + 4 * c, ok ? dout + off : q, ok);
  }
  {
    const int r = tid % kMmaRows;          // lse by threads 0-63, Di by 64-127
    const bool ok = r < rows && q0 + r % bq < sq;
    const size_t row = (head0 + r / bq) * sq + q0 + r % bq;
    cp4(lse_s + tid, ok ? (tid < kMmaRows ? lse : di) + row : lse, ok);
  }

  int kmax = sk;                          // keys this block needs
  if (causal) {
    const int last = q0 + bq < sq ? q0 + bq : sq;
    kmax = last < sk ? last : sk;
  }
  const int n_walk = (kmax + COLS - 1) / COLS;
  const size_t kv_off = ((size_t)b * hkv + kvh) * sk * d;
  auto load_tile = [&](int j) {
    float* ks = ring + (j % kStages) * C::kQStage;
    float* vs = ks + COLS * LD;
    const int j0 = j * COLS;
    for (int e = tid; e < COLS * CH; e += kMmaThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = j0 + r < kmax && c < nd4;
      const size_t off = kv_off + (size_t)(j0 + r) * d + 4 * c;
      cp16(ks + r * LD + 4 * c, ok ? k + off : k, ok);
      cp16(vs + r * LD + 4 * c, ok ? v + off : k, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {  // the Q/dO copies ride with tile 0
    if (j < n_walk) load_tile(j);
    cp_commit();
  }

  const int r0 = warp * 16 + g, r1 = r0 + 8;   // this thread's two rows
  const int pos0 = q0 + r0 % bq, pos1 = q0 + r1 % bq;
  const bool row0 = r0 < rows && pos0 < sq, row1 = r1 < rows && pos1 < sq;
  const bool rows_full = rows == kMmaRows && q0 + bq <= sq;
  float acc[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int j = 0; j < n_walk; ++j) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < n_walk) load_tile(j + kStages - 1);
    cp_commit();
    const float* ks = ring + (j % kStages) * C::kQStage;
    const float* vs = ks + COLS * LD;
    const int k0 = j * COLS;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows
    float s[NT][4], dp[NT][4];
    two_products<LD, KT, NT>(s, dp, qs, dos, ks, vs, r0, g, tg);
    // dS in place: c0, c1 are row r0's keys 8n + 2tg, +1; c2, c3 row r1's
    const bool need_mask = k0 + COLS > kmax || !rows_full ||
                           (causal && k0 + COLS - 1 > q0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c < 2 ? r0 : r1;
        float p = exp2f(fmaf(s[n][c], scale_log2, -(lse_s[r] * 1.4426950408889634f)));
        if (need_mask) {
          const int col = k0 + 8 * n + 2 * tg + (c & 1);
          const int pos = c < 2 ? pos0 : pos1;
          if (!((c < 2 ? row0 : row1) && col < kmax && (!causal || col <= pos))) p = 0.f;
        }
        s[n][c] = p * (dp[n][c] - di_s[r]);
      }
    }
    // dQ += dS K over the tile's keys
    tile_times_rows<LD, KT, NT, C::CW>(acc, s, ks, g, tg);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? row1 : row0)) continue;
    const int r = half ? r1 : r0;
    const int pos = half ? pos1 : pos0;
    float* dq_row = a.dq + ((head0 + r / bq) * sq + pos) * d;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      if (8 * n >= d) break;
      *reinterpret_cast<float2*>(dq_row + 8 * n + 2 * tg) =
          make_float2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
  }
}

// The tensor-core route's blocks in one order, the dK/dV blocks (B * H a
// key tile, key tile 0 first), then the dQ blocks (B * Hkv a query tile,
// the last first): this launch runs blocks [first, first + gridDim.x) of
// it, so one launch takes both and the dQ blocks fill the dK/dV blocks'
// tail (kernels/ref.py: flash_bwd_plan)
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, MmaCfg<DP>::KV_BLOCKS)
flash_bwd_mma_kernel(const Args a, int first, float scale, float scale_log2) {
  const int i = first + blockIdx.x, heads = a.b * a.h;
  const int kv_blocks = heads * ((a.sk + kMmaRows - 1) / kMmaRows);
  if (i < kv_blocks) {
    dkdv_block<DP>(a, i % heads, i / heads, scale, scale_log2);
    return;
  }
  const int j = i - kv_blocks, rows = a.b * a.hkv, bq = kMmaRows / (a.h / a.hkv);
  const int n_qt = (a.sq + bq - 1) / bq;
  dq_block<DP>(a, j % rows, (n_qt - 1 - j / rows) * bq, scale, scale_log2);
}

// -- the launchers -------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DP>
cudaError_t launch_mma(const Args& a, int group, float scale, float scale_log2,
                       cudaStream_t stream) {
  using C = MmaCfg<DP>;
  constexpr size_t smem = C::kKvSmem > C::kQSmem ? C::kKvSmem : C::kQSmem;
  static bool smem_set = false;      // once per instantiation
  cudaError_t err;
  if (!smem_set) {
    if ((err = allow_smem(flash_bwd_mma_kernel<DP>, smem)) != cudaSuccess) return err;
    smem_set = true;
  }
  const int bq = kMmaRows / group;
  const int kv_blocks = a.b * a.h * ((a.sk + kMmaRows - 1) / kMmaRows);
  const int q_blocks = a.b * a.hkv * ((a.sq + bq - 1) / bq);
  auto launch = [&](int first, int count) {
    flash_bwd_mma_kernel<DP><<<count, kMmaThreads, smem, stream>>>(a, first, scale,
                                                                  scale_log2);
    return cudaGetLastError();
  };
  return launch(0, kv_blocks + q_blocks);
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

// di is scratch [B, H, Sq] f32 the caller allocates.  On the tensor-core
// route (D <= 128, 1 < G <= 64) ws is scratch [2, G, B, Hkv, Sk, D] f32 and
// tickets n_tickets >= B * Hkv * ceil(Sk / 64) zeroed uint32 (the kernel
// leaves them zeroed); otherwise both may be null.  Returns
// cudaGetLastError() after the last launch (0 on success), the first launch
// error, or cudaErrorInvalidValue for a shape the kernels do not take.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* lse,
                            void* di, void* dq, void* dk, void* dv, void* ws,
                            void* tickets, int n_tickets, int b, int h, int hkv,
                            int sq, int sk, int d, int causal, void* stream) {
  if (b < 1 || hkv < 1 || h % hkv || sq < 1 || sk < 1 || b > 65535 ||
      h > 65535 || (causal && sq != sk) || d < 8 || d > 256 || d % 8 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      !aligned(dout) || !aligned(dq) || !aligned(dk) || !aligned(dv) ||
      lse == nullptr || di == nullptr)
    return (int)cudaErrorInvalidValue;
  const int group = h / hkv;
  if (d <= 128 && group <= kMmaRows) {
    const long key_tiles = (sk + kMmaRows - 1) / kMmaRows;
    const long query_tiles = (sq + kMmaRows / group - 1) / (kMmaRows / group);
    if ((long)b * h * key_tiles + (long)b * hkv * query_tiles > 2147483647L ||
        (group > 1 && (ws == nullptr || !aligned(ws) || tickets == nullptr ||
                       n_tickets < (long)b * hkv * key_tiles)))
      return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(out),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(di),         static_cast<float*>(dq),
               static_cast<float*>(dk),         static_cast<float*>(dv),
               static_cast<float*>(ws),         static_cast<unsigned*>(tickets),
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
