// Flash-attention backward (K8 dq, K9 dk/dv) for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernels of the JAX package's
// src/repro/kernels/flash_attention.py:_bwd (_bwd_dq_kernel and
// _bwd_dkv_kernel).  From the forward's saved q, k, v [B, T|M, H, hd] and
// f32 lse [B*H, T] (K7), and the output's gradient do [B, T, H, hd], they
// recompute the probabilities tile by tile and never hold a [T, M] matrix:
//
//   s[t, m]  = (q[t] . k[m]) * scale,        scale = 1 / sqrt(hd)
//   p[t, m]  = exp(s[t, m] - lse[t])          where (t, m) is visible, else 0
//   dp[t, m] = do[t] . v[m]
//   delta[t] = sum_m p[t, m] dp[t, m]         f32, written by K8 for K9
//   ds[t, m] = p[t, m] * (dp[t, m] - delta[t])
//   dq[t]    = scale * sum_m ds[t, m] k[m]                        (K8)
//   dk[m]    = scale * sum_t ds[t, m] q[t],  dv[m] = sum_t p[t, m] do[t]  (K9)
//
// with f32 sums whatever the input type, and dq, dk, dv in the input type.
// delta is rowsum(o * do) for the f32 o before its rounding to the input
// type: the JAX kernels read the stored o, and in bf16 its rounding (up to
// 2^-9 of o) moves dq and dk by more than one bf16 ulp from the reference's
// gradient, so K8 sums delta from the f32 products p * dp.
// (t, m) is visible when (!causal or t - m >= 0) and (window <= 0 or
// t - m < window), as in K7.
//
// Rows that see no key (only when window > 0 and t >= M + window - 1): the
// reference gives them a uniform softmax over their -1e30 scores, so o[t]
// is the mean of v, and its gradient sends do[t] / M to every dv row and
// nothing to dq[t] or to any dk (the masked scores are constants).  Their
// lse, -1e30 + log(M), rounds to -1e30 in f32, so exp(s - lse) would give
// p = 1 for every key; both kernels find such rows by their position and
// use p = 1/M, ds = 0 for them instead.
//
// The route is chosen by the input type; neither falls back to the other:
//   bf16 -> flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel, on the
//           tensor cores (wgmma, bf16 operands, f32 sums, fed by TMA);
//   f32  -> flash_bwd_dq_kernel, flash_bwd_dkv_kernel, SIMT in f32: the f32
//           limit, 2e-4 (|g| + rms), leaves no room for bf16 or TF32
//           operands.
//
// Bound: operations in bf16, bytes in f32 at the driver's shape.  At the
// training shape (B*H 32, T = M 4096, hd 256, bf16) the causal layer has
// 268.5 M visible pairs: dq needs 6*hd FLOP per pair (the two dots and the
// dq update), 4.12e11, 0.417 ms at the card's 989 TFLOP/s of bf16; dk and
// dv 8*hd (two dots, dk and dv), 0.556 ms.  At the fault-tolerant driver's
// [8, 64, 10, 64] f32 the causal mask has 166,400 visible pairs: 6*hd and
// 8*hd FLOP a pair take 0.00095 and 0.00127 ms at 67 TFLOP/s of f32, less
// than reading q, k, v, do (and writing dq, or dk and dv) once at 3.35
// TB/s, 0.00197 and 0.00236 ms.  There the kernels are short: a launch
// with nothing to do costs ~0.005 ms, and what a kernel adds to it is the
// latency of one round of tile loads and of its products.
//
// The tensor-core kernels (bf16), warp-specialised as K7's: a producer
// warpgroup whose one thread keeps TMA loads in flight through a 2-stage
// ring of shared memory guarded by mbarriers, and two consumer warpgroups
// (setmaxnreg 24 / 240).  Every product has bf16 operands and f32 sums;
// p = 2^fmaf(s, scale*log2e, -lse*log2e) by the SFU's ex2.approx, in the
// domain K7 wrote lse in.  p (into dv) and ds (into dq and dk) go into
// their products as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi):
// at [1, 2048, 2, 256] causal one term misses chip_smoke.grad_err's
// element-wise limit by 8.95x (dv), 6.62x (dk) and 6.13x (dq) in the CPU
// emulation of tests/test_torch_flash_attention_bwd.py, and over its 41
// cases two terms stay within 0.91 of it.
//   * K8: a consumer warpgroup owns 64 query rows (two a block) and their
//     dq accumulator; q and do stay in shared memory, k and v tiles of 64
//     keys stream through their rings twice.  The first sweep computes
//     S = Q K^T and dP = dO V^T and sums delta = rowsum(p * dp) in f32; the
//     second recomputes them, forms ds = p (dp - delta) and adds dS K (K
//     read MN-major from the same tile) into dq.  10*hd FLOP a pair, plus
//     2*hd for the lo term, against the bound's 6*hd.  v is free once dP
//     is done, k only once dS K is: so at hd 256, where q and do of 128
//     rows take 128 KB, k keeps two stages and v one (the next v loads
//     while ds and dS K run); 32-key tiles with two stages of both were
//     25% slower (their m64n32 products read more shared memory a FLOP).
//   * K9: a block owns 64 key rows; k and v stay in shared memory, q and do
//     tiles (64 queries) stream through the ring, over the queries in
//     [k_first, k_last + window - 1] (pruned at both ends) and then the
//     rows that see no key; beside each, the producer's threads stage its
//     64 lse*log2e and delta values, so the consumers hold no column
//     arrays.  Both consumers compute S^T = K Q^T and p^T: one owns
//     dV += P^T dO, the other also computes dP^T = V dO^T, forms ds^T and
//     owns dK += dS^T Q.  So each holds one 64 x hd f32 accumulator (128
//     registers a thread at hd 256), neither waits on the other, and the
//     block owns its dk and dv rows: no atomics.  S^T twice makes 14*hd
//     FLOP a pair against 12*hd; handing p^T from one consumer to the
//     other through shared memory (named barriers) made the second wait on
//     the first every tile, and was 16% slower.
//   * whole tiles outside the visible span are skipped; only tiles on a
//     diagonal, a window edge, or past T or M take the per-element mask.
//   * T and M need not be multiples of a tile: TMA fills rows past T or M
//     with zeros, which take no weight and are not stored.
//   * the [B, T, H, hd] layout is read in place by 4-D tensor maps.
// Shared memory at hd 256: K8 230,456 bytes (q and do 128 KB, two stages of
// k and one of v 96 KB), K9 198,696 (k and v 64 KB, two stages of q, do
// and their columns 129 KB); one block (3 warpgroups) an SM.
//
// The SIMT kernels (f32), 128 threads a block:
//   * a block owns BR = 16 rows (K8 query rows, K9 key rows), so the
//     driver's [8, 64, 10, 64] makes 320 blocks for 132 SMs.  The grid is
//     one-dimensional and tile-major, so every (b, h)'s heaviest tile comes
//     first: under a causal mask K8's last query tile, K9's first key tile.
//   * the block's own rows (q and do, or k and v) stay in shared memory; the
//     other side (k and v, or q, do and their lse and delta) streams in
//     tiles of BN rows (64 at hd <= 64, 32 at hd 128, 16 at hd 256) through
//     a ring of cp.async copies: the next tile is issued before the current
//     one is computed.  The ring has two stages when some block streams two
//     tiles or more, else one (the launcher bounds the tiles a block takes;
//     at the driver's shape every block takes one, and blocks of 47 or
//     52 KB at 158 registers a thread leave room for three an SM: all 320
//     run at once).  Rows past T or M land as zeros.
//   * S = Q K^T and dP = dO V^T of a tile as 2 x SC micro-tiles a thread
//     (rows r and r + 8; columns c, c + 4, ...: 2 x 4 at hd <= 64), with
//     8 independent accumulators a product, operands read from shared
//     memory as float4 (staged rows padded to 4 banks apart), no shuffles.
//     A warp owns a quarter of the tile's columns and skips them when none
//     is in the tile's span (a causal diagonal).  p = exp(s*scale - lse)
//     where visible, else 0; ds = p (dp - delta) go to shared memory, and
//     the tile's dQ (or dK and dV) product reads them back, its [16, hd]
//     accumulators held in registers a float4 chunk at a time.  At the
//     driver's shape the copies, masks and stores take ~4 us of a launch
//     and the products ~4 us more; handing S and dP to two halves of the
//     block as 4 x 4 micro-tiles (a third fewer shared-memory loads a FMA)
//     did not make the products faster (tools/fa_bwd_probe.py, PERF.md).
//   * K8 makes two sweeps over the keys when they take more than one tile,
//     as the tensor-core kernel does: the first sums delta from the f32
//     p * dp, the second recomputes S and dP and forms ds = p (dp - delta)
//     directly.  That costs 10*hd FLOP a pair instead of the one-pass
//     identity's 8*hd (dq = scale (sum p dp k - delta sum p k)), but ds
//     never comes from the difference of two large sums, and one
//     accumulator instead of two leaves room at hd 256.  When the keys
//     fit one tile (every block at the driver's shape) one sweep does both.
//   * K9 owns its dk and dv rows (no atomics); after the queries that see
//     its keys it streams the rows that see no key through the same ring,
//     do alone, with p = 1/M into dv and ds = 0.
// Build flags keep --fmad=false (K1-K4 rely on it); the kernels ask for
// their FMAs explicitly (fmaf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

// ------------------------------------------------------------ f32: SIMT
constexpr int kThreads = 128;          // 4 warps
constexpr int BR = 16;                 // rows a block owns: K8 q, K9 k

// The f32 tiles at head_dim HD: the other side streams in tiles of BN rows;
// rows in shared memory are LD floats apart (HD + 4: 4 banks apart), the
// p and ds arrays [BR][PLD].  A thread's S and dP micro-tile is 2 x SC;
// the [BR, HD] accumulators are split into CG column groups of ACH float4
// chunks (chunk c of group g at column 4 (g + CG c)) and RG row groups of
// AR rows (row a of group r: r + RG a; at hd 16, RG = 32 and half idle).
template <int HD>
struct Simt {
  static constexpr int BN = HD <= 64 ? 64 : (HD == 128 ? 32 : 16);
  static constexpr int LD = HD + 4;
  static constexpr int PLD = BN + 4;
  static constexpr int SC = BN / 16;
  static constexpr int CG = HD / 4 < 16 ? HD / 4 : 16;
  static constexpr int ACH = HD / (4 * CG);
  static constexpr int RG = kThreads / CG;
  static constexpr int AR = RG >= BR ? 1 : BR / RG;
  static_assert(BN % 16 == 0 && ACH * 4 * CG == HD && AR * RG >= BR,
                "f32 tiles");
  // dynamic shared memory a block of K8 (dkv false) or K9 takes: its own
  // rows, the ring's stages (K9's with their lse and delta), p / ds, and
  // K8's delta partials by warp
  static constexpr int smem(bool dkv, int stages) {
    return 4 * (2 * BR * LD + stages * (2 * BN * LD + (dkv ? 2 * BN : 0)) +
                (dkv ? 2 : 1) * BR * PLD + (dkv ? 0 : 4 * BR));
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float lane4(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ bool visible(int d, int causal, int window) {
  return (!causal || d >= 0) && (window <= 0 || d < window);
}

// 16 or 4 bytes global -> shared by cp.async; zeros when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy rows [r0, r0 + n) of a [B, L, H, hd] tensor (base at (b, 0, h, 0),
// row stride rs) into dst[ROWS][LD]; rows n.. become zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* base,
                                          int64_t rs, int r0, int n) {
  constexpr int C4 = HD / 4;
  for (int e = threadIdx.x; e < ROWS * C4; e += kThreads) {
    const int j = e / C4, c = 4 * (e % C4);
    const bool ok = j < n;
    cp_async16(dst + j * Simt<HD>::LD + c,
               base + (int64_t)(r0 + (ok ? j : 0)) * rs + c, ok);
  }
}

// K9's query tiles: those that see the block's keys, [lo, hi) in n0
// tiles of bn, then the rows that see no key, [blind, T)
struct QTiles {
  int lo, hi, blind, T, n0, bn;
  __device__ __forceinline__ int first(int i) const {
    return i < n0 ? lo + i * bn : blind + (i - n0) * bn;
  }
  __device__ __forceinline__ int span(int i) const {
    return min(bn, (i < n0 ? hi : T) - first(i));
  }
};

// Query tile i of K9 into the stage at dst: do, and for the queries that
// see the keys also q and their lse and delta (base pointers at (b, h))
template <int HD>
__device__ __forceinline__ void copy_queries(float* dst, const QTiles& g,
                                             int i, const float* qb,
                                             const float* ob, const float* lb,
                                             const float* eb, int64_t rs) {
  constexpr int BN = Simt<HD>::BN, LD = Simt<HD>::LD;
  const int t0 = g.first(i), nt = g.span(i);
  copy_rows<HD, BN>(dst + BN * LD, ob, rs, t0, nt);
  if (i >= g.n0) return;                 // a row that sees no key: do alone
  copy_rows<HD, BN>(dst, qb, rs, t0, nt);
  const int tid = threadIdx.x, j = tid % BN;
  if (tid < 2 * BN)
    cp_async4(dst + 2 * BN * LD + tid,
              (tid < BN ? lb : eb) + t0 + (j < nt ? j : 0), j < nt);
}

// s[r][i] = X[row r] . Xt[col i] and dp[r][i] = Y[row r] . Yt[col i] over
// hd, for rows rg and rg + 8 of the block's own X, Y and columns c + 4i of
// the streamed tile Xt, Yt: 4 SC independent f32 dot products.
template <int HD>
__device__ __forceinline__ void tile_dots(const float* X, const float* Y,
                                          const float* Xt, const float* Yt,
                                          int rg, int c,
                                          float (&s)[2][Simt<HD>::SC],
                                          float (&dp)[2][Simt<HD>::SC]) {
  using G = Simt<HD>;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < G::SC; ++i) s[r][i] = dp[r][i] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 x0 = load4(X + rg * G::LD + d);
    const float4 x1 = load4(X + (rg + 8) * G::LD + d);
    const float4 y0 = load4(Y + rg * G::LD + d);
    const float4 y1 = load4(Y + (rg + 8) * G::LD + d);
#pragma unroll
    for (int i = 0; i < G::SC; ++i) {
      const float4 xt = load4(Xt + (c + 4 * i) * G::LD + d);
      const float4 yt = load4(Yt + (c + 4 * i) * G::LD + d);
      s[0][i] = dot4(x0, xt, s[0][i]);
      s[1][i] = dot4(x1, xt, s[1][i]);
      dp[0][i] = dot4(y0, yt, dp[0][i]);
      dp[1][i] = dot4(y1, yt, dp[1][i]);
    }
  }
}

// acc[a][c] += sum_{j < nj} P[row a][j] * Z[j][chunk c], for this thread's
// rows ar + RG a and chunks 4 (cg + CG c); nj is a multiple of 4.
template <int HD>
__device__ __forceinline__ void tile_axpy(
    const float* P, const float* Z, int nj, int ar, int cg,
    float4 (&acc)[Simt<HD>::AR][Simt<HD>::ACH]) {
  using G = Simt<HD>;
  for (int j = 0; j < nj; j += 4) {
    float4 pr[G::AR];
#pragma unroll
    for (int a = 0; a < G::AR; ++a)
      pr[a] = load4(P + (ar + G::RG * a) * G::PLD + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < G::ACH; ++c) {
        const float4 z = load4(Z + (j + jj) * G::LD + 4 * (cg + G::CG * c));
#pragma unroll
        for (int a = 0; a < G::AR; ++a) axpy4(lane4(pr[a], jj), z, acc[a][c]);
      }
  }
}

// ------------------------------------------------------------ K8, f32 SIMT
// Both f32 kernels are bounded (kThreads, 1): with no minimum of blocks
// ptxas picked a register count of its own and spilled a few bytes at hd 16
// and 32 to reach it; a minimum of 4 at hd <= 64 (128 registers) spilled
// too.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int B, int T_len, int M, int H,
                    int causal, int window, float scale, int stages) {
  using G = Simt<HD>;
  constexpr int LD = G::LD, BN = G::BN, SC = G::SC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BR][LD] the block's q rows
  float* Os = Qs + BR * LD;                  // [BR][LD] and do rows
  float* ring = Os + BR * LD;                // stages x (k, v) [BN][LD]
  float* Ps = ring + stages * 2 * BN * LD;   // [BR][PLD] ds of a tile
  float* red = Ps + BR * G::PLD;             // [4][BR] delta by warp

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane % 8, col = 4 * SC * warp + lane / 8;  // S: rows, keys
  const int ar = tid / G::CG, cg = tid % G::CG;             // dq's share
  const int bhn = B * H, bh = blockIdx.x % bhn, b = bh / H, h = bh % H;
  const int nq = (T_len + BR - 1) / BR, rank = blockIdx.x / bhn;
  const int q0 = (causal ? nq - 1 - rank : rank) * BR;   // heaviest first
  const int q_last = min(q0 + BR, T_len) - 1;
  const int hi = causal ? min(M, q_last + 1) : M;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n = hi > lo ? (hi - lo + BN - 1) / BN : 0;   // key tiles
  const int iters = n > 1 ? 2 * n : n;   // two sweeps unless one tile
  const int64_t rs = (int64_t)H * HD, hoff = (int64_t)h * HD;
  const float* kb = k + (int64_t)b * M * rs + hoff;
  const float* vb = v + (int64_t)b * M * rs + hoff;
  copy_rows<HD, BR>(Qs, q + (int64_t)b * T_len * rs + hoff, rs, q0,
                    q_last - q0 + 1);
  copy_rows<HD, BR>(Os, dout + (int64_t)b * T_len * rs + hoff, rs, q0,
                    q_last - q0 + 1);
  if (n > 0) {                           // key tile 0 into stage 0
    copy_rows<HD, BN>(ring, kb, rs, lo, min(BN, hi - lo));
    copy_rows<HD, BN>(ring + BN * LD, vb, rs, lo, min(BN, hi - lo));
  }
  float lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + rg + 8 * r;
    lr[r] = t < T_len ? lse[(int64_t)bh * T_len + t] : 0.0f;
  }

  float part[2] = {0.0f, 0.0f}, dl[2] = {0.0f, 0.0f};
  float4 acc[G::AR][G::ACH];
#pragma unroll
  for (int a = 0; a < G::AR; ++a)
#pragma unroll
    for (int c = 0; c < G::ACH; ++c) acc[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < iters; ++it) {
    const int t0 = lo + (it % n) * BN, nk = min(BN, hi - t0);
    const float* Ks = ring + (it % stages) * 2 * BN * LD;
    const float* Vs = Ks + BN * LD;
    cp_async_wait_all();
    __syncthreads();       // tile it landed; the other stage and Ps are free
    if (it + 1 < iters) {                // key tile it + 1 into its stage
      const int u0 = lo + (it + 1) % n * BN;
      float* dst = ring + (it + 1) % stages * 2 * BN * LD;
      copy_rows<HD, BN>(dst, kb, rs, u0, min(BN, hi - u0));
      copy_rows<HD, BN>(dst + BN * LD, vb, rs, u0, min(BN, hi - u0));
    }
    const bool busy = 4 * SC * warp < nk;   // the warp's keys in the span
    float p[2][SC], dp[2][SC];
    if (busy) {
      float s[2][SC];
      tile_dots<HD>(Qs, Os, Ks, Vs, rg, col, s, dp);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < SC; ++i) {
          const int t = q0 + rg + 8 * r, j = col + 4 * i;
          const bool seen = j < nk && t < T_len &&
                            visible(t - (t0 + j), causal, window);
          p[r][i] = seen ? expf(s[r][i] * scale - lr[r]) : 0.0f;
          if (it < n) part[r] = fmaf(p[r][i], dp[r][i], part[r]);
        }
    }
    if (it == n - 1) {     // the first sweep is done: delta of each row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float d = part[r];
        d += __shfl_xor_sync(0xffffffffu, d, 8);
        d += __shfl_xor_sync(0xffffffffu, d, 16);
        if (lane < 8) red[warp * BR + rg + 8 * r] = d;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r)
        dl[r] = red[rg + 8 * r] + red[BR + rg + 8 * r] +
                red[2 * BR + rg + 8 * r] + red[3 * BR + rg + 8 * r];
    }
    if (it < iters - n) continue;           // the first of two sweeps
    if (busy)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < SC; ++i)
          Ps[(rg + 8 * r) * G::PLD + col + 4 * i] =
              p[r][i] * (dp[r][i] - dl[r]);
    __syncthreads();
    if (ar < BR) tile_axpy<HD>(Ps, Ks, (nk + 3) & ~3, ar, cg, acc);
  }
  cp_async_wait_all();

  if (warp == 0 && lane < 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + rg + 8 * r;
      if (t < T_len) delta[(int64_t)bh * T_len + t] = dl[r];
    }
#pragma unroll
  for (int a = 0; a < G::AR; ++a) {
    const int t = q0 + ar + G::RG * a;
    if (ar + G::RG * a >= BR || t >= T_len) continue;
    float* row = dq + ((int64_t)b * T_len + t) * rs + hoff;
#pragma unroll
    for (int c = 0; c < G::ACH; ++c) {
      const float4 x = acc[a][c];
      store4(row + 4 * (cg + G::CG * c),
             make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
    }
  }
}

// ------------------------------------------------------------ K9, f32 SIMT
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int B, int T_len, int M, int H,
                     int causal, int window, float scale, int stages) {
  using G = Simt<HD>;
  constexpr int LD = G::LD, BN = G::BN, SC = G::SC;
  constexpr int STAGE = 2 * BN * LD + 2 * BN;  // q, do [BN][LD]; lse, delta
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                          // [BR][LD] the block's k rows
  float* Vs = Ks + BR * LD;                  // [BR][LD] and v rows
  float* ring = Vs + BR * LD;                // stages x STAGE
  float* Ps = ring + stages * STAGE;         // [BR][PLD] p^T of a tile
  float* Ss = Ps + BR * G::PLD;              // [BR][PLD] ds^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane % 8, col = 4 * SC * warp + lane / 8;  // S^T: keys, q
  const int ar = tid / G::CG, cg = tid % G::CG;             // dk/dv's share
  const int bhn = B * H, bh = blockIdx.x % bhn, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x / bhn * BR;  // the heaviest causal tiles first
  const int k_last = min(k0 + BR, M) - 1;
  // the queries these keys see, [lo, hi), in n0 tiles; then the rows that
  // see no key, [blind, T)
  const int blind = window > 0 ? min(T_len, M + window - 1) : T_len;
  const int lo = causal ? k0 : 0;
  const int hi = min(window > 0 ? min(T_len, k_last + window) : T_len, blind);
  const int n0 = hi > lo ? (hi - lo + BN - 1) / BN : 0;
  const int n = n0 + (T_len - blind + BN - 1) / BN;
  const QTiles g{lo, hi, blind, T_len, n0, BN};
  const int64_t rs = (int64_t)H * HD, hoff = (int64_t)h * HD;
  const float* qb = q + (int64_t)b * T_len * rs + hoff;
  const float* ob = dout + (int64_t)b * T_len * rs + hoff;
  const float* lb = lse + (int64_t)bh * T_len;
  const float* eb = delta + (int64_t)bh * T_len;

  copy_rows<HD, BR>(Ks, k + (int64_t)b * M * rs + hoff, rs, k0,
                    k_last - k0 + 1);
  copy_rows<HD, BR>(Vs, v + (int64_t)b * M * rs + hoff, rs, k0,
                    k_last - k0 + 1);
  if (n > 0) copy_queries<HD>(ring, g, 0, qb, ob, lb, eb, rs);

  const float inv_m = 1.0f / (float)M;
  float4 dka[G::AR][G::ACH], dva[G::AR][G::ACH];
#pragma unroll
  for (int a = 0; a < G::AR; ++a)
#pragma unroll
    for (int c = 0; c < G::ACH; ++c)
      dka[a][c] = dva[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < n; ++i) {
    const int t0 = g.first(i), nt = g.span(i);
    const float* Qt = ring + (i % stages) * STAGE;
    const float* Ot = Qt + BN * LD;
    const float* Lt = Ot + BN * LD;      // lse of the tile's queries
    const float* Et = Lt + BN;           // and delta
    cp_async_wait_all();
    __syncthreads();       // tile i landed; the other stage and Ps are free
    if (i + 1 < n)
      copy_queries<HD>(ring + (i + 1) % stages * STAGE, g, i + 1, qb, ob, lb,
                       eb, rs);
    const bool busy = 4 * SC * warp < nt;   // the warp's queries in the span
    if (i < n0) {
      if (busy) {
        float s[2][SC], dp[2][SC];
        tile_dots<HD>(Ks, Vs, Qt, Ot, rg, col, s, dp);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < SC; ++c) {
            const int m = k0 + rg + 8 * r, j = col + 4 * c;
            const bool seen = j < nt && m < M &&
                              visible(t0 + j - m, causal, window);
            const float p = seen ? expf(s[r][c] * scale - Lt[j]) : 0.0f;
            Ps[(rg + 8 * r) * G::PLD + j] = p;
            Ss[(rg + 8 * r) * G::PLD + j] = p * (dp[r][c] - Et[j]);
          }
      }
      __syncthreads();
      if (ar < BR) {
        tile_axpy<HD>(Ps, Ot, (nt + 3) & ~3, ar, cg, dva);
        tile_axpy<HD>(Ss, Qt, (nt + 3) & ~3, ar, cg, dka);
      }
      continue;
    }
    if (busy)              // rows that see no key: p = 1/M, ds = 0
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          const int j = col + 4 * c;
          Ps[(rg + 8 * r) * G::PLD + j] =
              j < nt && k0 + rg + 8 * r < M ? inv_m : 0.0f;
        }
    __syncthreads();
    if (ar < BR) tile_axpy<HD>(Ps, Ot, (nt + 3) & ~3, ar, cg, dva);
  }
  cp_async_wait_all();

#pragma unroll
  for (int a = 0; a < G::AR; ++a) {
    const int m = k0 + ar + G::RG * a;
    if (ar + G::RG * a >= BR || m >= M) continue;
    const int64_t off = ((int64_t)b * M + m) * rs + hoff;
#pragma unroll
    for (int c = 0; c < G::ACH; ++c) {
      const int cc = 4 * (cg + G::CG * c);
      const float4 x = dka[a][c];
      store4(dk + off + cc, make_float4(x.x * scale, x.y * scale,
                                        x.z * scale, x.w * scale));
      store4(dv + off + cc, dva[a][c]);
    }
  }
}

// ------------------------------------------------- bf16: the tensor cores
constexpr int kConsumerWGs = 2;
constexpr int kThreadsWG = 128 * (kConsumerWGs + 1);  // + the producer's
constexpr int kStages = 2;

// K8's tiles: 64 query rows a consumer warpgroup, key tiles of 64 rows;
// k in a ring of kStages, v in one of VST (one at hd 256, where q and do
// of 128 rows take 128 KB: v is free once dP is done, so the next v loads
// while dS K runs)
template <int HD>
struct DQ {
  static constexpr int VST = HD == 256 ? 1 : kStages;
  static constexpr int TILE = 64 * HD * 2;         // 64 rows of q, do, k, v
  // q and do of both warpgroups, the rings of k and v, barriers; +1024 to
  // align the tiles
  static constexpr int SMEM = (2 * kConsumerWGs + kStages + VST) * TILE +
                              8 * (1 + 2 * kStages + 2 * VST) + 1024;
};

// K9's tiles: 64 key rows a block, query tiles of 64 rows
template <int HD>
struct DKV {
  static constexpr int TILE = 64 * HD * 2;         // one tile of k, v, q, do
  static constexpr int COLS = 2 * 64 * 4;          // lse*log2e, delta: f32
  // k, v, the ring of (q, do, their columns), barriers; +1024 to align
  static constexpr int SMEM = 2 * TILE + kStages * (2 * TILE + COLS) +
                              8 * (1 + 2 * kStages) + 1024;
};

// The 64-key tiles [lo_t, hi_t) that query rows [qa, qb] see.
__device__ __forceinline__ void dq_key_tiles(int qa, int qb, int M,
                                             int causal, int window,
                                             int& lo_t, int& hi_t) {
  const int hi = causal ? min(M, qb + 1) : M;
  const int lo = window > 0 ? max(0, qa - window + 1) : 0;
  lo_t = lo / 64;
  hi_t = hi > lo ? (hi + 63) / 64 : lo_t;
}

// ----------------------------------------------------------------- K8, bf16
template <int HD>
__global__ void __launch_bounds__(kThreadsWG, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int T_len, int M,
                          int H, int causal, int window, float scale_log2,
                          float scale) {
  using C = DQ<HD>;
  constexpr int BKC = 64;              // keys a tile
  constexpr int NT = BKC / 8;          // key n-tiles of S and dP
  constexpr int DT = HD / 8;           // head_dim n-tiles of dq
  extern __shared__ uint8_t smem_dq[];
  const uint32_t base = (smem_u32(smem_dq) + 1023) & ~1023u;
  const uint32_t q_s = base;                              // 2 x [NB][64][SW]
  const uint32_t do_s = q_s + kConsumerWGs * C::TILE;     // 2 x [NB][64][SW]
  const uint32_t k_s = do_s + kConsumerWGs * C::TILE;     // ring [NB][64][SW]
  const uint32_t v_s = k_s + kStages * C::TILE;           // ring of VST
  const uint32_t q_full = v_s + C::VST * C::TILE;
  // k landed and free (dS K done) per k stage, v landed and free (dP
  // done) per v stage
  const uint32_t full_k = q_full + 8, empty_k = full_k + 8 * kStages;
  const uint32_t full_v = empty_k + 8 * kStages;
  const uint32_t empty_v = full_v + 8 * C::VST;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int rows = 64 * kConsumerWGs;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * rows;
  int kt_lo, kt_hi;
  dq_key_tiles(q0, min(q0 + rows, T_len) - 1, M, causal, window, kt_lo,
               kt_hi);
  const int ntiles = kt_hi - kt_lo;    // per sweep
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 128 * kConsumerWGs);
    }
    for (int s = 0; s < C::VST; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 128 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // the producer: q and do once, then the key tiles twice (two sweeps)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumerWGs) {
      mbar_expect_tx(q_full, 2 * kConsumerWGs * C::TILE);
      for (int r = 0; r < kConsumerWGs; ++r) {
        tma_tile<HD>(q_s + r * C::TILE, &tq, q_full, h, q0 + 64 * r, b);
        tma_tile<HD>(do_s + r * C::TILE, &tdo, q_full, h, q0 + 64 * r,
                     b);
      }
      for (int i = 0; i < 2 * ntiles; ++i) {
        const int kt = kt_lo + i % ntiles, s = i % kStages, sv = i % C::VST;
        mbar_wait(empty_k + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, C::TILE);
        tma_tile<HD>(k_s + s * C::TILE, &tk, full_k + 8 * s, h,
                     kt * BKC, b);
        mbar_wait(empty_v + 8 * sv, ((i / C::VST) & 1) ^ 1);
        mbar_expect_tx(full_v + 8 * sv, C::TILE);
        tma_tile<HD>(v_s + sv * C::TILE, &tv, full_v + 8 * sv, h,
                     kt * BKC, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int qw = q0 + 64 * wg;                    // this warpgroup's rows
    const int qrow[2] = {qw + 16 * warp + g, qw + 16 * warp + g + 8};
    const uint32_t q_tile = q_s + wg * C::TILE;
    const uint32_t do_tile = do_s + wg * C::TILE;
    // the key tiles these rows see: [wt_lo, wt_hi) within the block's
    int wt_lo = kt_lo, wt_hi = kt_lo;
    if (qw < T_len) {
      int a, z;
      dq_key_tiles(qw, min(qw + 63, T_len - 1), M, causal, window, a, z);
      wt_lo = max(kt_lo, a);
      wt_hi = max(wt_lo, min(kt_hi, z));
    }
    float lse2[2], dl[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse2[r] = qrow[r] < T_len
                    ? lse[(int64_t)bh * T_len + qrow[r]] * kLog2e : 0.0f;
    float acc[DT * 4];
#pragma unroll
    for (int i = 0; i < DT * 4; ++i) acc[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int sweep = 0; sweep < 2; ++sweep) {
      float part[2] = {0.0f, 0.0f};    // this thread's share of delta
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int i = sweep * ntiles + kt - kt_lo, s = i % kStages;
        const int sv = i % C::VST;
        const int par = (i / kStages) & 1, par_v = (i / C::VST) & 1;
        const uint32_t fk = full_k + 8 * s, fv = full_v + 8 * sv;
        const uint32_t ek = empty_k + 8 * s, ev = empty_v + 8 * sv;
        if (kt < wt_lo || kt >= wt_hi) {
          // a tile these rows skip: wait until it landed (so the rings'
          // phases stay in step) and hand it back
          mbar_wait(fk, par);
          mbar_wait(fv, par_v);
          mbar_arrive(ek);
          mbar_arrive(ev);
          continue;
        }
        const uint32_t k_tile = k_s + s * C::TILE;
        const uint32_t v_tile = v_s + sv * C::TILE;
        float sacc[NT * 4], dpacc[NT * 4];
        mbar_wait(fk, par);
        issue_ss<HD>(sacc, q_tile, k_tile);
        mbar_wait(fv, par_v);
        issue_ss<HD>(dpacc, do_tile, v_tile);
        wgmma_commit();
        wgmma_wait0();
        fence_regs<NT * 4>(sacc);
        fence_regs<NT * 4>(dpacc);
        mbar_arrive(ev);
        const int k0 = kt * BKC;
        const bool full = k0 + BKC <= M && qw + 63 < T_len &&
                          (!causal || k0 + BKC - 1 <= qw) &&
                          (window <= 0 || qw + 63 - k0 < window);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * n + 2 * r + c, kj = k0 + n * 8 + 2 * t4 + c;
              const bool seen = full || (kj < M && qrow[r] < T_len &&
                                         visible(qrow[r] - kj, causal,
                                                 window));
              const float p =
                  seen ? ex2(fmaf(sacc[e], scale_log2, -lse2[r])) : 0.0f;
              if (sweep == 0) part[r] = fmaf(p, dpacc[e], part[r]);
              else sacc[e] = p * (dpacc[e] - dl[r]);
            }
        if (sweep == 0) {
          mbar_arrive(ek);
          continue;
        }
        uint32_t hi[BKC / 16][4], lo[BKC / 16][4];
        split_frag(sacc, hi, lo);
        issue_rs<HD>(acc, hi, lo, k_tile);
        wgmma_commit();
        wgmma_wait0();
        fence_regs<DT * 4>(acc);
        mbar_arrive(ek);
      }
      if (sweep == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float d = part[r];
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          dl[r] = d;
          if (t4 == 0 && qrow[r] < T_len)
            delta[(int64_t)bh * T_len + qrow[r]] = d;
        }
      }
    }

    const int64_t rs = (int64_t)H * HD;
    __nv_bfloat16* qb = dq + (int64_t)b * T_len * rs + (int64_t)h * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] >= T_len) continue;
      __nv_bfloat16* row = qb + (int64_t)qrow[r] * rs + 2 * t4;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * scale,
                                  acc[4 * n + 2 * r + 1] * scale);
    }
  }
}

// ----------------------------------------------------------------- K9, bf16
template <int HD>
__global__ void __launch_bounds__(kThreadsWG, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int T_len, int M,
                           int H, int causal, int window, float scale_log2,
                           float scale) {
  using C = DKV<HD>;
  constexpr int NT = 8;                // query n-tiles of S^T and dP^T
  constexpr int DT = HD / 8;           // head_dim n-tiles of dk, dv
  extern __shared__ uint8_t smem_dkv[];
  const uint32_t raw = smem_u32(smem_dkv);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = k_s + C::TILE;         // [NB][64][SW]
  const uint32_t q_s = v_s + C::TILE;                     // ring [NB][64][SW]
  const uint32_t do_s = q_s + kStages * C::TILE;
  const uint32_t cols_s = do_s + kStages * C::TILE;       // ring [2][64] f32
  float* cols = reinterpret_cast<float*>(smem_dkv + (cols_s - raw));
  const uint32_t kv_full = cols_s + kStages * C::COLS;
  const uint32_t full = kv_full + 8, empty = full + 8 * kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * 64;      // the heaviest causal tiles come first
  // the queries these keys see, [lo, hi), then the rows that see no key,
  // [blind, T): query tiles [ta, tb) then [tc, td)
  const int blind = window > 0 ? min(T_len, M + window - 1) : T_len;
  const int k_last = min(k0 + 64, M) - 1;
  const int lo = causal ? k0 : 0;
  const int hi = min(window > 0 ? min(T_len, k_last + window) : T_len, blind);
  const int ta = lo / 64, tb = hi > lo ? (hi + 63) / 64 : ta;
  const int tc = max(tb, blind / 64);
  const int td = blind < T_len ? (T_len + 63) / 64 : tc;
  const int ntiles = (tb - ta) + (td - tc);
  auto tile_row = [&](int i) {
    return 64 * (i < tb - ta ? ta + i : tc + i - (tb - ta));
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 64);   // the TMA's and the columns' 64
      mbar_init(empty + 8 * s, 128 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // the producer: one thread keeps the TMA loads in flight; 64 threads
    // stage each query tile's lse*log2e and delta beside its q and do
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int pt = threadIdx.x - 128 * kConsumerWGs;
    if (pt == 0) {
      mbar_expect_tx(kv_full, 2 * C::TILE);
      tma_tile<HD>(k_s, &tk, kv_full, h, k0, b);
      tma_tile<HD>(v_s, &tv, kv_full, h, k0, b);
    }
    if (pt < 64) {
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, tj = tile_row(i) + pt;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const int64_t at = (int64_t)bh * T_len + tj;
        cols[s * 128 + pt] = tj < T_len ? lse[at] * kLog2e : 0.0f;
        cols[s * 128 + 64 + pt] = tj < T_len ? delta[at] : 0.0f;
        if (pt == 0) {
          mbar_expect_tx(full + 8 * s, 2 * C::TILE);
          tma_tile<HD>(q_s + s * C::TILE, &tq, full + 8 * s, h, tile_row(i),
                       b);
          tma_tile<HD>(do_s + s * C::TILE, &tdo, full + 8 * s, h,
                       tile_row(i), b);
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int krow[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
    const bool owns_dv = wg == 0;      // else dk
    const float inv_m = 1.0f / (float)M;
    float acc[DT * 4];
#pragma unroll
    for (int i = 0; i < DT * 4; ++i) acc[i] = 0.0f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int t0 = tile_row(i), s = i % kStages, par = (i / kStages) & 1;
      const uint32_t q_tile = q_s + s * C::TILE, do_tile = do_s + s * C::TILE;
      const bool full_tile = t0 + 63 < blind && k0 + 63 < M &&
                             (!causal || t0 >= k0 + 63) &&
                             (window <= 0 || t0 + 63 - k0 < window);
      float sacc[NT * 4], dpacc[NT * 4];   // S^T; dP^T (dk's owner)
      const float* l2 = cols + s * 128 + 2 * t4;   // lse*log2e of column
      const float* dl = l2 + 64;                    // 8n + c; then delta
      mbar_wait(full + 8 * s, par);
      issue_ss<HD>(sacc, k_s, q_tile);
      if (!owns_dv) issue_ss<HD>(dpacc, v_s, do_tile);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<NT * 4>(sacc);
      fence_regs<NT * 4>(dpacc);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * n + 2 * r + c, tj = t0 + n * 8 + 2 * t4 + c;
            float p = 0.0f;
            if (full_tile || (krow[r] < M && tj < T_len && tj < blind &&
                              visible(tj - krow[r], causal, window)))
              p = ex2(fmaf(sacc[e], scale_log2, -l2[8 * n + c]));
            else if (owns_dv && krow[r] < M && tj < T_len && tj >= blind)
              p = inv_m;
            sacc[e] = p;
          }
      if (!owns_dv)                        // ds = p (dp - delta)
#pragma unroll
        for (int e = 0; e < NT * 4; ++e)
          sacc[e] *= dpacc[e] - dl[(e / 4) * 8 + e % 2];
      uint32_t hi[4][4], lo4[4][4];
      split_frag(sacc, hi, lo4);
      issue_rs<HD>(acc, hi, lo4, owns_dv ? do_tile : q_tile);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<DT * 4>(acc);
      mbar_arrive(empty + 8 * s);
    }

    const int64_t rs = (int64_t)H * HD;
    __nv_bfloat16* out = (owns_dv ? dv : dk) + (int64_t)b * M * rs +
                         (int64_t)h * HD;
    const float f = owns_dv ? 1.0f : scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (krow[r] >= M) continue;
      __nv_bfloat16* row = out + (int64_t)krow[r] * rs + 2 * t4;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * f,
                                  acc[4 * n + 2 * r + 1] * f);
    }
  }
}

// ------------------------------------------------------------- launchers
struct Args {
  const void *q, *k, *v, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, T_len, M, H, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The ring's stages for the f32 kernels: two when some block streams more
// than one tile, else one.  Upper bounds of a block's span: K8's keys, at
// most M, and under a causal mask at most T and BR + window - 1; K9's
// queries that see its keys, at most T, and under a causal mask with a
// window BR + window - 1, then the rows that see no key, T - (M + window -
// 1).
int simt_stages(const Args& a, bool dkv, int bn) {
  const int64_t w = a.window, T = a.T_len, M = a.M;
  int64_t span = dkv ? T : std::min(M, a.causal ? T : M);
  if (a.causal && w > 0) span = std::min(span, BR + w - 1);
  int64_t tiles = (span + bn - 1) / bn;
  if (dkv && w > 0 && M + w - 1 < T) tiles += (T - (M + w - 1) + bn - 1) / bn;
  return tiles > 1 ? 2 : 1;
}

// blocks of BR rows over `rows`, or -1 past the grid
int64_t simt_blocks(const Args& a, int rows) {
  const int64_t blocks = (int64_t)a.B * a.H * ((rows + BR - 1) / BR);
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

template <int HD>
int launch_dq(const Args& a) {
  using G = Simt<HD>;
  const int64_t blocks = simt_blocks(a, a.T_len);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const int stages = simt_stages(a, false, G::BN);
  auto kernel = flash_bwd_dq_kernel<HD>;
  cudaError_t err = prepare(kernel, G::smem(false, stages));
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, G::smem(false, stages), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<float*>(a.dq), a.B, a.T_len, a.M, a.H, a.causal, a.window,
      a.scale, stages);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const Args& a) {
  using G = Simt<HD>;
  const int64_t blocks = simt_blocks(a, a.M);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const int stages = simt_stages(a, true, G::BN);
  auto kernel = flash_bwd_dkv_kernel<HD>;
  cudaError_t err = prepare(kernel, G::smem(true, stages));
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, G::smem(true, stages), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.B, a.T_len,
      a.M, a.H, a.causal, a.window, a.scale, stages);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_wgmma(const Args& a) {
  using C = DQ<HD>;
  const int64_t tiles = ((int64_t)a.T_len + 64 * kConsumerWGs - 1) /
                        (64 * kConsumerWGs);
  if ((int64_t)a.B * a.H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map<HD>(&tq, a.q, a.B, a.T_len, a.H) ||
      !tensor_map<HD>(&tdo, a.dout, a.B, a.T_len, a.H) ||
      !tensor_map<HD>(&tk, a.k, a.B, a.M, a.H) ||
      !tensor_map<HD>(&tv, a.v, a.B, a.M, a.H))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_wgmma_kernel<HD>;
  cudaError_t err = prepare(kernel, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(a.B * a.H));
  kernel<<<grid, kThreadsWG, C::SMEM, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<__nv_bfloat16*>(a.dq),
      a.T_len, a.M, a.H, a.causal, a.window, a.scale * kLog2e, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv_wgmma(const Args& a) {
  using C = DKV<HD>;
  const int64_t tiles = ((int64_t)a.M + 63) / 64;
  if ((int64_t)a.B * a.H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map<HD>(&tq, a.q, a.B, a.T_len, a.H) ||
      !tensor_map<HD>(&tdo, a.dout, a.B, a.T_len, a.H) ||
      !tensor_map<HD>(&tk, a.k, a.B, a.M, a.H) ||
      !tensor_map<HD>(&tv, a.v, a.B, a.M, a.H))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_wgmma_kernel<HD>;
  cudaError_t err = prepare(kernel, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(a.B * a.H));
  kernel<<<grid, kThreadsWG, C::SMEM, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.T_len, a.M, a.H, a.causal,
      a.window, a.scale * kLog2e, a.scale);
  return (int)cudaGetLastError();
}

bool valid(const Args& a) {
  return a.B > 0 && a.T_len > 0 && a.M > 0 && a.H > 0;
}

int run_dq(int hd, int bf16, const Args& a) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    REPRO_FA_DISPATCH(launch_dq_wgmma, hd, a)
  }
  REPRO_FA_DISPATCH(launch_dq, hd, a)
}

int run_dkv(int hd, int bf16, const Args& a) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    REPRO_FA_DISPATCH(launch_dkv_wgmma, hd, a)
  }
  REPRO_FA_DISPATCH(launch_dkv, hd, a)
}

template <template <int> class C>
int smem_of(int hd) {
  switch (hd) {
    case 16: return C<16>::SMEM;
    case 32: return C<32>::SMEM;
    case 64: return C<64>::SMEM;
    case 128: return C<128>::SMEM;
    case 256: return C<256>::SMEM;
    default: return -1;
  }
}

}  // namespace

extern "C" {

const char* repro_flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a block of K8 (dkv == 0) or K9 (dkv != 0) takes on
// the route for (hd, bf16), or -1; on the f32 route with two ring stages
// (a launch whose blocks stream one tile each takes one).
int repro_flash_attention_bwd_smem_bytes(int dkv, int hd, int bf16) {
  if (smem_of<DQ>(hd) < 0) return -1;
  if (bf16) return dkv ? smem_of<DKV>(hd) : smem_of<DQ>(hd);
  switch (hd) {
    case 16: return Simt<16>::smem(dkv, 2);
    case 32: return Simt<32>::smem(dkv, 2);
    case 64: return Simt<64>::smem(dkv, 2);
    case 128: return Simt<128>::smem(dkv, 2);
    default: return Simt<256>::smem(dkv, 2);
  }
}

// K8.  q, do, dq [B, T, H, hd]; k, v [B, M, H, hd]; lse, delta [B*H, T]
// f32 (delta is written here, for K9); all contiguous and 16-byte aligned;
// bf16 != 0 for __nv_bfloat16 (the tensor-core kernel), else float (the
// SIMT kernel).
int repro_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 void* delta, void* dq, int B, int T_len,
                                 int M, int H, int hd, int bf16, int causal,
                                 int window, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
         B, T_len, M, H, causal, window, scale, (cudaStream_t)stream};
  return run_dq(hd, bf16, a);
}

// K9.  As K8, with the delta K8 wrote; dk, dv [B, M, H, hd].
int repro_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int T_len, int M, int H, int hd,
                                  int bf16, int causal, int window,
                                  float scale, void* stream) {
  Args a{q, k, v, dout, lse, const_cast<void*>(delta), nullptr, dk, dv,
         B, T_len, M, H, causal, window, scale, (cudaStream_t)stream};
  return run_dkv(hd, bf16, a);
}

}  // extern "C"
