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
// Bound: operations.  At the training shape (B*H 32, T = M 4096, hd 256,
// bf16) the causal layer has 268.5 M visible pairs: dq needs 6*hd FLOP per
// pair (the two dots and the dq update), 4.12e11, 0.417 ms at the card's
// 989 TFLOP/s of bf16; dk and dv 8*hd (two dots, dk and dv), 0.556 ms.
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
// The SIMT kernels (f32):
//   * K8: one block per (b*h, tile of query rows), heaviest tile first
//     under a causal mask; TPR threads share a row, each holding its slices
//     of q, do and two accumulators, sum_m p dp k and sum_m p k, in
//     registers (float4 chunks sub, sub + TPR, ...); one pass over the k
//     and v tiles (BK rows in shared memory) gives delta and dq = scale *
//     (sum p dp k - delta * sum p k).  Per key: two partial dots reduced by
//     warp shuffles, then the two axpys and delta's fma.
//   * K9: one block per (b*h, tile of key rows); the block owns its k and v
//     rows and their dk and dv accumulators (registers).  It loops over q,
//     do, lse and delta tiles staged in shared memory, over the same query
//     span as the tensor-core kernel, then over the rows that see no key
//     (dv += do / M, no dots).
// Build flags keep --fmad=false (K1-K4 rely on it); the kernels ask for
// their FMAs explicitly (fmaf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BK = 32;                 // K8: keys per shared-memory tile
constexpr int BQ2 = 32;                // K9: queries per shared-memory tile

template <int HD>
struct Tile {
  // threads per row: 4 chunks of 4 floats a thread from hd 64 up
  static constexpr int TPR = HD >= 256 ? 16 : HD >= 128 ? 8 : 4;
  static constexpr int ROWS = kThreads / TPR;       // rows per block
  static constexpr int CH = HD / (4 * TPR);         // float4 chunks a thread
  static_assert(CH >= 1 && HD % (4 * TPR) == 0, "head_dim");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [r0, r0 + n) of a [B, L, H, hd] tensor (row stride rs, base
// already at (b, 0, h, 0)) into dst[rows][HD]; rows past n are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* base, int64_t rs,
                                      int r0, int n) {
  for (int e = threadIdx.x; e < ROWS * HD / 4; e += kThreads) {
    const int j = e / (HD / 4), c4 = e % (HD / 4);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < n) x = load4(base + (int64_t)(r0 + j) * rs + 4 * c4);
    store4(dst + j * HD + 4 * c4, x);
  }
}

// ------------------------------------------------------------ K8, f32 SIMT
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int T_len, int M, int H, int causal,
                    int window, float scale) {
  using S = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [BK][HD]
  float* Vs = smem + BK * HD;          // [BK][HD]

  const int tid = threadIdx.x;
  const int row = tid / S::TPR, sub = tid % S::TPR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * S::ROWS;
  const int qi = q0 + row;
  const bool live = qi < T_len;
  const int64_t rs = (int64_t)H * HD;  // row stride of [B, *, H, hd]
  const int64_t q_off = ((int64_t)b * T_len + (live ? qi : 0)) * rs +
                        (int64_t)h * HD;
  const float* kb = k + (int64_t)b * M * rs + (int64_t)h * HD;
  const float* vb = v + (int64_t)b * M * rs + (int64_t)h * HD;

  // acc = sum_m p dp k, kp = sum_m p k, dl = delta = sum_m p dp
  float4 qr[S::CH], dr[S::CH], acc[S::CH], kp[S::CH];
  float dl = 0.0f;
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    const int col = 4 * (sub + S::TPR * c);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    qr[c] = live ? load4(q + q_off + col) : z;
    dr[c] = live ? load4(dout + q_off + col) : z;
    acc[c] = z;
    kp[c] = z;
  }
  const int64_t r_off = (int64_t)bh * T_len + qi;
  const float lr = live ? lse[r_off] : 0.0f;
  // a row that sees no key has p = 0 here and ds = 0: dq = 0, delta = 0
  const bool sees = !(window > 0 && qi >= M + window - 1);

  const int q_last = min(q0 + S::ROWS, T_len) - 1;
  const int hi = causal ? min(M, q_last + 1) : M;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = lo; k0 < hi; k0 += BK) {
    const int nk = min(BK, hi - k0);
    __syncthreads();                   // the previous tile is consumed
    stage<HD, BK>(Ks, kb, rs, k0, nk);
    stage<HD, BK>(Vs, vb, rs, k0, nk);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {     // nk is the same for the whole block
      const float* kr = Ks + j * HD;
      const float* vr = Vs + j * HD;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < S::CH; ++c) {
        const int col = 4 * (sub + S::TPR * c);
        s = dot4(qr[c], load4(kr + col), s);
        dp = dot4(dr[c], load4(vr + col), dp);
      }
      s = row_sum<S::TPR>(s);
      dp = row_sum<S::TPR>(dp);
      const int d = qi - (k0 + j);
      const bool seen = sees && (!causal || d >= 0) &&
                        (window <= 0 || d < window);
      const float p = seen ? expf(s * scale - lr) : 0.0f;
      const float pdp = p * dp;
      dl = fmaf(p, dp, dl);
#pragma unroll
      for (int c = 0; c < S::CH; ++c) {
        const float4 kk = load4(kr + 4 * (sub + S::TPR * c));
        axpy4(pdp, kk, acc[c]);
        axpy4(p, kk, kp[c]);
      }
    }
  }

  if (!live) return;
  if (sub == 0) delta[r_off] = dl;
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    const float4 a = acc[c], b = kp[c];
    store4(dq + q_off + 4 * (sub + S::TPR * c),
           make_float4(scale * fmaf(-dl, b.x, a.x), scale * fmaf(-dl, b.y, a.y),
                       scale * fmaf(-dl, b.z, a.z),
                       scale * fmaf(-dl, b.w, a.w)));
  }
}

// ------------------------------------------------------------ K9, f32 SIMT
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int T_len, int M, int H, int causal,
                     int window, float scale) {
  using S = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [BQ2][HD]
  float* Ds = smem + BQ2 * HD;         // [BQ2][HD]
  float* Ls = Ds + BQ2 * HD;           // [BQ2] lse
  float* Es = Ls + BQ2;                // [BQ2] delta

  const int tid = threadIdx.x;
  const int row = tid / S::TPR, sub = tid % S::TPR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * S::ROWS;  // the heaviest causal tiles come first
  const int ki = k0 + row;
  const bool live = ki < M;
  const int64_t rs = (int64_t)H * HD;
  const int64_t k_off = ((int64_t)b * M + (live ? ki : 0)) * rs +
                        (int64_t)h * HD;
  const float* qb = q + (int64_t)b * T_len * rs + (int64_t)h * HD;
  const float* db = dout + (int64_t)b * T_len * rs + (int64_t)h * HD;
  const float* lb = lse + (int64_t)bh * T_len;
  const float* eb = delta + (int64_t)bh * T_len;

  float4 kr[S::CH], vr[S::CH], dka[S::CH], dva[S::CH];
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    const int col = 4 * (sub + S::TPR * c);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    kr[c] = live ? load4(k + k_off + col) : z;
    vr[c] = live ? load4(v + k_off + col) : z;
    dka[c] = z;
    dva[c] = z;
  }

  const int k_last = min(k0 + S::ROWS, M) - 1;
  const int blind = window > 0 ? M + window - 1 : T_len;  // first row seeing
                                                          // no key
  const int lo = causal ? k0 : 0;
  const int hi = min(window > 0 ? min(T_len, k_last + window) : T_len, blind);
  const float inv_m = 1.0f / (float)M;
  // pass 0: the queries that can see this tile; pass 1: the rows that see
  // no key, which give every key p = 1/M and ds = 0
  for (int pass = 0; pass < 2; ++pass) {
    const int a = pass ? blind : lo, z = pass ? T_len : hi;
    for (int t0 = a; t0 < z; t0 += BQ2) {
      const int nq = min(BQ2, z - t0);
      __syncthreads();                 // the previous tile is consumed
      if (!pass) stage<HD, BQ2>(Qs, qb, rs, t0, nq);
      stage<HD, BQ2>(Ds, db, rs, t0, nq);
      if (tid < BQ2) {
        Ls[tid] = tid < nq ? lb[t0 + tid] : 0.0f;
        Es[tid] = tid < nq ? eb[t0 + tid] : 0.0f;
      }
      __syncthreads();
      if (pass) {
        const float p = live ? inv_m : 0.0f;
        for (int j = 0; j < nq; ++j) {
          const float* dr = Ds + j * HD;
#pragma unroll
          for (int c = 0; c < S::CH; ++c)
            axpy4(p, load4(dr + 4 * (sub + S::TPR * c)), dva[c]);
        }
        continue;
      }
      for (int j = 0; j < nq; ++j) {   // nq is the same for the whole block
        const float* qr = Qs + j * HD;
        const float* dr = Ds + j * HD;
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int c = 0; c < S::CH; ++c) {
          const int col = 4 * (sub + S::TPR * c);
          s = dot4(kr[c], load4(qr + col), s);
          dp = dot4(vr[c], load4(dr + col), dp);
        }
        s = row_sum<S::TPR>(s);
        dp = row_sum<S::TPR>(dp);
        const int d = (t0 + j) - ki;
        const bool seen = live && (!causal || d >= 0) &&
                          (window <= 0 || d < window);
        const float p = seen ? expf(s * scale - Ls[j]) : 0.0f;
        const float ds = p * (dp - Es[j]);
#pragma unroll
        for (int c = 0; c < S::CH; ++c) {
          const int col = 4 * (sub + S::TPR * c);
          axpy4(p, load4(dr + col), dva[c]);
          axpy4(ds, load4(qr + col), dka[c]);
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    const int col = 4 * (sub + S::TPR * c);
    const float4 a = dka[c];
    store4(dk + k_off + col,
           make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale));
    store4(dv + k_off + col, dva[c]);
  }
}

// ------------------------------------------------- bf16: the tensor cores
constexpr int kConsumerWGs = 2;
constexpr int kThreadsWG = 128 * (kConsumerWGs + 1);  // + the producer's
constexpr int kStages = 2;

__device__ __forceinline__ bool visible(int d, int causal, int window) {
  return (!causal || d >= 0) && (window <= 0 || d < window);
}

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

template <int HD>
int launch_dq(const Args& a) {
  using S = Tile<HD>;
  const int64_t tiles = ((int64_t)a.T_len + S::ROWS - 1) / S::ROWS;
  if ((int64_t)a.B * a.H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * BK * HD;   // 64 KB at hd 256
  auto kernel = flash_bwd_dq_kernel<HD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(a.B * a.H));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<float*>(a.dq), a.T_len, a.M, a.H, a.causal, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const Args& a) {
  using S = Tile<HD>;
  const int64_t tiles = ((int64_t)a.M + S::ROWS - 1) / S::ROWS;
  if ((int64_t)a.B * a.H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * BQ2 * HD + 2 * BQ2);
  auto kernel = flash_bwd_dkv_kernel<HD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(a.B * a.H));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.T_len, a.M,
      a.H, a.causal, a.window, a.scale);
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
// the route for (hd, bf16), or -1.
int repro_flash_attention_bwd_smem_bytes(int dkv, int hd, int bf16) {
  if (smem_of<DQ>(hd) < 0) return -1;
  if (bf16) return dkv ? smem_of<DKV>(hd) : smem_of<DQ>(hd);
  return (int)(dkv ? sizeof(float) * (2 * BQ2 * hd + 2 * BQ2)
                   : 2 * sizeof(float) * BK * hd);
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
