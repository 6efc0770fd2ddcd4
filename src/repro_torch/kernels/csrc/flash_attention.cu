// Flash-attention forward (K7) for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_attention.py:_fwd (_fwd_kernel).  It computes, for
// q [B, T, H, hd] against k, v [B, M, H, hd] (kv pre-expanded to H heads):
//
//   s[t, m] = (q[t] . k[m]) / sqrt(hd), masked to -1e30 where
//             (causal and t - m < 0) or (window > 0 and t - m >= window)
//   o[t]    = softmax(s[t]) @ v             in the input type (f32 or bf16)
//   lse[t]  = log(sum_m exp(s[t, m]))       f32, laid out [B*H, T]
//
// One extern "C" function launches on the caller's stream and returns
// cudaGetLastError() (0 on success); the wrapper in
// repro_torch/kernels/flash_attention.py checks dtype, shape, head_dim,
// contiguity and alignment first.  The route is chosen by the input type:
//
//   bf16 -> flash_fwd_wgmma_kernel, on the tensor cores (wgmma, bf16 in,
//           f32 accumulate, fed by TMA), at every head_dim;
//   f32  -> flash_fwd_kernel, SIMT in f32: the f32 limit (2e-5 of |o|)
//           leaves no room for bf16 or TF32 operands.
//
// Bound: operations.  At the LM's prefill (B*H 64, T = M 4096, hd 256,
// bf16) the causal layer needs 537.0 M unmasked (t, m) pairs x 4*hd =
// 5.50e11 FLOP, 0.556 ms at the card's 989 TFLOP/s of bf16, against 538 MB
// of q, k, v, o and lse, 0.161 ms at 3.35 TB/s.  At the fault-tolerant
// driver's [8, 64, 10, 64] f32 the bound is bytes: q, k, v and o at 1.31
// MB each, 0.00157 ms at 3.35 TB/s, against 0.00064 ms for the causal
// mask's 166,400 visible pairs x 4*hd FLOP at 67 TFLOP/s of f32.  There a
// launch with nothing to do costs ~0.005 ms, and what the kernel adds to
// it is the latency of one round of tile copies and of its two products.
//
// Shared by both kernels:
//   * whole k tiles outside [q_first - window + 1, q_last] are skipped at
//     both ends (the causal prune of the TPU kernel, plus the window's);
//     a query tile holding a row that sees no key at all (only when T > M +
//     window - 1) visits every tile, so that row gets the reference's
//     uniform softmax over its -1e30 scores;
//   * T and M need not be multiples of a tile: rows beyond T are computed
//     from zeros and not stored, keys beyond M take no weight;
//   * the [B, T, H, hd] layout is read in place (row stride H*hd): no
//     transposes to [B*H, T, hd];
//   * query tiles are launched heaviest first (the last causal tiles see
//     the most keys), so the short ones fill the tail of the grid.
// Build flags keep --fmad=false (K1-K4 rely on it); the kernels ask for
// their FMAs explicitly (fmaf).
//
// The tensor-core kernel (bf16), warp-specialised:
//   * a block owns 128 query rows of one (b, h): two consumer warpgroups of
//     64 rows each, and a producer warpgroup whose one thread keeps TMA
//     loads of the k and v tiles (64 keys) in flight through a 2-stage
//     ring of shared memory, guarded by mbarriers: per stage, k landed and
//     v landed; k free (both consumers' S products done) and v free (their
//     P.V products done), so the next k loads while this tile's P.V runs;
//     setmaxnreg hands the producer's registers to the consumers (24 / 240
//     a thread);
//   * q, k and v are read by 4-D tensor maps over (hd, H, T|M, B), so the
//     [B, T, H, hd] layout needs no transpose; a box is 64 rows of at most
//     64 head_dim elements (128 bytes, 128-byte swizzle; hd 32 and 16 use
//     the 64- and 32-byte swizzles), so an hd-256 row lands as four boxes
//     and the wgmma descriptors step through them; TMA fills rows beyond T
//     or M with zeros;
//   * S = Q K^T by wgmma m64n64k16 with both operands in shared memory
//     (K-major); the online softmax runs on the f32 accumulator registers:
//     running max m and sum l per row in the log2 domain (log2(e) folded
//     into the scale, p = 2^fmaf(s, scale*log2e, -m) by the SFU's
//     ex2.approx, within 2^-22 of exp2), l summed from the f32 p's, o
//     rescaled by 2^(m_old - m_new) when some row's max moved;
//   * a warpgroup issues tile j's S product before tile j-1's P.V, so its
//     softmax of tile j runs while the tensor cores do that P.V;
//   * p goes to the P.V product as two bf16 terms, hi = bf16(p) and lo =
//     bf16(p - hi), each multiplied by v (wgmma m64n{hd}k16 with A from
//     registers and v transposed in shared memory): 2^-17 of p in place of
//     one term's 2^-9; a single term misses the element-wise limit of
//     chip_smoke.flash_err by up to 5x in the CPU emulation of
//     tests/test_torch_flash_attention.py, so P.V costs two products;
//   * o = acc / max(l, 1e-30) in bf16, lse = (m + log2 l) * ln 2 in f32.
// At hd 256 a block takes 193 KB of shared memory (q 64 KB, two stages of
// k and v 128 KB), so one block (3 warpgroups) runs on an SM; the o
// accumulator of a 64 x 256 tile is 128 registers a thread.
//
// The SIMT kernel (f32), 128 threads a block, laid out as the f32 K8 of
// flash_attention_bwd.cu:
//   * a block owns BR = 16 query rows of one (b, h), so the driver's [8,
//     64, 10, 64] makes 320 blocks for 132 SMs (64-row blocks made 80, and
//     52 SMs sat idle).  The grid is one-dimensional and tile-major, so
//     every (b, h)'s heaviest causal tile comes first.
//   * the block's q rows stay in shared memory; k and v stream in tiles of
//     BN rows (64 at hd <= 64, 32 at hd 128, 16 at hd 256) from the block's
//     first visible key, through a ring of cp.async copies: the next tile
//     is issued before the current one is computed, and a tile's v is a
//     copy group of its own, landing while S runs.  The ring has two
//     stages when some block takes two tiles or more, else one (at the
//     driver's shape every block's keys fit one tile, so the forward makes
//     one pass with no rescale).  Rows past T or M land as zeros.
//   * S = Q K^T as 2 x SC micro-tiles a thread (rows r and r + 8; keys c,
//     c + 4, ...: 2 x 4 at hd <= 64), 2 SC independent f32 dot products
//     with operands read from shared memory as float4 (rows padded to 4
//     banks apart), no shuffles.  A warp owns a quarter of the tile's keys
//     and skips them when none is in the block's span (past a causal
//     diagonal, or the last tile's end); only a tile that straddles a
//     mask's edge takes the per-element mask.
//   * the online softmax runs in the log2 domain (scale*log2e folded into
//     one constant, one exp2f a score): a row's tile max is combined over
//     its four warps through shared memory, p = 2^(s*scale*log2e - m) goes
//     to shared memory, and the threads of the O += P V product, each
//     holding [16, hd]'s accumulators for its rows a float4 chunk at a
//     time, rescale them (and sum l from the p's they read) only when the
//     row's max moved.
//   * a masked key scores -1e30 as in the reference: once its row has seen
//     a visible key its weight is 2^(-1e30*log2e - m) = 0, and a row that
//     sees no key (only when T > M + window - 1) gets weight 1 for each of
//     the M keys its block visits (key_range), the reference's uniform
//     softmax; its lse, (-1e30*log2e + log2 M) ln 2, rounds to -1e30.
//   * o = acc / max(l, 1e-30), lse = (m + log2 l) * ln 2.
// Every multiply-add is an explicit fmaf; bounded (kThreads, 1), as the f32
// K8/K9 are, so that ptxas keeps every value in registers.

#include <math.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;      // the reference's mask value

// The key range [lo, hi) that query rows [qa, qb] must visit: the causal
// and window prunes, and the rule for rows that see no key.
__device__ __forceinline__ void key_range(int qa, int qb, int M, int causal,
                                          int window, int& lo, int& hi) {
  hi = causal ? min(M, qb + 1) : M;
  lo = 0;
  if (window > 0 && qb < M + window - 1)   // every row sees some key
    lo = max(0, qa - window + 1);
}

// --------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma fed by TMA)
// --------------------------------------------------------------------------
constexpr float kNeg2 = kNegInf * kLog2e;   // -1e30 in the log2 domain

constexpr int kConsumerWGs = 2;                  // 64 query rows each
constexpr int kThreadsWG = 128 * (kConsumerWGs + 1);  // + the producer's
constexpr int BQ_WG = 64 * kConsumerWGs;         // 128 query rows a block
constexpr int BK_WG = 64;                        // keys a tile
constexpr int kStages = 2;

template <int HD>
struct WG {
  static constexpr int TILE = 64 * HD * 2;      // 64 rows of q, k or v
  static constexpr int Q_BYTES = BQ_WG * HD * 2;
  static constexpr int KV_BYTES = BK_WG * HD * 2;  // one k or v tile
  // q, the ring of (k, v), barriers; +1024 to align the tiles
  static constexpr int SMEM =
      Q_BYTES + 2 * kStages * KV_BYTES + 8 * (1 + 4 * kStages) + 1024;
};

// Issue S = Q K^T for a warpgroup's 64 query rows against a 64-key tile.
template <int HD>
__device__ __forceinline__ void issue_qk(float* sacc, uint32_t q_tile,
                                         uint32_t k_tile) {
  issue_ss<HD>(sacc, q_tile, k_tile);
  wgmma_commit();
}

// Issue O += P V for a 64-key tile, P as its hi and lo bf16 terms
// (registers), v transposed in shared memory (MN-major).
template <int HD>
__device__ __forceinline__ void issue_pv(float* acc, uint32_t (*ph)[4],
                                         uint32_t (*pl)[4], uint32_t v_tile) {
  issue_rs<HD>(acc, ph, pl, v_tile);
  wgmma_commit();
}

// The online softmax of one S tile (keys k0..k0+63) on the accumulator
// registers, in the log2 domain: the new running max and sum of this
// thread's two rows, the factor alpha that rescales their o, and p in
// place of s.  ``full``: every key of the tile is visible to every row.
template <int NT>
__device__ __forceinline__ void softmax_tile(float* sacc, float* m_run,
                                             float* l_run, float* alpha,
                                             bool full, const int* qrow,
                                             int k0, int t4, int M,
                                             int causal, int window,
                                             float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNeg2;
    if (full) {
      float raw = sacc[2 * r];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        raw = fmaxf(raw, fmaxf(sacc[4 * n + 2 * r], sacc[4 * n + 2 * r + 1]));
      mx = raw * scale_log2;
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = k0 + n * 8 + 2 * t4 + c, d = qrow[r] - kj;
          const bool seen = kj < M && (!causal || d >= 0) &&
                            (window <= 0 || d < window);
          if (seen) mx = fmaxf(mx, sacc[4 * n + 2 * r + c] * scale_log2);
        }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    alpha[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
    float psum = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float p = ex2(fmaf(sacc[4 * n + 2 * r + c], scale_log2, -m_new));
        if (!full) {
          const int kj = k0 + n * 8 + 2 * t4 + c, d = qrow[r] - kj;
          const bool seen = kj < M && (!causal || d >= 0) &&
                            (window <= 0 || d < window);
          // a masked key scores -1e30: weight 1 only while its row has
          // seen nothing else (then a later key's alpha is 0)
          if (!seen) p = kj < M ? ex2(kNeg2 - m_new) : 0.0f;
        }
        sacc[4 * n + 2 * r + c] = p;
        psum += p;
      }
    l_run[r] = fmaf(l_run[r], alpha[r], psum);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsWG, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int T_len, int M, int H, int causal, int window,
                       float scale_log2) {
  using C = WG<HD>;
  constexpr int NT = BK_WG / 8;        // key n-tiles of S
  constexpr int DT = HD / 8;           // head_dim n-tiles of o
  extern __shared__ uint8_t smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;
  const uint32_t q_s = base;                         // 2 x [NB][64][SW]
  const uint32_t k_s = q_s + C::Q_BYTES;             // kStages x [NB][64][SW]
  const uint32_t v_s = k_s + kStages * C::KV_BYTES;  // kStages x [NB][64][SW]
  const uint32_t q_full = v_s + kStages * C::KV_BYTES;
  // per stage: k landed, v landed; k free (S done), v free (P.V done)
  const uint32_t full_k = q_full + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_WG;   // heaviest first
  int lo, hi;
  key_range(q0, min(q0 + BQ_WG, T_len) - 1, M, causal, window, lo, hi);
  const int kt_lo = lo / BK_WG, kt_hi = (hi + BK_WG - 1) / BK_WG;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 128 * kConsumerWGs);
      mbar_init(empty_v + 8 * s, 128 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // the producer: one thread keeps the TMA loads of the ring in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumerWGs) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int r = 0; r < kConsumerWGs; ++r)
        tma_tile<HD>(q_s + r * C::TILE, &tq, q_full, h, q0 + 64 * r, b);
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int i = kt - kt_lo, s = i % kStages;
        const int par = ((i / kStages) & 1) ^ 1;
        mbar_wait(empty_k + 8 * s, par);
        mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
        tma_tile<HD>(k_s + s * C::KV_BYTES, &tk, full_k + 8 * s, h,
                     kt * BK_WG, b);
        mbar_wait(empty_v + 8 * s, par);
        mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
        tma_tile<HD>(v_s + s * C::KV_BYTES, &tv, full_v + 8 * s, h,
                     kt * BK_WG, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int qw = q0 + 64 * wg;                    // this warpgroup's rows
    const int qrow[2] = {qw + 16 * warp + g, qw + 16 * warp + g + 8};
    const uint32_t q_tile = q_s + wg * C::TILE;
    // the key tiles this warpgroup's rows see: [wt_lo, wt_hi)
    int wlo, whi;
    key_range(qw, min(qw + 63, T_len - 1), M, causal, window, wlo, whi);
    const int wt_lo = max(kt_lo, wlo / BK_WG);
    const int wt_hi = qw < T_len ? min(kt_hi, (whi + BK_WG - 1) / BK_WG)
                                 : wt_lo;
    // a tile of the block's range that these rows skip: wait until it
    // landed (so the ring's phases stay in step) and hand it back
    auto skip = [&](int kt) {
      const int i = kt - kt_lo, s = i % kStages, par = (i / kStages) & 1;
      mbar_wait(full_k + 8 * s, par);
      mbar_wait(full_v + 8 * s, par);
      mbar_arrive(empty_k + 8 * s);
      mbar_arrive(empty_v + 8 * s);
    };
    auto is_full = [&](int k0) {
      return k0 + BK_WG <= M && (!causal || k0 + BK_WG - 1 <= qw) &&
             (window <= 0 || qw + 63 - k0 < window);
    };

    float acc[DT * 4];
#pragma unroll
    for (int i = 0; i < DT * 4; ++i) acc[i] = 0.0f;
    float m_run[2] = {kNeg2, kNeg2};
    float l_run[2] = {0.0f, 0.0f};     // this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int kt = kt_lo; kt < min(wt_lo, kt_hi); ++kt) skip(kt);
    if (wt_lo < wt_hi) {
      float sacc[NT * 4] = {}, alpha[2];
      uint32_t ph[BK_WG / 16][4], pl[BK_WG / 16][4];
      int s = (wt_lo - kt_lo) % kStages;
      mbar_wait(full_k + 8 * s, ((wt_lo - kt_lo) / kStages) & 1);
      issue_qk<HD>(sacc, q_tile, k_s + s * C::KV_BYTES);
      wgmma_wait0();
      fence_regs<NT * 4>(sacc);
      mbar_arrive(empty_k + 8 * s);
      softmax_tile<NT>(sacc, m_run, l_run, alpha, is_full(wt_lo * BK_WG),
                       qrow, wt_lo * BK_WG, t4, M, causal, window,
                       scale_log2);
      split_frag(sacc, ph, pl);
      // tile kt's S = Q K^T and softmax overlap tile kt-1's P.V
      for (int kt = wt_lo + 1; kt < wt_hi; ++kt) {
        const int i = kt - kt_lo, sp = s;
        s = i % kStages;
        mbar_wait(full_k + 8 * s, (i / kStages) & 1);
        issue_qk<HD>(sacc, q_tile, k_s + s * C::KV_BYTES);
        mbar_wait(full_v + 8 * sp, ((i - 1) / kStages) & 1);
        issue_pv<HD>(acc, ph, pl, v_s + sp * C::KV_BYTES);
        wgmma_wait1();                 // S has landed; P.V runs on
        fence_regs<NT * 4>(sacc);
        mbar_arrive(empty_k + 8 * s);
        softmax_tile<NT>(sacc, m_run, l_run, alpha, is_full(kt * BK_WG),
                         qrow, kt * BK_WG, t4, M, causal, window,
                         scale_log2);
        wgmma_wait0();
        fence_regs<DT * 4>(acc);
        mbar_arrive(empty_v + 8 * sp);
        if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
          for (int n = 0; n < DT; ++n) {
            acc[4 * n] *= alpha[0];
            acc[4 * n + 1] *= alpha[0];
            acc[4 * n + 2] *= alpha[1];
            acc[4 * n + 3] *= alpha[1];
          }
        }
        split_frag(sacc, ph, pl);
      }
      mbar_wait(full_v + 8 * s, ((wt_hi - 1 - kt_lo) / kStages) & 1);
      issue_pv<HD>(acc, ph, pl, v_s + s * C::KV_BYTES);
      wgmma_wait0();
      fence_regs<DT * 4>(acc);
      mbar_arrive(empty_v + 8 * s);
    }
    for (int kt = max(wt_hi, wt_lo); kt < kt_hi; ++kt) skip(kt);

    // o = acc / l, lse = (m + log2 l) ln 2
    const int64_t rs = (int64_t)H * HD;
    __nv_bfloat16* ob = o + (int64_t)b * T_len * rs + (int64_t)h * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float den = fmaxf(l, 1e-30f);
      if (qrow[r] >= T_len) continue;
      __nv_bfloat16* orow = ob + (int64_t)qrow[r] * rs + 2 * t4;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] / den,
                                  acc[4 * n + 2 * r + 1] / den);
      if (t4 == 0)
        lse[(int64_t)bh * T_len + qrow[r]] =
            (m_run[r] + log2f(den)) * kLn2;
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int T_len, int M, int H, int causal,
                 int window, float scale, cudaStream_t stream) {
  const int64_t tiles = ((int64_t)T_len + BQ_WG - 1) / BQ_WG;
  if ((int64_t)B * H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<HD>(&tq, q, B, T_len, H) ||
      !tensor_map<HD>(&tk, k, B, M, H) || !tensor_map<HD>(&tv, v, B, M, H))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG<HD>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(B * H));
  kernel<<<grid, kThreadsWG, WG<HD>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      T_len, M, H, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

int smem_wgmma(int hd) {
  switch (hd) {
    case 16: return WG<16>::SMEM;
    case 32: return WG<32>::SMEM;
    case 64: return WG<64>::SMEM;
    case 128: return WG<128>::SMEM;
    case 256: return WG<256>::SMEM;
    default: return -1;
  }
}

// --------------------------------------------------------------------------
// f32: the SIMT kernel
// --------------------------------------------------------------------------
constexpr int kThreads = 128;          // 4 warps
constexpr int BR = 16;                 // query rows a block owns

// The f32 tiles at head_dim HD: k and v stream in tiles of BN rows; rows in
// shared memory are LD floats apart (HD + 4: 4 banks apart), the p array
// [BR][PLD].  A thread's S micro-tile is 2 x SC; the [BR, HD] o
// accumulators are split into CG column groups of ACH float4 chunks (chunk c
// of group g at column 4 (g + CG c)) and RG row groups of AR rows (row a of
// group r: r + RG a; at hd 16, RG = 32 and half idle).
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
  // dynamic shared memory of a block: its q rows, the ring's stages of k
  // and v, p, and the tile's row maxima by warp
  static constexpr int smem(int stages) {
    return 4 * (BR * LD + stages * 2 * BN * LD + BR * PLD + 4 * BR);
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

// 16 bytes global -> shared by cp.async; zeros when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's latest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// s[r][i] = X[row rg + 8 r] . Xt[row c + 4 i] over hd: 2 SC independent f32
// dot products of the block's q rows and the tile's k rows.
template <int HD>
__device__ __forceinline__ void tile_scores(const float* X, const float* Xt,
                                            int rg, int c,
                                            float (&s)[2][Simt<HD>::SC]) {
  using G = Simt<HD>;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < G::SC; ++i) s[r][i] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 x0 = load4(X + rg * G::LD + d);
    const float4 x1 = load4(X + (rg + 8) * G::LD + d);
#pragma unroll
    for (int i = 0; i < G::SC; ++i) {
      const float4 xt = load4(Xt + (c + 4 * i) * G::LD + d);
      s[0][i] = dot4(x0, xt, s[0][i]);
      s[1][i] = dot4(x1, xt, s[1][i]);
    }
  }
}

// acc[a][c] += sum_{j < nj} P[row a][j] * V[j][chunk c] and l[a] += sum_j
// P[row a][j], for this thread's rows ar + RG a and chunks 4 (cg + CG c);
// nj is a multiple of 4.
template <int HD>
__device__ __forceinline__ void tile_pv(
    const float* P, const float* V, int nj, int ar, int cg,
    float4 (&acc)[Simt<HD>::AR][Simt<HD>::ACH], float (&l)[Simt<HD>::AR]) {
  using G = Simt<HD>;
  for (int j = 0; j < nj; j += 4) {
    float4 pr[G::AR];
#pragma unroll
    for (int a = 0; a < G::AR; ++a) {
      pr[a] = load4(P + (ar + G::RG * a) * G::PLD + j);
      l[a] += (pr[a].x + pr[a].y) + (pr[a].z + pr[a].w);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < G::ACH; ++c) {
        const float4 z = load4(V + (j + jj) * G::LD + 4 * (cg + G::CG * c));
#pragma unroll
        for (int a = 0; a < G::AR; ++a) axpy4(lane4(pr[a], jj), z, acc[a][c]);
      }
  }
}

// the largest of a row's four warp maxima
__device__ __forceinline__ float row_max(const float* red, int row) {
  return fmaxf(fmaxf(red[row], red[BR + row]),
               fmaxf(red[2 * BR + row], red[3 * BR + row]));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int B, int T_len, int M, int H,
                 int causal, int window, float scale_log2, int stages) {
  using G = Simt<HD>;
  constexpr int LD = G::LD, BN = G::BN, SC = G::SC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BR][LD] the block's q rows
  float* ring = Qs + BR * LD;                // stages x (k, v) [BN][LD]
  float* Ps = ring + stages * 2 * BN * LD;   // [BR][PLD] p of a tile
  float* red = Ps + BR * G::PLD;             // [4][BR] row maxima by warp

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane % 8, col = 4 * SC * warp + lane / 8;  // S: rows, keys
  const int ar = tid / G::CG, cg = tid % G::CG;             // o's share
  const int bhn = B * H, bh = blockIdx.x % bhn, b = bh / H, h = bh % H;
  const int nq = (T_len + BR - 1) / BR, rank = blockIdx.x / bhn;
  const int q0 = (causal ? nq - 1 - rank : rank) * BR;   // heaviest first
  const int q_last = min(q0 + BR, T_len) - 1;
  int lo, hi;                            // the keys this block visits
  key_range(q0, q_last, M, causal, window, lo, hi);
  const int n = hi > lo ? (hi - lo + BN - 1) / BN : 0;   // key tiles
  const int64_t rs = (int64_t)H * HD, hoff = (int64_t)h * HD;
  const float* kb = k + (int64_t)b * M * rs + hoff;
  const float* vb = v + (int64_t)b * M * rs + hoff;
  // copy groups: q with k of tile 0, then v of tile 0 (stage 0), so v
  // lands while the S product runs
  copy_rows<HD, BR>(Qs, q + (int64_t)b * T_len * rs + hoff, rs, q0,
                    q_last - q0 + 1);
  copy_rows<HD, BN>(ring, kb, rs, lo, min(BN, hi - lo));
  cp_async_commit();
  copy_rows<HD, BN>(ring + BN * LD, vb, rs, lo, min(BN, hi - lo));
  cp_async_commit();

  // running maxima (log2 domain) of the S rows rg + 8 r and of the o rows
  // ar + RG a; l and the o accumulators of the latter
  float ms[2] = {kNeg2, kNeg2}, mo[G::AR], l[G::AR];
  float4 acc[G::AR][G::ACH];
#pragma unroll
  for (int a = 0; a < G::AR; ++a) {
    mo[a] = kNeg2;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < G::ACH; ++c) acc[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const bool owner = ar < BR;            // the thread holds o rows

  for (int i = 0; i < n; ++i) {
    const int t0 = lo + i * BN, nk = min(BN, hi - t0);
    const float* Ks = ring + (i % stages) * 2 * BN * LD;
    const float* Vs = Ks + BN * LD;
    cp_async_wait<1>();
    __syncthreads();       // k of tile i landed; the other stage, Ps, red
                           // are free
    if (i + 1 < n) {       // key tile i + 1 into its stage: k, then v
      const int u0 = t0 + BN;
      float* dst = ring + (i + 1) % stages * 2 * BN * LD;
      copy_rows<HD, BN>(dst, kb, rs, u0, min(BN, hi - u0));
      cp_async_commit();
      copy_rows<HD, BN>(dst + BN * LD, vb, rs, u0, min(BN, hi - u0));
      cp_async_commit();
    }
    // every key of the tile visible to every row of the block: no mask
    const bool full = (!causal || t0 + nk - 1 <= q0) &&
                      (window <= 0 || q0 + BR - 1 - t0 < window);
    const bool busy = 4 * SC * warp < nk;   // the warp's keys in the span
    float s[2][SC], mx[2] = {kNeg2, kNeg2};
    if (busy) {
      tile_scores<HD>(Qs, Ks, rg, col, s);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          const int j = col + 4 * c;
          if (j < nk && (full || visible(q0 + rg + 8 * r - (t0 + j), causal,
                                         window)))
            mx[r] = fmaxf(mx[r], s[r][c] * scale_log2);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 8));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 16));
      if (lane < 8) red[warp * BR + rg + 8 * r] = mx[r];
    }
    __syncthreads();       // the tile's row maxima by warp
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(ms[r], row_max(red, rg + 8 * r));
      if (busy)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          const int j = col + 4 * c;
          float p = 0.0f;                // past the span: no weight
          if (j < nk) {
            p = full || visible(q0 + rg + 8 * r - (t0 + j), causal, window)
                    ? exp2f(fmaf(s[r][c], scale_log2, -m_new))
                    : exp2f(kNeg2 - m_new);   // a masked key scores -1e30
          }
          Ps[(rg + 8 * r) * G::PLD + j] = p;
        }
      ms[r] = m_new;
    }
    if (owner)
#pragma unroll
      for (int a = 0; a < G::AR; ++a) {  // rescale o where the max moved
        const float m_new = fmaxf(mo[a], row_max(red, ar + G::RG * a));
        if (m_new != mo[a]) {
          const float alpha = exp2f(mo[a] - m_new);
          l[a] *= alpha;
#pragma unroll
          for (int c = 0; c < G::ACH; ++c) {
            acc[a][c].x *= alpha;
            acc[a][c].y *= alpha;
            acc[a][c].z *= alpha;
            acc[a][c].w *= alpha;
          }
          mo[a] = m_new;
        }
      }
    if (i + 1 < n)         // v of tile i landed (tile i + 1 in flight)
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();       // p and v of the tile
    if (owner) tile_pv<HD>(Ps, Vs, (nk + 3) & ~3, ar, cg, acc, l);
  }
  cp_async_wait<0>();

  if (!owner) return;
#pragma unroll
  for (int a = 0; a < G::AR; ++a) {
    const int t = q0 + ar + G::RG * a;
    if (t >= T_len) continue;
    const float den = fmaxf(l[a], 1e-30f);
    float* row = o + ((int64_t)b * T_len + t) * rs + hoff;
#pragma unroll
    for (int c = 0; c < G::ACH; ++c) {
      const float4 x = acc[a][c];
      store4(row + 4 * (cg + G::CG * c),
             make_float4(x.x / den, x.y / den, x.z / den, x.w / den));
    }
    if (cg == 0)
      lse[(int64_t)bh * T_len + t] = (mo[a] + log2f(den)) * kLn2;
  }
}

// The ring's stages: two when some block takes more than one key tile, else
// one.  A block's keys number at most M, under a causal mask at most T, and
// under a causal mask with a window at most BR + window - 1 -- unless a row
// sees no key (T > M + window - 1), whose block visits all M.
int simt_stages(int T_len, int M, int causal, int window, int bn) {
  int64_t span = causal ? std::min(M, T_len) : M;
  if (causal && window > 0 && (int64_t)T_len <= (int64_t)M + window - 1)
    span = std::min<int64_t>(span, BR + (int64_t)window - 1);
  return span > bn ? 2 : 1;
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int T_len, int M, int H, int causal,
                int window, float scale, cudaStream_t stream) {
  using G = Simt<HD>;
  const int64_t blocks = (int64_t)B * H * ((T_len + BR - 1) / BR);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int stages = simt_stages(T_len, M, causal, window, G::BN);
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem(stages));
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, G::smem(stages), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), B, T_len, M, H, causal, window,
      scale * kLog2e, stages);
  return (int)cudaGetLastError();
}

int smem_simt(int hd) {
  switch (hd) {
    case 16: return Simt<16>::smem(2);
    case 32: return Simt<32>::smem(2);
    case 64: return Simt<64>::smem(2);
    case 128: return Simt<128>::smem(2);
    case 256: return Simt<256>::smem(2);
    default: return -1;
  }
}

}  // namespace

extern "C" {

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a block of the route for (hd, bf16) takes, or -1;
// on the f32 route with two ring stages (a launch whose blocks take one key
// tile each takes one).
int repro_flash_attention_smem_bytes(int hd, int bf16) {
  return bf16 ? smem_wgmma(hd) : smem_simt(hd);
}

// q [B, T, H, hd], k and v [B, M, H, hd], o like q, lse [B*H, T] f32; all
// contiguous and 16-byte aligned; bf16 != 0 for __nv_bfloat16 (the
// tensor-core kernel), else float (the SIMT kernel).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int T_len, int M,
                              int H, int hd, int bf16, int causal, int window,
                              float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || M <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    REPRO_FA_DISPATCH(launch_wgmma, hd, q, k, v, o, lse, B, T_len, M, H,
                      causal, window, scale, st)
  }
  REPRO_FA_DISPATCH(launch_simt, hd, q, k, v, o, lse, B, T_len, M, H,
                    causal, window, scale, st)
}

}  // extern "C"