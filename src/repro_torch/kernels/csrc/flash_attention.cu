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
// of q, k, v, o and lse, 0.161 ms at 3.35 TB/s.
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

#include <math.h>

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
// f32: the SIMT kernel
// --------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int BK = 32;                 // keys per shared-memory tile

template <int HD>
struct Tile {
  static constexpr int TPR = HD >= 128 ? 8 : 4;    // threads per query row
  static constexpr int BQ = kThreads / TPR;         // query rows per block
  static constexpr int CH = HD / (4 * TPR);         // float4 chunks a thread
  static_assert(CH >= 1 && HD % (4 * TPR) == 0, "head_dim");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// One block per (b*h, tile of BQ query rows); TPR threads share a query
// row, each holding its q slice and its slice of the f32 accumulator in
// registers (columns in float4 chunks sub, sub + TPR, ...); a score is the
// sum of the TPR partial dots, reduced by warp shuffles; k and v tiles of
// BK rows are staged in shared memory and read as float4 broadcasts.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T_len, int M, int H,
                 int causal, int window, float scale) {
  using S = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [BK][HD]
  float* Vs = smem + BK * HD;          // [BK][HD]

  const int tid = threadIdx.x;
  const int row = tid / S::TPR, sub = tid % S::TPR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * S::BQ;   // heaviest first
  const int qi = q0 + row;
  const bool live = qi < T_len;
  const int64_t rs = (int64_t)H * HD;  // row stride of [B, *, H, hd]
  const int64_t q_off = ((int64_t)b * T_len + (live ? qi : 0)) * rs +
                        (int64_t)h * HD;
  const float* kb = k + (int64_t)b * M * rs + (int64_t)h * HD;
  const float* vb = v + (int64_t)b * M * rs + (int64_t)h * HD;

  float4 qr[S::CH], acc[S::CH];
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    qr[c] = live ? load4(q + q_off + 4 * (sub + S::TPR * c))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float m = kNegInf, l = 0.0f;

  int lo, hi;                          // the keys this query tile sees
  key_range(q0, min(q0 + S::BQ, T_len) - 1, M, causal, window, lo, hi);

  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    const int nk = min(BK, M - k0);
    __syncthreads();                   // the previous tile is consumed
    for (int e = tid; e < BK * HD / 4; e += kThreads) {
      const int j = e / (HD / 4), c4 = e % (HD / 4);
      float4 kk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vv = kk;
      if (j < nk) {
        const int64_t off = (int64_t)(k0 + j) * rs + 4 * c4;
        kk = load4(kb + off);
        vv = load4(vb + off);
      }
      store4(Ks + j * HD + 4 * c4, kk);
      store4(Vs + j * HD + 4 * c4, vv);
    }
    __syncthreads();

    float s[BK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* kr = Ks + j * HD;
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < S::CH; ++c) {
        const float4 kk = load4(kr + 4 * (sub + S::TPR * c));
        part = fmaf(qr[c].x, kk.x, part);
        part = fmaf(qr[c].y, kk.y, part);
        part = fmaf(qr[c].z, kk.z, part);
        part = fmaf(qr[c].w, kk.w, part);
      }
#pragma unroll
      for (int off = S::TPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int d = qi - (k0 + j);
      const bool seen = (!causal || d >= 0) && (window <= 0 || d < window);
      s[j] = seen ? part * scale : kNegInf;
      if (j < nk) tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = j < nk ? expf(s[j] - m_new) : 0.0f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < S::CH; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* vr = Vs + j * HD;
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < S::CH; ++c) {
        const float4 vv = load4(vr + 4 * (sub + S::TPR * c));
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    const float4 a = acc[c];
    store4(o + q_off + 4 * (sub + S::TPR * c),
           make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
  }
  if (sub == 0) lse[(int64_t)bh * T_len + qi] = m + logf(den);
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int T_len, int M, int H, int causal,
                int window, float scale, cudaStream_t stream) {
  using S = Tile<HD>;
  const int64_t tiles = ((int64_t)T_len + S::BQ - 1) / S::BQ;
  if ((int64_t)B * H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * BK * HD;   // 64 KB at hd 256
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(B * H));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), T_len, M, H, causal, window, scale);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" {

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a block of the route for (hd, bf16) takes, or -1.
int repro_flash_attention_smem_bytes(int hd, int bf16) {
  if (bf16) return smem_wgmma(hd);
  return smem_wgmma(hd) < 0 ? -1 : (int)(2 * sizeof(float) * BK * hd);
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