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
// with f32 math whatever the input type, and dq, dk, dv in the input type.
// delta is rowsum(o * do) for the f32 o before its rounding to the input
// type: the JAX kernels read the stored o, and in bf16 its rounding (up to
// 2^-9 of o) moves dq and dk by more than one bf16 ulp from the reference's
// gradient.  K8 therefore accumulates, in one pass over the keys, delta,
// sum_m p dp k and sum_m p k, and forms dq = scale * (sum p dp k - delta *
// sum p k) at the end.
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
// Bound: operations.  At the training shape (B*H 32, T = M 4096, hd 256,
// bf16) the causal layer has 268.5 M visible pairs: dq needs 6*hd FLOP per
// pair (the two dots and the dq update; K8 does 8*hd with its second
// accumulator), 4.12e11, 0.417 ms at the card's 989 TFLOP/s of bf16; K9
// 8*hd (two dots, dk and dv), 0.556 ms.  These first kernels use no tensor
// cores: SIMT f32, as K7.
//
// Design (not the TPU kernels block by block):
//   * K8: one block per (b*h, tile of BQ query rows), heaviest tile first
//     under a causal mask; TPR threads share a row, each holding its slices
//     of q, do and the two accumulators in registers (float4 chunks sub,
//     sub + TPR, ...).  k and v tiles of BK rows are staged in shared memory
//     as f32, only those in [q_first - window + 1, q_last] (causal) or
//     [q_first - window + 1, M) (not causal).  Per key: two partial dots
//     reduced by warp shuffles, then the two axpys and delta's fma.
//   * K9: one block per (b*h, tile of BKV key rows); the block owns its k
//     and v rows and their dk and dv accumulators (registers), so it needs
//     no atomics.  It loops over q, do, lse and delta tiles staged in shared
//     memory, for the queries in [k_first, k_last + window - 1] (pruned at
//     both ends: the causal lower end, the window's upper end), then, when
//     window > 0 and T > M + window - 1, over the rows that see no key
//     (dv += do / M, no dots).
//   * T and M need not be multiples of a tile: rows past T and keys past M
//     compute on zeros and are not stored, and take no weight.
//   * the [B, T, H, hd] layout is read in place (row stride H*hd).
// Build flags keep --fmad=false (K1-K4 rely on it); the products here ask
// for their FMAs explicitly (fmaf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
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
// already at (b, 0, h, 0)) into dst[rows][HD] as f32; rows past n are zero.
template <int HD, int ROWS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* base, int64_t rs,
                                      int r0, int n) {
  for (int e = threadIdx.x; e < ROWS * HD / 4; e += kThreads) {
    const int j = e / (HD / 4), c4 = e % (HD / 4);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < n) x = load4(base + (int64_t)(r0 + j) * rs + 4 * c4);
    store4(dst + j * HD + 4 * c4, x);
  }
}

// ----------------------------------------------------------------------- K8
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int T_len, int M, int H, int causal,
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
  const T* kb = k + (int64_t)b * M * rs + (int64_t)h * HD;
  const T* vb = v + (int64_t)b * M * rs + (int64_t)h * HD;

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

// ----------------------------------------------------------------------- K9
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int T_len, int M, int H, int causal,
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
  const T* qb = q + (int64_t)b * T_len * rs + (int64_t)h * HD;
  const T* db = dout + (int64_t)b * T_len * rs + (int64_t)h * HD;
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

template <int HD, typename T>
int launch_dq(const Args& a) {
  using S = Tile<HD>;
  const int64_t tiles = ((int64_t)a.T_len + S::ROWS - 1) / S::ROWS;
  if ((int64_t)a.B * a.H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * BK * HD;   // 64 KB at hd 256
  auto kernel = flash_bwd_dq_kernel<HD, T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(a.B * a.H));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<T*>(a.dq), a.T_len, a.M, a.H, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch_dkv(const Args& a) {
  using S = Tile<HD>;
  const int64_t tiles = ((int64_t)a.M + S::ROWS - 1) / S::ROWS;
  if ((int64_t)a.B * a.H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * BQ2 * HD + 2 * BQ2);
  auto kernel = flash_bwd_dkv_kernel<HD, T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(a.B * a.H));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.T_len, a.M, a.H,
      a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, bool DQ>
int by_head_dim(int hd, const Args& a) {
  switch (hd) {
    case 16: return DQ ? launch_dq<16, T>(a) : launch_dkv<16, T>(a);
    case 32: return DQ ? launch_dq<32, T>(a) : launch_dkv<32, T>(a);
    case 64: return DQ ? launch_dq<64, T>(a) : launch_dkv<64, T>(a);
    case 128: return DQ ? launch_dq<128, T>(a) : launch_dkv<128, T>(a);
    case 256: return DQ ? launch_dq<256, T>(a) : launch_dkv<256, T>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int dispatch(int hd, int bf16, const Args& a) {
  if (a.B <= 0 || a.T_len <= 0 || a.M <= 0 || a.H <= 0)
    return (int)cudaErrorInvalidValue;
  return bf16 ? by_head_dim<__nv_bfloat16, DQ>(hd, a)
              : by_head_dim<float, DQ>(hd, a);
}

}  // namespace

extern "C" {

const char* repro_flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K8.  q, do, dq [B, T, H, hd]; k, v [B, M, H, hd]; lse, delta [B*H, T]
// f32 (delta is written here, for K9); all contiguous and 16-byte aligned;
// bf16 != 0 for __nv_bfloat16, else float.
int repro_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 void* delta, void* dq, int B, int T_len,
                                 int M, int H, int hd, int bf16, int causal,
                                 int window, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
         B, T_len, M, H, causal, window, scale, (cudaStream_t)stream};
  return dispatch<true>(hd, bf16, a);
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
  return dispatch<false>(hd, bf16, a);
}

}  // extern "C"
