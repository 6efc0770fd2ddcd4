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
// with f32 math whatever the input type.  One extern "C" function launches
// on the caller's stream and returns cudaGetLastError() (0 on success); the
// wrapper in repro_torch/kernels/flash_attention.py checks dtype, shape,
// head_dim, contiguity and alignment first.
//
// Bound: operations.  At the LM's prefill (B*H 64, T = M 4096, hd 256,
// bf16) the causal layer needs 537.0 M unmasked (t, m) pairs x 4*hd =
// 5.50e11 FLOP, 0.556 ms at the card's 989 TFLOP/s of bf16, against 538 MB
// of q, k, v, o and lse, 0.161 ms at 3.35 TB/s.  This first kernel uses no
// tensor cores: it is a SIMT kernel in f32, so the f32 rate outside the
// tensor cores (67 TFLOP/s) bounds it, ~15x above the bf16 bound.
//
// Design (not the TPU kernel block by block):
//   * one block per (b*h, tile of BQ query rows); TPR threads share a query
//     row, each holding its q slice and its slice of the f32 accumulator in
//     registers (columns in float4 chunks sub, sub + TPR, ...); a score is
//     the sum of the TPR partial dots, reduced by warp shuffles;
//   * k and v tiles of BK = 32 rows are staged in shared memory as f32 and
//     read as float4 broadcasts (a warp reads TPR consecutive chunks);
//   * softmax runs online per tile in f32: running max m, sum l and the
//     accumulator, rescaled by exp(m_old - m_new); o = acc / l, lse = m +
//     log(l), as _fwd_kernel:80-82;
//   * whole k tiles outside [q_first - window + 1, q_last] are skipped at
//     both ends (the causal prune of the TPU kernel, plus the window's);
//     a tile holding a row that sees no key at all (only when T > M +
//     window - 1) visits every tile, so that row gets the reference's
//     uniform softmax over the -1e30 scores;
//   * T and M need not be multiples of a tile: rows beyond T are computed
//     from zeros and not stored, keys beyond M are zero in shared memory
//     and take no weight;
//   * the [B, T, H, hd] layout is read in place (row stride H*hd): no
//     transposes to [B*H, T, hd];
//   * query tiles are launched heaviest first (the last causal tiles see
//     the most keys), so the short ones fill the tail of the grid.
// Build flags keep --fmad=false (K1-K4 rely on it); the products here ask
// for their FMAs explicitly (fmaf).  Tensor cores (mma.sync / wgmma), TMA
// and a kv-head-indexed GQA read are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr float kNegInf = -1e30f;      // the reference's mask value

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

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  const T* kb = k + (int64_t)b * M * rs + (int64_t)h * HD;
  const T* vb = v + (int64_t)b * M * rs + (int64_t)h * HD;

  float4 qr[S::CH], acc[S::CH];
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    qr[c] = live ? load4(q + q_off + 4 * (sub + S::TPR * c))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float m = kNegInf, l = 0.0f;

  // the k tiles this query tile can see
  const int q_last = min(q0 + S::BQ, T_len) - 1;
  const int hi = causal ? min(M, q_last + 1) : M;
  int lo = 0;
  if (window > 0 && q_last < M + window - 1)   // every row sees some key
    lo = max(0, q0 - window + 1);

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

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int T_len, int M, int H, int causal, int window,
           float scale, cudaStream_t stream) {
  using S = Tile<HD>;
  const int64_t tiles = ((int64_t)T_len + S::BQ - 1) / S::BQ;
  if ((int64_t)B * H > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * BK * HD;   // 64 KB at hd 256
  auto kernel = flash_fwd_kernel<HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)(B * H));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), T_len, M, H, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int T_len, int M, int H, int causal,
             int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16, T>(q, k, v, o, lse, B, T_len, M, H, causal, window,
                           scale, stream);
    case 32:
      return launch<32, T>(q, k, v, o, lse, B, T_len, M, H, causal, window,
                           scale, stream);
    case 64:
      return launch<64, T>(q, k, v, o, lse, B, T_len, M, H, causal, window,
                           scale, stream);
    case 128:
      return launch<128, T>(q, k, v, o, lse, B, T_len, M, H, causal, window,
                            scale, stream);
    case 256:
      return launch<256, T>(q, k, v, o, lse, B, T_len, M, H, causal, window,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q [B, T, H, hd], k and v [B, M, H, hd], o like q, lse [B*H, T] f32; all
// contiguous and 16-byte aligned; bf16 != 0 for __nv_bfloat16, else float.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int T_len, int M,
                              int H, int hd, int bf16, int causal, int window,
                              float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || M <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, lse, B, T_len, M, H,
                                        causal, window, scale, st)
              : dispatch<float>(hd, q, k, v, o, lse, B, T_len, M, H, causal,
                                window, scale, st);
}

}  // extern "C"
