// RMSNorm kernels for Hopper (sm_90a), with a plain C interface.
//
// Two kernels stand in for the Pallas TPU kernels of the JAX package's
// src/repro/kernels/rmsnorm.py; each is called through one extern "C"
// function that launches on the caller's stream and returns
// cudaGetLastError() (0 on success).  The Python wrappers in
// repro_torch/kernels/rmsnorm.py check dtype, shape and contiguity first and
// flatten leading dims to rows, so a micro-batched group [B, T, d] is one
// launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false stops nvcc contracting a separate multiply and add into an
// FMA; the GEMM's inner product asks for its FMAs explicitly (fmaf), which
// that flag leaves alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --------------------------------------------------------------------------
// K5 rmsnorm — replaces kernels/rmsnorm.py:rmsnorm (_rmsnorm_kernel).
//
// out = x * rsqrt(mean(x^2) + eps) * (1 + s), f32 math, one block per row.
// Bound: HBM bytes.  It does ~4 flops per 8 bytes moved; at the main path's
// [2048, 8192] that is 134 MB (x read once, out written once), 0.040 ms at
// 3.35 TB/s.  The design reads each row once from HBM with 16-byte loads
// where d % 4 == 0 (the second pass over the row, for the output, finds it
// in L1/L2: one row is 32 KB), and does the row's sum in one block-wide
// shuffle reduction, so no partial sum leaves the SM.
// --------------------------------------------------------------------------
constexpr int kNormThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;                                   // the row's sum, in every lane
}

template <bool VEC>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ s,
               float* __restrict__ out, int d, float eps) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const float* xr = x + row * d;
  float* orow = out + row * d;
  float acc = 0.0f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < d / 4; i += blockDim.x) {
      const float4 v = x4[i];
      acc += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float v = xr[i];
      acc += v * v;
    }
  }
  const float r = rsqrtf(block_sum(acc, red) / (float)d + eps);
  // the reference's order: (x * rsqrt(var + eps)) * (1 + s)
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int i = threadIdx.x; i < d / 4; i += blockDim.x) {
      const float4 v = x4[i], g = s4[i];
      o4[i] = make_float4(v.x * r * (1.0f + g.x), v.y * r * (1.0f + g.y),
                          v.z * r * (1.0f + g.z), v.w * r * (1.0f + g.w));
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      orow[i] = xr[i] * r * (1.0f + s[i]);
  }
}

// --------------------------------------------------------------------------
// K6 rmsnorm_matmul — replaces kernels/rmsnorm.py:rmsnorm_matmul
// (_rmsnorm_matmul_kernel).
//
// out[m, n] = rsqrt(mean_k x[m,k]^2 + eps) * sum_k x[m,k] * (1 + s[k]) * w[k,n]
//
// The Pallas kernel holds all of w in one block; at the lm head's
// d 8192 x dout 102400 that is 3.36 GB, so this kernel tiles it.  Bound:
// operations.  A group of 4 requests (N = 2048 rows) is 2*2048*8192*102400 =
// 3.44 TFLOP, ~51 ms at the card's 67 TFLOP/s of f32 outside the tensor
// cores, while its bytes (w once, x once, out once) take ~1.27 ms.  So the
// design is a plain f32 SIMT GEMM with enough reuse to stay compute-bound:
//   * one block owns a BM x BN = 128 x 128 output tile; 256 threads each
//     hold 8 x 8 accumulators in registers (64 FMAs per 4 shared loads);
//   * the K-loop stages a BK = 8 slice of x (transposed, As[k][m]) and of w
//     (scaled by (1 + s[k]) on the way in, Bs[k][n]) in shared memory, and
//     prefetches the next slice into registers while computing this one;
//   * the norm is taken apart: the per-row rsqrt commutes out of the sum,
//     so 128 threads accumulate sum(x^2) of their row from As in the same
//     K-loop and the epilogue multiplies each output row by its scale.  The
//     normalised [N, d] activations never exist, in HBM or anywhere.
// No tensor cores and no TF32, so the products stay in f32; the sum runs in
// another order than the plain version's, hence a 1e-4 tolerance.
// --------------------------------------------------------------------------
constexpr int BM = 128, BN = 128, BK = 8, kGemmThreads = 256;

template <bool VEC>
__global__ void __launch_bounds__(kGemmThreads)
rmsnorm_matmul_kernel(const float* __restrict__ x, const float* __restrict__ s,
                      const float* __restrict__ w, float* __restrict__ out,
                      int M, int N, int K, float eps) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float rs[BM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // loaders: x rows am, k offsets ak..ak+3; w row bk, columns bn..bn+3
  const int am = tid >> 1, ak = (tid & 1) * 4;
  const int bk = tid >> 5, bn = (tid & 31) * 4;
  // compute: rows ty*4+i and 64+ty*4+i, columns tx*4+j and 64+tx*4+j
  const int ty = tid >> 4, tx = tid & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float sq = 0.0f;                     // sum of x^2 of row m0 + tid (tid < BM)
  float a_reg[4], b_reg[4];

  auto load = [&](int k0) {
    const int gm = m0 + am, ka = k0 + ak;
    if (VEC) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gm < M && ka < K)
        v = *reinterpret_cast<const float4*>(x + (int64_t)gm * K + ka);
      a_reg[0] = v.x; a_reg[1] = v.y; a_reg[2] = v.z; a_reg[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a_reg[i] = (gm < M && ka + i < K) ? x[(int64_t)gm * K + ka + i] : 0.0f;
    }
    const int kb = k0 + bk, gn = n0 + bn;
    const float g = kb < K ? 1.0f + s[kb] : 0.0f;
    if (VEC) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kb < K && gn < N)
        v = *reinterpret_cast<const float4*>(w + (int64_t)kb * N + gn);
      b_reg[0] = v.x * g; b_reg[1] = v.y * g;
      b_reg[2] = v.z * g; b_reg[3] = v.w * g;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b_reg[j] = (kb < K && gn + j < N) ? w[(int64_t)kb * N + gn + j] * g
                                          : 0.0f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[ak + i][am] = a_reg[i];
    *reinterpret_cast<float4*>(&Bs[bk][bn]) =
        make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);    // next slice in flight during compute
    if (tid < BM) {
#pragma unroll
      for (int k = 0; k < BK; ++k) sq = fmaf(As[k][tid], As[k][tid], sq);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BM) rs[tid] = rsqrtf(sq / (float)K + eps);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lm = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const int gm = m0 + lm;
    if (gm >= M) continue;
    const float r = rs[lm];
    float* orow = out + (int64_t)gm * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      const float* c = &acc[i][h * 4];
      if (VEC && gn + 3 < N) {
        *reinterpret_cast<float4*>(orow + gn) =
            make_float4(c[0] * r, c[1] * r, c[2] * r, c[3] * r);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) orow[gn + j] = c[j] * r;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

const char* repro_rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int repro_rmsnorm_f32(const void* x, const void* s, void* out, int64_t rows,
                      int d, float eps, void* stream) {
  if (rows > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(s) &&
                   aligned16(out);
  auto kernel = vec ? rmsnorm_kernel<true> : rmsnorm_kernel<false>;
  kernel<<<(unsigned)rows, kNormThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(s),
      static_cast<float*>(out), d, eps);
  return (int)cudaGetLastError();
}

int repro_rmsnorm_matmul_f32(const void* x, const void* s, const void* w,
                             void* out, int M, int N, int K, float eps,
                             void* stream) {
  const int grid_y = (M + BM - 1) / BM;
  if (M <= 0 || N <= 0 || K <= 0 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  auto kernel = vec ? rmsnorm_matmul_kernel<true>
                    : rmsnorm_matmul_kernel<false>;
  dim3 grid((N + BN - 1) / BN, grid_y);
  kernel<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<float*>(out), M, N, K, eps);
  return (int)cudaGetLastError();
}

// Shared memory one K6 block holds (the fusion gate reckons this tile).
int64_t repro_rmsnorm_matmul_smem_bytes(void) {
  return (int64_t)sizeof(float) * (BK * BM + BK * BN + BM);
}

}  // extern "C"
