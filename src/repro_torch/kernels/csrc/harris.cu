// Harris case-study kernels for Hopper (sm_90a), with a plain C interface.
//
// Four kernels stand in for the Pallas TPU kernels of the JAX package's
// src/repro/kernels/harris.py; each is called through one extern "C"
// function that launches on the caller's stream and returns
// cudaGetLastError() (0 on success).  The Python wrappers in
// repro_torch/kernels/harris.py check dtype, shape and contiguity first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false keeps every multiply and add separately rounded, in the
// reference's order of operations, so the kernels agree with the plain
// PyTorch versions (one kernel per op, no contraction) to the last bit.
//
// All four are bound by HBM bytes, not arithmetic: at 1080x1920 f32 the
// Harris stencil does ~64 flops per 8 bytes moved, far below the H100's
// ~295 flops/byte ridge.  So each design moves every input byte once and
// keeps intermediates on chip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float gray_of(const float* p) {
  return 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
}

// K1 cvtColor — replaces kernels/harris.py:cvt_color (_cvt_kernel).
// Bound: 16 bytes per pixel (12 read, 4 written).  One thread per pixel; a
// warp's three loads cover 384 contiguous bytes, so every sector fetched is
// used and the RGB frame is read once.
__global__ void __launch_bounds__(kThreads)
cvt_color_kernel(const float* __restrict__ img, float* __restrict__ out,
                 int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = gray_of(img + 3 * i);
}

// K3 convertScaleAbs — replaces kernels/harris.py:convert_scale_abs
// (_csa_kernel).  Bound: 8 bytes per element.  Elementwise; the comparisons
// pass NaN through as torch.clamp does.
__global__ void __launch_bounds__(kThreads)
convert_scale_abs_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int64_t n, float alpha, float beta) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float v = fabsf(x[i] * alpha + beta);
    out[i] = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
  }
}

// K2 cornerHarris and K4 fused cvtColor -> cornerHarris [-> convertScaleAbs]
// — replace kernels/harris.py:corner_harris (_harris_kernel) and
// harris_fused / harris_fused_pair (_fused_harris_kernel).
//
// One block owns a TH x TW output tile.  The TPU kernels read an
// (rb + 2*halo)-row slab of an image the host had edge-padded with jnp.pad;
// here the block loads its tile plus halo straight from the unpadded input
// with clamped indices (padded coordinate p -> original clamp(p - halo)), so
// the padding pass and its HBM round trip are gone.  Shared memory holds
//   gray    (TH + BS + 1) x (TW + BS + 1)   the tile's gray values + halo
//   Ixx, Iyy, Ixy  3 x (TH + BS - 1) x (TW + BS - 1)   Sobel products
// and HBM sees one read of the input tile (plus a thin halo) and one write
// of the output tile.  For K4 the gray tile is computed from RGB on the way
// into shared memory and never reaches HBM, which is what the fusion saves:
// the unfused chain writes and re-reads the 8.3 MB gray plane.
//
// Bound: K2 8 bytes per pixel, K4 16.  The halo re-read costs
// (TH+BS+1)(TW+BS+1)/(TH*TW) - 1 of the input traffic (~20% at 32x32, much
// of it served by L2).
template <int BS, bool FROM_RGB, bool CSA>
__global__ void __launch_bounds__(kThreads)
harris_tile_kernel(const float* __restrict__ src, float* __restrict__ out,
                   int H, int W, int TH, int TW, float k, float alpha,
                   float beta) {
  extern __shared__ float smem[];
  constexpr int HALO = 1 + BS / 2;
  const int GH = TH + BS + 1, GW = TW + BS + 1;
  const int PH = TH + BS - 1, PW = TW + BS - 1;
  float* g = smem;
  float* ixx = g + GH * GW;
  float* iyy = ixx + PH * PW;
  float* ixy = iyy + PH * PW;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  // 1) the tile and its halo, edge-replicated at the image border
  for (int i = tid; i < GH * GW; i += kThreads) {
    const int gy = i / GW, gx = i - gy * GW;
    const int r = clampi(y0 - HALO + gy, 0, H - 1);
    const int c = clampi(x0 - HALO + gx, 0, W - 1);
    const int64_t off = (int64_t)r * W + c;
    g[i] = FROM_RGB ? gray_of(src + 3 * off) : src[off];
  }
  __syncthreads();

  // 2) 3x3 Sobel at every position the box filter reads, in the
  //    reference's order of operations
  for (int i = tid; i < PH * PW; i += kThreads) {
    const int py = i / PW, px = i - py * PW;
    const float* a = g + py * GW + px;
    const float* b = a + GW;
    const float* c = b + GW;
    const float dx = a[2] + 2.0f * b[2] + c[2] - a[0] - 2.0f * b[0] - c[0];
    const float dy = c[0] + 2.0f * c[1] + c[2] - a[0] - 2.0f * a[1] - a[2];
    ixx[i] = dx * dx;
    iyy[i] = dy * dy;
    ixy[i] = dx * dy;
  }
  __syncthreads();

  // 3) BS x BS box sums and the response R = det - k * tr^2
  for (int i = tid; i < TH * TW; i += kThreads) {
    const int oy = i / TW, ox = i - oy * TW;
    const int y = y0 + oy, x = x0 + ox;
    if (y >= H || x >= W) continue;
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int by = 0; by < BS; ++by) {
#pragma unroll
      for (int bx = 0; bx < BS; ++bx) {
        const int j = (oy + by) * PW + ox + bx;
        sxx += ixx[j];
        syy += iyy[j];
        sxy += ixy[j];
      }
    }
    const float det = sxx * syy - sxy * sxy;
    const float tr = sxx + syy;
    float r = det - k * tr * tr;
    if (CSA) {
      r = fabsf(r * alpha + beta);
      r = r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r);
    }
    out[(int64_t)y * W + x] = r;
  }
}

size_t tile_smem_bytes(int th, int tw, int bs) {
  return sizeof(float) * ((size_t)(th + bs + 1) * (tw + bs + 1) +
                          3 * (size_t)(th + bs - 1) * (tw + bs - 1));
}

template <int BS, bool FROM_RGB, bool CSA>
int launch_tile(const void* src, void* out, int H, int W, int th, int tw,
                float k, float alpha, float beta, cudaStream_t stream) {
  auto kernel = harris_tile_kernel<BS, FROM_RGB, CSA>;
  const size_t smem = tile_smem_bytes(th, tw, BS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + tw - 1) / tw, (H + th - 1) / th);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(src), static_cast<float*>(out), H, W, th, tw,
      k, alpha, beta);
  return (int)cudaGetLastError();
}

template <bool FROM_RGB, bool CSA>
int launch_bs(int bs, const void* src, void* out, int H, int W, int th,
              int tw, float k, float alpha, float beta, cudaStream_t stream) {
  switch (bs) {
    case 2:
      return launch_tile<2, FROM_RGB, CSA>(src, out, H, W, th, tw, k, alpha,
                                           beta, stream);
    case 3:
      return launch_tile<3, FROM_RGB, CSA>(src, out, H, W, th, tw, k, alpha,
                                           beta, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int repro_cvt_color_f32(const void* img, void* out, int64_t n_pixels,
                        void* stream) {
  cvt_color_kernel<<<blocks_for(n_pixels), kThreads, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const float*>(img), static_cast<float*>(out), n_pixels);
  return (int)cudaGetLastError();
}

int repro_convert_scale_abs_f32(const void* x, void* out, int64_t n,
                                float alpha, float beta, void* stream) {
  convert_scale_abs_kernel<<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, alpha, beta);
  return (int)cudaGetLastError();
}

int repro_corner_harris_f32(const void* gray, void* out, int H, int W, int bs,
                            float k, int th, int tw, void* stream) {
  return launch_bs<false, false>(bs, gray, out, H, W, th, tw, k, 1.0f, 0.0f,
                                 (cudaStream_t)stream);
}

int repro_harris_fused_f32(const void* img, void* out, int H, int W, int bs,
                           float k, int with_csa, float alpha, float beta,
                           int th, int tw, void* stream) {
  if (with_csa)
    return launch_bs<true, true>(bs, img, out, H, W, th, tw, k, alpha, beta,
                                 (cudaStream_t)stream);
  return launch_bs<true, false>(bs, img, out, H, W, th, tw, k, alpha, beta,
                                (cudaStream_t)stream);
}

int64_t repro_harris_tile_smem_bytes(int th, int tw, int bs) {
  return (int64_t)tile_smem_bytes(th, tw, bs);
}

}  // extern "C"
