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
// ~295 flops/byte ridge.  So each design moves every input byte once, keeps
// intermediates on chip, and keeps enough bytes in flight to cover HBM's
// latency: ~3.35e12 B/s x ~700 ns / 132 SMs ~ 18 KB an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // K1 and K3 threads a block
constexpr int kCsaUnroll = 4;      // K3: loads a thread issues before any use

constexpr int kTileThreads = 128;  // K2/K4 threads a block
constexpr int kMY = 2, kMX = 4;    // K2/K4: one thread's output micro-tile
constexpr int kHalo = 2;           // 1 + BS / 2 for BS 2 and 3
constexpr int kPadX = 4;           // columns copied beside the tile, each side
// K2/K4 blocks resident an SM that ptxas builds for (at most 85 registers a
// thread): with no minimum it gave K4 at BS 3 72 registers and a 4-byte
// spill; with this one, 80 and none
constexpr int kTileMinBlocks = 6;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float gray_of(const float* p) {
  return 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
}

__device__ __forceinline__ float csa(float x, float alpha, float beta) {
  const float v = fabsf(x * alpha + beta);
  return v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);   // NaN passes
}

__device__ __forceinline__ float4 csa(float4 x, float alpha, float beta) {
  return make_float4(csa(x.x, alpha, beta), csa(x.y, alpha, beta),
                     csa(x.z, alpha, beta), csa(x.w, alpha, beta));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
// (_csa_kernel).  Bound: 8 bytes per element.  A grid sized to the SMs
// walks the input in strides; each thread issues kCsaUnroll independent
// loads before it uses any (16-byte float4 loads where both pointers are
// 16-byte aligned, V = float4; 4-byte ones otherwise, V = float), so an SM
// has up to 2048 x 64 B in flight instead of one 4-byte load a thread.  The
// n % 4 elements past the last float4 (`tail`) go to block 0.
template <typename V>
__global__ void __launch_bounds__(kThreads)
convert_scale_abs_kernel(const V* __restrict__ x, V* __restrict__ out,
                         int64_t nv, const float* __restrict__ x_tail,
                         float* __restrict__ out_tail, int tail, float alpha,
                         float beta) {
  const int64_t step = (int64_t)kThreads * kCsaUnroll;
  for (int64_t i0 = blockIdx.x * step + threadIdx.x; i0 < nv;
       i0 += gridDim.x * step) {
    V v[kCsaUnroll];
#pragma unroll
    for (int j = 0; j < kCsaUnroll; ++j)
      if (i0 + j * kThreads < nv) v[j] = x[i0 + j * kThreads];
#pragma unroll
    for (int j = 0; j < kCsaUnroll; ++j)
      if (i0 + j * kThreads < nv)
        out[i0 + j * kThreads] = csa(v[j], alpha, beta);
  }
  if (blockIdx.x == 0 && threadIdx.x < tail)
    out_tail[threadIdx.x] = csa(x_tail[threadIdx.x], alpha, beta);
}

// K2 cornerHarris and K4 fused cvtColor -> cornerHarris [-> convertScaleAbs]
// — replace kernels/harris.py:corner_harris (_harris_kernel) and
// harris_fused / harris_fused_pair (_fused_harris_kernel).
//
// Bound: K2 8 bytes per pixel, K4 16.  The TPU kernels read an
// (rb + 2*halo)-row slab of an image the host had edge-padded with jnp.pad;
// here a block copies each TH x TW output tile's source straight from the
// unpadded input, edge-replicated by clamped source addresses (padded
// coordinate p -> original clamp(p - halo)), so the padding pass and its
// HBM round trip are gone, and HBM sees one read of the input (the halo
// rows and columns that neighbouring tiles share come mostly from L2) and
// one write of the output.
//
// Bytes in flight.  One block a tile; a block issues all of its tile's
// copies with cp.async, which needs no register and no wait, before it
// waits for any, so the blocks resident on an SM keep tens of KB in
// flight, past the ~18 KB HBM's latency asks.  (A grid of at most the
// blocks that fit, each walking several tiles with the next one's copies
// in flight, was slower on the H100 for K2 and K4.)  A tile's source is
// (TH + BS + 1) rows of TW + 2 * kPadX pixels starting kPadX left of it:
// at a 16-byte aligned column, so when W % 4 == 0 and the pointer is
// 16-byte aligned every row is a run of 16-byte copies, each wholly inside
// the image or wholly outside (then four clamped 4-byte copies); otherwise
// all copies are clamped 4-byte ones.  No division an element: thread i starts at
// (row, vector) = divmod(i, vectors a row) and steps by kTileThreads.
//
// Compute.  No product arrays: each thread owns a kMY x kMX micro-tile of
// outputs, streams its (kMY + BS + 1) gray rows from shared memory with
// 16-byte loads, computes the Sobel products its box sums need in registers
// (those shared with a neighbouring thread are recomputed: flops are spare)
// and accumulates the box sums there.  The order of operations is the
// reference's: dx, dy, the products, the box sum by rows then columns from
// 0.0f, then det - k * tr^2.
//
// K4 (FROM_RGB) copies the RGB source (3 floats a pixel) the same way and
// converts each landed tile to a gray tile in shared memory before the
// stencil; the gray plane never reaches HBM, which is what the fusion saves.
template <bool FROM_RGB>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int H,
                                          int W, int y0, int x0, int GH,
                                          int L, bool vec) {
  constexpr int C = FROM_RGB ? 3 : 1;
  const int nv = L / 4;                        // 16-byte vectors a row
  const int row_step = kTileThreads / nv, v_step = kTileThreads - row_step * nv;
  int r = threadIdx.x / nv, v = threadIdx.x - r * nv;
  for (; r < GH; r += row_step) {
    const float* row =
        src + (int64_t)clampi(y0 - kHalo + r, 0, H - 1) * W * C;
    const int f = 4 * v;                       // float in the row segment
    const int c = (x0 - kPadX) * C + f;        // float in the image row
    if (vec && c >= 0 && c + 4 <= W * C) {
      cp_async16(dst + r * L + f, row + c);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = (f + j) / C;             // C is 1 or 3: no divide
        cp_async4(dst + r * L + f + j,
                  row + clampi(x0 - kPadX + p, 0, W - 1) * C + (f + j - p * C));
      }
    }
    v += v_step;
    if (v >= nv) {
      v -= nv;
      ++r;
    }
  }
}

// one thread's kMY x kMX outputs at tile offset (oy, ox); g is the gray
// tile (row pitch GP), whose column ox + 2 + j holds the padded column j of
// the outputs' window
template <int BS, bool CSA>
__device__ __forceinline__ void micro_tile(const float* g, int GP, int oy,
                                           int ox, int y, int x, int H, int W,
                                           float* __restrict__ out, bool vec,
                                           float k, float alpha, float beta) {
  constexpr int PX = kMX + BS - 1;             // product columns
  float sxx[kMY][kMX], syy[kMY][kMX], sxy[kMY][kMX];
#pragma unroll
  for (int my = 0; my < kMY; ++my)
#pragma unroll
    for (int mx = 0; mx < kMX; ++mx)
      sxx[my][mx] = syy[my][mx] = sxy[my][mx] = 0.0f;

  // gray rows py, py + 1 and py + 2 of the window, smem columns ox .. ox + 11
  float a[12], b[12], c[12];
  auto load = [&](float (&d)[12], int r) {
    const float4* p = reinterpret_cast<const float4*>(g + (oy + r) * GP + ox);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 t = p[q];
      d[4 * q] = t.x;
      d[4 * q + 1] = t.y;
      d[4 * q + 2] = t.z;
      d[4 * q + 3] = t.w;
    }
  };
  load(a, 0);
  load(b, 1);
#pragma unroll
  for (int py = 0; py < kMY + BS - 1; ++py) {
    load(c, py + 2);
    float pxx[PX], pyy[PX], pxy[PX];
#pragma unroll
    for (int px = 0; px < PX; ++px) {
      const int j = 2 + px;                    // window column 0 of product px
      const float dx = a[j + 2] + 2.0f * b[j + 2] + c[j + 2] - a[j] -
                       2.0f * b[j] - c[j];
      const float dy = c[j] + 2.0f * c[j + 1] + c[j + 2] - a[j] -
                       2.0f * a[j + 1] - a[j + 2];
      pxx[px] = dx * dx;
      pyy[px] = dy * dy;
      pxy[px] = dx * dy;
    }
#pragma unroll
    for (int my = 0; my < kMY; ++my) {
      if (py - my < 0 || py - my >= BS) continue;   // box row by = py - my
#pragma unroll
      for (int mx = 0; mx < kMX; ++mx)
#pragma unroll
        for (int bx = 0; bx < BS; ++bx) {
          sxx[my][mx] += pxx[mx + bx];
          syy[my][mx] += pyy[mx + bx];
          sxy[my][mx] += pxy[mx + bx];
        }
    }
#pragma unroll
    for (int q = 0; q < 12; ++q) {             // slide the window down a row
      a[q] = b[q];
      b[q] = c[q];
    }
  }

#pragma unroll
  for (int my = 0; my < kMY; ++my) {
    if (y + my >= H) break;
    float r[kMX];
#pragma unroll
    for (int mx = 0; mx < kMX; ++mx) {
      const float det = sxx[my][mx] * syy[my][mx] - sxy[my][mx] * sxy[my][mx];
      const float tr = sxx[my][mx] + syy[my][mx];
      r[mx] = det - k * tr * tr;
      if (CSA) r[mx] = csa(r[mx], alpha, beta);
    }
    float* o = out + (int64_t)(y + my) * W + x;
    if (vec) {                                 // x % 4 == 0 == W % 4
      if (x < W)
        *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int mx = 0; mx < kMX; ++mx)
        if (x + mx < W) o[mx] = r[mx];
    }
  }
}

template <int BS, bool FROM_RGB, bool CSA>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
harris_tile_kernel(const float* __restrict__ src, float* __restrict__ out,
                   int H, int W, int TH, int TW, bool vec, float k,
                   float alpha, float beta) {
  constexpr int C = FROM_RGB ? 3 : 1;
  extern __shared__ __align__(16) float smem[];
  const int GH = TH + BS + 1, GP = TW + 2 * kPadX, L = GP * C;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  copy_tile<FROM_RGB>(smem, src, H, W, y0, x0, GH, L, vec);
  cp_async_wait_all();
  __syncthreads();
  const float* g = smem;
  if (FROM_RGB) {
    float* gray = smem + GH * L;               // the converted tile
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < GH; r += kTileThreads / 32)
      for (int c = lane; c < GP; c += 32)
        gray[r * GP + c] = gray_of(smem + r * L + C * c);
    __syncthreads();
    g = gray;
  }
  const int mxn = TW / kMX;                    // micro-tiles across a tile
  const int tx = threadIdx.x % mxn, ty = threadIdx.x / mxn;
  for (int oy = kMY * ty; oy < TH; oy += kMY * (kTileThreads / mxn))
    micro_tile<BS, CSA>(g, GP, oy, kMX * tx, y0 + oy, x0 + kMX * tx, H, W,
                        out, vec, k, alpha, beta);
}

// a tile the kernel takes: whole micro-tiles, and micro-tile columns that
// divide the block's threads
bool tile_ok(int th, int tw) {
  return th >= kMY && tw >= kMX && th % kMY == 0 && tw % kMX == 0 &&
         tw / kMX <= kTileThreads && kTileThreads % (tw / kMX) == 0;
}

size_t tile_smem_bytes(int th, int tw, int bs, bool from_rgb) {
  const size_t px = (size_t)(th + bs + 1) * (tw + 2 * kPadX);
  return sizeof(float) * px * (from_rgb ? 4 : 1);   // K4: RGB, then gray
}

template <int BS, bool FROM_RGB, bool CSA>
int launch_tile(const void* src, void* out, int H, int W, int th, int tw,
                float k, float alpha, float beta, cudaStream_t stream) {
  if (!tile_ok(th, tw)) return (int)cudaErrorInvalidValue;
  auto kernel = harris_tile_kernel<BS, FROM_RGB, CSA>;
  const size_t smem = tile_smem_bytes(th, tw, BS, FROM_RGB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = W % 4 == 0 && (uintptr_t)src % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  dim3 grid((W + tw - 1) / tw, (H + th - 1) / th);
  kernel<<<grid, kTileThreads, smem, stream>>>(
      static_cast<const float*>(src), static_cast<float*>(out), H, W, th, tw,
      vec, k, alpha, beta);
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

// K3's grid: enough blocks for one pass, at most as many as fit on the SMs
template <typename V>
int csa_grid(int64_t nv, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, convert_scale_abs_kernel<V>, kThreads, 0);
  const int64_t need = (nv + (int64_t)kThreads * kCsaUnroll - 1) /
                       ((int64_t)kThreads * kCsaUnroll);
  const int64_t slots = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = (int)(need < slots ? (need > 0 ? need : 1) : slots);
  return (int)e;
}

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
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  int grid = 0, e = 0;
  if ((uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0) {
    const int64_t nv = n / 4;
    if ((e = csa_grid<float4>(nv, &grid)) != 0) return e;
    convert_scale_abs_kernel<float4><<<grid, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(xf), reinterpret_cast<float4*>(of),
        nv, xf + 4 * nv, of + 4 * nv, (int)(n - 4 * nv), alpha, beta);
  } else {
    if ((e = csa_grid<float>(n, &grid)) != 0) return e;
    convert_scale_abs_kernel<float><<<grid, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        xf, of, n, xf, of, 0, alpha, beta);
  }
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

int64_t repro_harris_tile_smem_bytes(int th, int tw, int bs, int from_rgb) {
  return (int64_t)tile_smem_bytes(th, tw, bs, from_rgb != 0);
}

}  // extern "C"
