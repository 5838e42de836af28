// Whole-sequence ConvGRU forward (K1) for Hopper (sm_90a).
//
// Replaces dvdgan_tpu/kernels/convgru_seq.py:_seq_pallas -> _gru_seq_kernel,
// whose step body is dvdgan_tpu/kernels/convgru_cell.py:kernel_gru_step:
//
//   gh = conv3x3(h, wg)                  f32 accumulate; gx added in f32
//   r, z = sigmoid(gx + gh)              f32
//   rh = r * h                           f32, rounded to the activation type
//   ch = conv3x3(rh, wc)                 f32 accumulate
//   h' = (1 - z) h + z tanh(cx + ch)     f32, rounded once
//
// Both 3x3 SAME convs are computed here, in the kernels' own bodies (no
// cuDNN or cuBLAS). Design: two launches per time step, the structure the
// H-blocked TPU kernel (convgru_blocked.py) already uses, driven by a host
// loop over T on the caller's stream.
//   * gate launch:      reads h_{t-1} and gx[t]; writes z (f32 scratch) and
//                       r*h (activation-type scratch).
//   * candidate launch: reads r*h with a zero SAME halo, cx[t], z, h_{t-1};
//                       writes hs[t].
// Each CTA takes one batch index x one spatial tile x one block of output
// channels. It stages the tile's (tile+2)^2 halo and a chunk of input
// channels of the weights in shared memory (as f32), and each of its
// threads accumulates 4 neighbouring pixels x 4 neighbouring output
// channels in registers (CUDA-core FMAs).
//
// What bounds it on the H100: per level and step the two convs do
// 9*C*3C MACs per pixel. At B=16 the 4x4x256 and 8x8x256 levels give
// 64-128 CTAs per launch on 132 SMs (one CTA, 2-8 warps, per SM), and a
// 4x4 tile uses each staged weight for only 16 FMAs: those levels are
// bound by the latency of staging from L2 and of the FMA chains, not by
// bytes or FLOPs. The 32x32x64 level (512 gate CTAs of 8 warps) is closer
// to compute-bound on the CUDA cores.
// The recurrent state (at most 16*32*32*64*2 B = 2 MB for the flagship)
// and the weights stay in the 50 MB L2 between launches, which stands in
// for the TPU kernel's VMEM-resident carry. wgmma, TMA and CUDA-graph
// capture of the step loop are left for later work.
//
// Layouts (channels-last, as the reference): h, rh, z, hs planes are
// contiguous (B, H, W, C); gx/cx are read at pixel stride `pix` and batch
// stride `bstride` (the hoisted input conv's channel slices, or a
// stride-0-in-T broadcast); weights are HWIO (3, 3, Cin, Cout), contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A CTA's tile: TH x TW pixels, OCB output channels, CIC input channels
// staged per shared-memory chunk. Each thread owns PM pixels along x and
// OM consecutive output channels.
template <int TH_, int TW_, int OCB_, int CIC_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_, OCB = OCB_, CIC = CIC_;
  static constexpr int PM = 4, OM = 4;
  static constexpr int XG = TW / PM;             // pixel groups per row
  static constexpr int PG = TH * XG;             // pixel groups
  static constexpr int OG = OCB / OM;            // channel groups
  static constexpr int THREADS = PG * OG;
  static constexpr int HH = TH + 2, HW = TW + 2;
  static constexpr int IN_SMEM = CIC * HH * HW;  // floats
  static constexpr int W_SMEM = 9 * CIC * OCB;   // floats
  static_assert(TW % PM == 0, "tile width must be a multiple of PM");
  static_assert(THREADS % 32 == 0 && THREADS <= 256, "whole warps, <= 256");
  static_assert((IN_SMEM + W_SMEM) * 4 <= 48 * 1024, "static smem limit");
};

using TileWide = Tile<8, 8, 64, 16>;    // planes of 8x8 and up: 256 threads
using TileSmall = Tile<4, 4, 64, 16>;   // 4x4 planes: 64 threads, so that
                                        // B=16 still gives 128 gate CTAs

// acc[p][j] += sum_{dy,dx,ci} src[y0+py+dy-1, x0+px+p+dx-1, ci] *
//              w[dy, dx, ci, oc0+og*OM+j]   (zero outside the plane)
// src points at one batch element's plane; pixel (y, x) starts at
// src + (y*W + x)*pix.
template <class TL, typename T>
__device__ __forceinline__ void conv3x3_tile(
    const T* __restrict__ src, int64_t pix, int H, int W, int Cin,
    const T* __restrict__ w, int Cout, int y0, int x0, int oc0,
    float* __restrict__ in_s, float* __restrict__ w_s,
    float (&acc)[TL::PM][TL::OM]) {
  const int tid = threadIdx.x;
  const int og = tid % TL::OG;
  const int pg = tid / TL::OG;
  const int py = pg / TL::XG;
  const int px = (pg % TL::XG) * TL::PM;

  // Staging issues a batch of independent global loads of raw elements
  // into registers, and converts to f32 only on the shared-memory store,
  // so that many loads are in flight: a load-convert-store loop waits out
  // each load's L2 latency in turn, which cost more than the FMAs at every
  // flagship level.
  constexpr int IN_ITERS = (TL::IN_SMEM + TL::THREADS - 1) / TL::THREADS;
  constexpr int W_ITERS = TL::W_SMEM / TL::THREADS;
  constexpr int W_BATCH = 12;
  static_assert(TL::W_SMEM % TL::THREADS == 0 && W_ITERS % W_BATCH == 0,
                "weight staging splits evenly into batches");

  for (int ci0 = 0; ci0 < Cin; ci0 += TL::CIC) {
    __syncthreads();  // the previous chunk has been consumed
    T xr[IN_ITERS];
    bool xok[IN_ITERS];
#pragma unroll
    for (int k = 0; k < IN_ITERS; ++k) {
      const int i = tid + k * TL::THREADS;
      const int hp = i / TL::CIC;
      const int y = y0 - 1 + hp / TL::HW, x = x0 - 1 + hp % TL::HW;
      const int ci = ci0 + i % TL::CIC;
      xok[k] = i < TL::IN_SMEM && y >= 0 && y < H && x >= 0 && x < W && ci < Cin;
      if (xok[k]) xr[k] = src[(int64_t)(y * W + x) * pix + ci];
    }
#pragma unroll
    for (int k = 0; k < IN_ITERS; ++k) {
      const int i = tid + k * TL::THREADS;
      const int hp = i / TL::CIC;
      if (i < TL::IN_SMEM)
        in_s[((i % TL::CIC) * TL::HH + hp / TL::HW) * TL::HW + hp % TL::HW] =
            xok[k] ? to_f(xr[k]) : 0.f;
    }
#pragma unroll 1
    for (int k0 = 0; k0 < W_ITERS; k0 += W_BATCH) {
      T wr[W_BATCH];
      bool wok[W_BATCH];
#pragma unroll
      for (int k = 0; k < W_BATCH; ++k) {
        const int i = tid + (k0 + k) * TL::THREADS;
        const int r = i / TL::OCB;
        const int ci = ci0 + r % TL::CIC, tap = r / TL::CIC;
        const int oc = oc0 + i % TL::OCB;
        wok[k] = ci < Cin && oc < Cout;
        if (wok[k]) wr[k] = w[((int64_t)tap * Cin + ci) * Cout + oc];
      }
#pragma unroll
      for (int k = 0; k < W_BATCH; ++k)  // layout [tap][cil][ocl]
        w_s[tid + (k0 + k) * TL::THREADS] = wok[k] ? to_f(wr[k]) : 0.f;
    }
    __syncthreads();

    const int cmax = min(TL::CIC, Cin - ci0);
    for (int cil = 0; cil < cmax; ++cil) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row = in_s + (cil * TL::HH + py + dy) * TL::HW + px;
        float xin[TL::PM + 2];
#pragma unroll
        for (int k = 0; k < TL::PM + 2; ++k) xin[k] = row[k];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              w_s + ((dy * 3 + dx) * TL::CIC + cil) * TL::OCB + og * TL::OM);
#pragma unroll
          for (int p = 0; p < TL::PM; ++p) {
            const float xv = xin[p + dx];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }
  }
}

// grid: (spatial tiles, ceil(2C / OCB), B)
template <class TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
gate_kernel(const T* __restrict__ h, const T* __restrict__ gx,
            int64_t gx_bstride, int64_t gx_pix, const T* __restrict__ wg,
            T* __restrict__ rh, float* __restrict__ z, int H, int W, int C) {
  __shared__ __align__(16) float in_s[TL::IN_SMEM];
  __shared__ __align__(16) float w_s[TL::W_SMEM];
  const int tiles_x = (W + TL::TW - 1) / TL::TW;
  const int y0 = (blockIdx.x / tiles_x) * TL::TH;
  const int x0 = (blockIdx.x % tiles_x) * TL::TW;
  const int oc0 = blockIdx.y * TL::OCB;
  const int b = blockIdx.z;
  const int64_t plane = (int64_t)b * H * W;
  const T* hb = h + plane * C;

  float acc[TL::PM][TL::OM] = {};
  conv3x3_tile<TL, T>(hb, C, H, W, C, wg, 2 * C, y0, x0, oc0, in_s, w_s, acc);

  const int og = threadIdx.x % TL::OG;
  const int pg = threadIdx.x / TL::OG;
  const int y = y0 + pg / TL::XG;
  if (y >= H) return;
  const T* gxb = gx + (int64_t)b * gx_bstride;
#pragma unroll
  for (int p = 0; p < TL::PM; ++p) {
    const int x = x0 + (pg % TL::XG) * TL::PM + p;
    if (x >= W) continue;
    const int64_t q = (int64_t)y * W + x;
#pragma unroll
    for (int j = 0; j < TL::OM; ++j) {
      const int oc = oc0 + og * TL::OM + j;
      if (oc >= 2 * C) continue;
      const float a = to_f(gxb[q * gx_pix + oc]) + acc[p][j];
      const float s = 1.f / (1.f + expf(-a));
      if (oc < C)
        rh[(plane + q) * C + oc] = from_f<T>(s * to_f(hb[q * C + oc]));
      else
        z[(plane + q) * C + (oc - C)] = s;
    }
  }
}

// grid: (spatial tiles, ceil(C / OCB), B)
template <class TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
cand_kernel(const T* __restrict__ rh, const T* __restrict__ cx,
            int64_t cx_bstride, int64_t cx_pix, const T* __restrict__ wc,
            const float* __restrict__ z, const T* __restrict__ h_prev,
            T* __restrict__ h_out, int H, int W, int C) {
  __shared__ __align__(16) float in_s[TL::IN_SMEM];
  __shared__ __align__(16) float w_s[TL::W_SMEM];
  const int tiles_x = (W + TL::TW - 1) / TL::TW;
  const int y0 = (blockIdx.x / tiles_x) * TL::TH;
  const int x0 = (blockIdx.x % tiles_x) * TL::TW;
  const int oc0 = blockIdx.y * TL::OCB;
  const int b = blockIdx.z;
  const int64_t plane = (int64_t)b * H * W;

  float acc[TL::PM][TL::OM] = {};
  conv3x3_tile<TL, T>(rh + plane * C, C, H, W, C, wc, C, y0, x0, oc0, in_s,
                      w_s, acc);

  const int og = threadIdx.x % TL::OG;
  const int pg = threadIdx.x / TL::OG;
  const int y = y0 + pg / TL::XG;
  if (y >= H) return;
  const T* cxb = cx + (int64_t)b * cx_bstride;
#pragma unroll
  for (int p = 0; p < TL::PM; ++p) {
    const int x = x0 + (pg % TL::XG) * TL::PM + p;
    if (x >= W) continue;
    const int64_t q = (int64_t)y * W + x;
#pragma unroll
    for (int j = 0; j < TL::OM; ++j) {
      const int oc = oc0 + og * TL::OM + j;
      if (oc >= C) continue;
      const int64_t o = (plane + q) * C + oc;
      const float cand = tanhf(to_f(cxb[q * cx_pix + oc]) + acc[p][j]);
      const float zz = z[o];
      h_out[o] = from_f<T>((1.f - zz) * to_f(h_prev[o]) + zz * cand);
    }
  }
}

template <class TL>
dim3 grid_for(int B, int H, int W, int cout) {
  const int tiles = ((H + TL::TH - 1) / TL::TH) * ((W + TL::TW - 1) / TL::TW);
  return dim3(tiles, (cout + TL::OCB - 1) / TL::OCB, B);
}

template <class TL, typename T>
int gate_launch(const void* h, const void* gx, int64_t gx_bstride,
                int64_t gx_pix, const void* wg, void* rh, float* z, int B,
                int H, int W, int C, cudaStream_t stream) {
  gate_kernel<TL, T><<<grid_for<TL>(B, H, W, 2 * C), TL::THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(gx), gx_bstride, gx_pix,
      static_cast<const T*>(wg), static_cast<T*>(rh), z, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <class TL, typename T>
int cand_launch(const void* rh, const void* cx, int64_t cx_bstride,
                int64_t cx_pix, const void* wc, const float* z,
                const void* h_prev, void* h_out, int B, int H, int W, int C,
                cudaStream_t stream) {
  cand_kernel<TL, T><<<grid_for<TL>(B, H, W, C), TL::THREADS, 0, stream>>>(
      static_cast<const T*>(rh), static_cast<const T*>(cx), cx_bstride, cx_pix,
      static_cast<const T*>(wc), z, static_cast<const T*>(h_prev),
      static_cast<T*>(h_out), H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each function makes ONE launch on `stream` (a cudaStream_t) and returns
// cudaGetLastError() right after it (0 = launched).
extern "C" {

int convgru_gate_step(int dtype, int device, const void* h, const void* gx,
                      int64_t gx_bstride, int64_t gx_pix, const void* wg,
                      void* rh, float* z, int B, int H, int W, int C,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = H <= TileSmall::TH && W <= TileSmall::TW;
  if (dtype == 0)
    return small ? gate_launch<TileSmall, float>(h, gx, gx_bstride, gx_pix, wg, rh, z, B, H, W, C, s)
                 : gate_launch<TileWide, float>(h, gx, gx_bstride, gx_pix, wg, rh, z, B, H, W, C, s);
  if (dtype == 1)
    return small ? gate_launch<TileSmall, __nv_bfloat16>(h, gx, gx_bstride, gx_pix, wg, rh, z, B, H, W, C, s)
                 : gate_launch<TileWide, __nv_bfloat16>(h, gx, gx_bstride, gx_pix, wg, rh, z, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int convgru_cand_step(int dtype, int device, const void* rh, const void* cx,
                      int64_t cx_bstride, int64_t cx_pix, const void* wc,
                      const float* z, const void* h_prev, void* h_out, int B,
                      int H, int W, int C, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = H <= TileSmall::TH && W <= TileSmall::TW;
  if (dtype == 0)
    return small ? cand_launch<TileSmall, float>(rh, cx, cx_bstride, cx_pix, wc, z, h_prev, h_out, B, H, W, C, s)
                 : cand_launch<TileWide, float>(rh, cx, cx_bstride, cx_pix, wc, z, h_prev, h_out, B, H, W, C, s);
  if (dtype == 1)
    return small ? cand_launch<TileSmall, __nv_bfloat16>(rh, cx, cx_bstride, cx_pix, wc, z, h_prev, h_out, B, H, W, C, s)
                 : cand_launch<TileWide, __nv_bfloat16>(rh, cx, cx_bstride, cx_pix, wc, z, h_prev, h_out, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* convgru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
