// Shared pieces of the ConvGRU kernels: f32/bf16 conversion, the blend,
// the CUDA-core CTA tile shapes, a SAME 3x3 conv over one CTA's tile
// accumulated in registers (f32 FMAs on staged f32 copies of the operands),
// and the gate and candidate launches built on it. K4's one-launch form
// (convgru_cell.cu) runs this body in both dtypes; K1 (convgru_seq.cu), K2
// (convgru_bwd.cu) and K3 (convgru_blocked.cu) run it only in f32, their
// parity mode: in bf16 they run tensor-core bodies (conv3x3_mma.cuh; K3's
// own fused step).
//
// Layouts (channels-last, as the reference): a plane is (H, W, Ch) with
// pixel stride `pix` (>= Ch) and unit channel stride; weights are HWIO
// (3, 3, Cin, Cout), contiguous.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace convgru {

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

// h' = (1 - z) h + z cand, each operation rounded where written (no
// contraction chosen per kernel by the compiler): every kernel that blends
// gives the same bits for the same z, h and cand.
__device__ __forceinline__ float blend(float z, float h, float cand) {
  return __fmaf_rn(z, cand, __fmul_rn(__fsub_rn(1.f, z), h));
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
  static_assert(THREADS <= 256, "at most 256 threads");
  static_assert((IN_SMEM + W_SMEM) * 4 <= 48 * 1024, "static smem limit");
};

using TileWide = Tile<8, 8, 64, 16>;    // planes of 8x8 and up: 256 threads
using TileSmall = Tile<4, 4, 64, 16>;   // 4x4 planes: 64 threads, so that
                                        // a batch of 8-16 still gives 64-128
                                        // gate CTAs

inline bool small_plane(int H, int W) {
  return H <= TileSmall::TH && W <= TileSmall::TW;
}

// acc[p][j] += sum_{dy,dx,ci} src[y0+py+dy-1, x0+px+p+dx-1, ci] *
//              w[dy, dx, ci, oc0+og*OM+j]   (zero outside the plane)
// src points at one batch element's plane; pixel (y, x) starts at
// src + (y*W + x)*pix. It may lie in shared memory (K3's r*h tile). NT is
// the CTA's thread count: all NT threads stage and meet the barriers, the
// first TL::THREADS of them accumulate.
template <class TL, typename T, int NT = TL::THREADS>
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
  static_assert(NT % 32 == 0 && TL::THREADS <= NT, "whole warps");
  constexpr int IN_ITERS = (TL::IN_SMEM + NT - 1) / NT;
  constexpr int W_ITERS = TL::W_SMEM / NT;
  constexpr int W_BATCH = W_ITERS % 12 == 0 ? 12 : 9;
  static_assert(TL::W_SMEM % NT == 0 && W_ITERS % W_BATCH == 0,
                "weight staging splits evenly into batches");

  for (int ci0 = 0; ci0 < Cin; ci0 += TL::CIC) {
    __syncthreads();  // the previous chunk has been consumed
    T xr[IN_ITERS];
    bool xok[IN_ITERS];
#pragma unroll
    for (int k = 0; k < IN_ITERS; ++k) {
      const int i = tid + k * NT;
      const int hp = i / TL::CIC;
      const int y = y0 - 1 + hp / TL::HW, x = x0 - 1 + hp % TL::HW;
      const int ci = ci0 + i % TL::CIC;
      xok[k] = i < TL::IN_SMEM && y >= 0 && y < H && x >= 0 && x < W && ci < Cin;
      if (xok[k]) xr[k] = src[(int64_t)(y * W + x) * pix + ci];
    }
#pragma unroll
    for (int k = 0; k < IN_ITERS; ++k) {
      const int i = tid + k * NT;
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
        const int i = tid + (k0 + k) * NT;
        const int r = i / TL::OCB;
        const int ci = ci0 + r % TL::CIC, tap = r / TL::CIC;
        const int oc = oc0 + i % TL::OCB;
        wok[k] = ci < Cin && oc < Cout;
        if (wok[k]) wr[k] = w[((int64_t)tap * Cin + ci) * Cout + oc];
      }
#pragma unroll
      for (int k = 0; k < W_BATCH; ++k)  // layout [tap][cil][ocl]
        w_s[tid + (k0 + k) * NT] = wok[k] ? to_f(wr[k]) : 0.f;
    }
    __syncthreads();

    if (NT > TL::THREADS && tid >= TL::THREADS) continue;
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

// Where a thread's accumulators land: call f(q, oc, acc) for each of its
// PM x OM outputs that lies inside the plane and below Cout (q = y*W + x).
template <class TL, class F>
__device__ __forceinline__ void for_each_output(
    int H, int W, int Cout, int y0, int x0, int oc0,
    const float (&acc)[TL::PM][TL::OM], F f) {
  const int og = threadIdx.x % TL::OG;
  const int pg = threadIdx.x / TL::OG;
  const int y = y0 + pg / TL::XG;
  if (y >= H) return;
#pragma unroll
  for (int p = 0; p < TL::PM; ++p) {
    const int x = x0 + (pg % TL::XG) * TL::PM + p;
    if (x >= W) continue;
#pragma unroll
    for (int j = 0; j < TL::OM; ++j) {
      const int oc = oc0 + og * TL::OM + j;
      if (oc < Cout) f((int64_t)y * W + x, oc, acc[p][j]);
    }
  }
}

// The CTA's place: blockIdx = (spatial tile, output-channel block, batch).
template <class TL>
struct TilePos {
  int y0, x0, oc0, b;
  int64_t plane;  // b * H * W
  __device__ TilePos(int H, int W) {
    const int tiles_x = (W + TL::TW - 1) / TL::TW;
    y0 = (blockIdx.x / tiles_x) * TL::TH;
    x0 = (blockIdx.x % tiles_x) * TL::TW;
    oc0 = blockIdx.y * TL::OCB;
    b = blockIdx.z;
    plane = (int64_t)b * H * W;
  }
};

template <class TL>
dim3 grid_for(int B, int H, int W, int cout) {
  const int tiles = ((H + TL::TH - 1) / TL::TH) * ((W + TL::TW - 1) / TL::TW);
  return dim3(tiles, (cout + TL::OCB - 1) / TL::OCB, B);
}

// Gate step: gh = conv3x3(h, wg) (f32 accumulate), r, z = sigmoid(gx + gh)
// in f32; writes rh = r*h (f32 product rounded to T), z (f32) and, when
// `r` is not null, r (f32: the backward's recompute needs it).
// grid: grid_for<TL>(B, H, W, 2C)
template <class TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
gate_kernel(const T* __restrict__ h, const T* __restrict__ gx,
            int64_t gx_bstride, int64_t gx_pix, const T* __restrict__ wg,
            T* __restrict__ rh, float* __restrict__ z, float* __restrict__ r,
            int H, int W, int C) {
  __shared__ __align__(16) float in_s[TL::IN_SMEM];
  __shared__ __align__(16) float w_s[TL::W_SMEM];
  const TilePos<TL> at(H, W);
  const T* hb = h + at.plane * C;

  float acc[TL::PM][TL::OM] = {};
  conv3x3_tile<TL, T>(hb, C, H, W, C, wg, 2 * C, at.y0, at.x0, at.oc0, in_s,
                      w_s, acc);

  const T* gxb = gx + (int64_t)at.b * gx_bstride;
  for_each_output<TL>(H, W, 2 * C, at.y0, at.x0, at.oc0, acc,
                      [&](int64_t q, int oc, float a) {
    const float s = 1.f / (1.f + expf(-(to_f(gxb[q * gx_pix + oc]) + a)));
    if (oc < C) {
      const int64_t o = (at.plane + q) * C + oc;
      rh[o] = from_f<T>(s * to_f(hb[q * C + oc]));
      if (r != nullptr) r[o] = s;
    } else {
      z[(at.plane + q) * C + (oc - C)] = s;
    }
  });
}

template <class TL, typename T>
int gate_launch(const void* h, const void* gx, int64_t gx_bstride,
                int64_t gx_pix, const void* wg, void* rh, float* z, float* r,
                int B, int H, int W, int C, cudaStream_t stream) {
  gate_kernel<TL, T><<<grid_for<TL>(B, H, W, 2 * C), TL::THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(gx), gx_bstride, gx_pix,
      static_cast<const T*>(wg), static_cast<T*>(rh), z, r, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// Candidate step: ch = conv3x3(rh, wc) (f32 accumulate), cand = tanh(cx +
// ch), h' = (1 - z) h + z cand in f32, rounded once to T.
// grid: grid_for<TL>(B, H, W, C)
template <class TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
cand_kernel(const T* __restrict__ rh, const T* __restrict__ cx,
            int64_t cx_bstride, int64_t cx_pix, const T* __restrict__ wc,
            const float* __restrict__ z, const T* __restrict__ h_prev,
            T* __restrict__ h_out, int H, int W, int C) {
  __shared__ __align__(16) float in_s[TL::IN_SMEM];
  __shared__ __align__(16) float w_s[TL::W_SMEM];
  const TilePos<TL> at(H, W);

  float acc[TL::PM][TL::OM] = {};
  conv3x3_tile<TL, T>(rh + at.plane * C, C, H, W, C, wc, C, at.y0, at.x0,
                      at.oc0, in_s, w_s, acc);

  const T* cxb = cx + (int64_t)at.b * cx_bstride;
  for_each_output<TL>(H, W, C, at.y0, at.x0, at.oc0, acc,
                      [&](int64_t q, int oc, float a) {
    const int64_t o = (at.plane + q) * C + oc;
    const float cand = tanhf(to_f(cxb[q * cx_pix + oc]) + a);
    h_out[o] = from_f<T>(blend(z[o], to_f(h_prev[o]), cand));
  });
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

}  // namespace convgru

// LAUNCH<TL, float>(args...) for the CUDA-core tile that fits the H x W
// plane: the CUDA error code of the launch (0 = launched).
#define CONVGRU_F32(H, W, LAUNCH, ...)                                        \
  (convgru::small_plane(H, W) ? LAUNCH<convgru::TileSmall, float>(__VA_ARGS__) \
                              : LAUNCH<convgru::TileWide, float>(__VA_ARGS__))
