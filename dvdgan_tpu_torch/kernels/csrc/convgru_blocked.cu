// Spatially blocked whole-sequence ConvGRU forward (K3) for Hopper (sm_90a).
//
// Replaces dvdgan_tpu/kernels/convgru_blocked.py:_blocked_pallas, the
// forward for the large planes of the generator (64x64x128 and 128x128x64
// at 256 px; ops/convgru.py draws the line between K1 and K3). It computes
// K1's function with K1's rounding points (convgru_seq.cu):
//
//   gh = conv3x3(h, wg)                  f32 accumulate; gx added in f32
//   r, z = sigmoid(gx + gh)              f32
//   rh = r * h                           f32, rounded to the activation type
//   ch = conv3x3(rh, wc)                 f32 accumulate
//   h' = (1 - z) h + z tanh(cx + ch)     f32, rounded once
//
// Design: ONE launch per time step, driven by a host loop over T on the
// caller's stream. The TPU kernel sweeps the plane twice per step (a gate
// phase that writes r*h and z planes, then a candidate phase that reads
// r*h with halos), because a block's candidate conv needs its neighbours'
// r*h and a sequential grid can wait for them. CUDA blocks cannot wait for
// each other, so here a CTA owns one batch element x one TH x TW spatial
// tile and ALL C channels of it, and computes what it needs of its
// neighbours itself:
//   phase A: r on the tile plus a one-pixel rim (the gate conv's reset half,
//            read from h with a two-pixel halo), and r*h, rounded, into
//            shared memory for all C channels (zero outside the plane: the
//            candidate conv's SAME padding);
//   phase B: per block of output channels, the update half of the gate conv
//            (from h) and the candidate conv (from the r*h tile in shared
//            memory) into two register accumulators, then the blend, and
//            h' is written. r*h and z never reach global memory.
// Both 3x3 convs run in this kernel's body on the register-tile routine
// shared with K1 and K2 (conv3x3_tile.cuh, CUDA-core FMAs). Phase A maps
// 240 of the CTA's 256 threads onto a (TH+2) x (TW+4) region (the rim, its
// width rounded up to the threads' 4-pixel groups).
//
// What bounds it on the H100: operations. Per pixel and step the convs do
// 9*C*3C MACs (9*C*C more on the rim: (10*12)/(8*8) - 1 = 88% of the reset
// half, 29% of the whole, at the 8 x 8 tile), against 3C + C + C elements
// read and C written. A CTA must hold r*h for all C channels, so it cannot
// split the output channels as K1's CTAs do: a launch has
// B * ceil(H/8) * ceil(W/8) CTAs (32 at 32x32, B = 2), which is why this
// form is for planes of 64x64 and up. h_{t-1} and the weights are re-read
// from L2 by each output-channel pass. The register budget is capped at
// 128 a thread (a few spills) so that two CTAs share an SM. Larger tiles
// for the 128x128 plane, wgmma, TMA and CUDA-graph capture of the step loop
// are left for later work.
//
// Layouts: h_prev and h_out planes are contiguous (B, H, W, C) and must not
// alias (neighbouring CTAs read h_prev's halo); gx/cx are read at pixel
// stride `pix` and batch stride `bstride` (the hoisted input conv's channel
// slices), as in K1.

#include "conv3x3_tile.cuh"

namespace {

using namespace convgru;

constexpr int NT = 256;                 // threads per CTA
constexpr int TH = 8, TW = 8;           // output tile
constexpr int RH = TH + 2, RW = TW + 2; // the r*h tile in shared memory
using TileOut = Tile<TH, TW, 64, 16>;         // phase B: 16 px groups x 16
using TileRim = Tile<TH + 2, TW + 4, 32, 16>; // phase A: 30 px groups x 8
static_assert(TileOut::THREADS == NT && TileRim::THREADS <= NT, "mapping");

constexpr int IN_S = TileRim::IN_SMEM > TileOut::IN_SMEM ? TileRim::IN_SMEM
                                                         : TileOut::IN_SMEM;
constexpr int W_S = TileRim::W_SMEM > TileOut::W_SMEM ? TileRim::W_SMEM
                                                      : TileOut::W_SMEM;
static_assert((IN_S * 4) % 16 == 0 && ((IN_S + W_S) * 4) % 16 == 0, "align");

template <typename T>
size_t smem_bytes(int C) {
  return (size_t)(IN_S + W_S) * sizeof(float) + (size_t)RH * RW * C * sizeof(T);
}

// grid: (tiles_y * tiles_x, B); two CTAs per SM.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
blocked_step_kernel(const T* __restrict__ h_prev, const T* __restrict__ gx,
                    int64_t gx_bstride, int64_t gx_pix,
                    const T* __restrict__ cx, int64_t cx_bstride,
                    int64_t cx_pix, const T* __restrict__ wg,
                    const T* __restrict__ wc, T* __restrict__ h_out, int H,
                    int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* in_s = reinterpret_cast<float*>(smem);
  float* w_s = in_s + IN_S;
  T* rh_s = reinterpret_cast<T*>(w_s + W_S);   // (RH, RW, C)

  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int64_t plane = (int64_t)blockIdx.y * H * W;
  const T* hb = h_prev + plane * C;
  const T* gxb = gx + (int64_t)blockIdx.y * gx_bstride;
  const T* cxb = cx + (int64_t)blockIdx.y * cx_bstride;
  const int tid = threadIdx.x;

  // ---- phase A: r*h on the tile and its rim, all C channels -------------
  {
    const int og = tid % TileRim::OG;
    const int pg = tid / TileRim::OG;
    const int ry = pg / TileRim::XG;
    const int rx0 = (pg % TileRim::XG) * TileRim::PM;
    const int y = y0 - 1 + ry;
    for (int oc0 = 0; oc0 < C; oc0 += TileRim::OCB) {
      float acc[TileRim::PM][TileRim::OM] = {};
      conv3x3_tile<TileRim, T, NT>(hb, C, H, W, C, wg, 2 * C, y0 - 1, x0 - 1,
                                   oc0, in_s, w_s, acc);
      if (tid >= TileRim::THREADS) continue;
#pragma unroll
      for (int p = 0; p < TileRim::PM; ++p) {
        const int rx = rx0 + p;
        if (rx >= RW) continue;
        const int x = x0 - 1 + rx;
        const bool inside = y >= 0 && y < H && x >= 0 && x < W;
        const int64_t q = (int64_t)y * W + x;
#pragma unroll
        for (int j = 0; j < TileRim::OM; ++j) {
          const int oc = oc0 + og * TileRim::OM + j;
          if (oc >= C) continue;
          float v = 0.f;
          if (inside) {
            const float r =
                1.f / (1.f + expf(-(to_f(gxb[q * gx_pix + oc]) + acc[p][j])));
            v = r * to_f(hb[q * C + oc]);
          }
          rh_s[(int64_t)(ry * RW + rx) * C + oc] = from_f<T>(v);
        }
      }
    }
  }
  __syncthreads();

  // ---- phase B: z and the candidate per output-channel block, blend -----
  {
    const int og = tid % TileOut::OG;
    const int pg = tid / TileOut::OG;
    const int y = y0 + pg / TileOut::XG;
    const int xb = x0 + (pg % TileOut::XG) * TileOut::PM;
    for (int oc0 = 0; oc0 < C; oc0 += TileOut::OCB) {
      float acc_z[TileOut::PM][TileOut::OM] = {};
      float acc_c[TileOut::PM][TileOut::OM] = {};
      conv3x3_tile<TileOut, T, NT>(hb, C, H, W, C, wg, 2 * C, y0, x0, C + oc0,
                                   in_s, w_s, acc_z);
      // the r*h tile as a (RH, RW) plane whose pixel (1, 1) is (y0, x0)
      conv3x3_tile<TileOut, T, NT>(rh_s, C, RH, RW, C, wc, C, 1, 1, oc0, in_s,
                                   w_s, acc_c);
      if (y >= H) continue;
#pragma unroll
      for (int p = 0; p < TileOut::PM; ++p) {
        const int x = xb + p;
        if (x >= W) continue;
        const int64_t q = (int64_t)y * W + x;
#pragma unroll
        for (int j = 0; j < TileOut::OM; ++j) {
          const int oc = oc0 + og * TileOut::OM + j;
          if (oc >= C) continue;
          const float z = 1.f / (1.f + expf(-(to_f(gxb[q * gx_pix + C + oc]) +
                                               acc_z[p][j])));
          const float cand = tanhf(to_f(cxb[q * cx_pix + oc]) + acc_c[p][j]);
          const int64_t o = (plane + q) * C + oc;
          h_out[o] = from_f<T>(blend(z, to_f(hb[q * C + oc]), cand));
        }
      }
    }
  }
}

template <typename T>
int blocked_launch(const void* h_prev, const void* gx, int64_t gx_bstride,
                   int64_t gx_pix, const void* cx, int64_t cx_bstride,
                   int64_t cx_pix, const void* wg, const void* wc, void* h_out,
                   int B, int H, int W, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(C);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), B);
  auto kernel = blocked_step_kernel<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(h_prev), static_cast<const T*>(gx), gx_bstride,
      gx_pix, static_cast<const T*>(cx), cx_bstride, cx_pix,
      static_cast<const T*>(wg), static_cast<const T*>(wc),
      static_cast<T*>(h_out), H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
extern "C" {

// ONE launch on `stream` (a cudaStream_t): h_out = GRU step of h_prev.
// Returns the CUDA error code of the launch (0 = launched).
int convgru_blocked_step(int dtype, int device, const void* h_prev,
                         const void* gx, int64_t gx_bstride, int64_t gx_pix,
                         const void* cx, int64_t cx_bstride, int64_t cx_pix,
                         const void* wg, const void* wc, void* h_out, int B,
                         int H, int W, int C, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return blocked_launch<float>(h_prev, gx, gx_bstride, gx_pix, cx,
                                 cx_bstride, cx_pix, wg, wc, h_out, B, H, W, C,
                                 s);
  if (dtype == 1)
    return blocked_launch<__nv_bfloat16>(h_prev, gx, gx_bstride, gx_pix, cx,
                                         cx_bstride, cx_pix, wg, wc, h_out, B,
                                         H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory one CTA needs at C channels, in bytes (the wrapper
// refuses what exceeds the card's 227 KB before it launches).
int64_t convgru_blocked_smem_bytes(int dtype, int C) {
  return static_cast<int64_t>(dtype == 0 ? smem_bytes<float>(C)
                                         : smem_bytes<__nv_bfloat16>(C));
}

const char* convgru_blocked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
