// Reverse-time BPTT of the whole-sequence ConvGRU (K2) for Hopper (sm_90a).
//
// Replaces dvdgan_tpu/kernels/convgru_bwd.py:gru_sequence_bwd ->
// _gru_bwd_kernel. Per reversed step t, from h = h_{t-1} (h0 at t = 0), the
// upstream gradient g_t of hs[t] and the dh carry from step t+1:
//
//   recompute  gh = conv3x3(h, wg); r, z = sigmoid(gx + gh)       f32
//              rh = r*h (rounded); cand = tanh(cx + conv3x3(rh, wc))
//   backward   gt   = g_t + carry                                 f32
//              da_c = gt*z*(1 - cand^2)              -> dcx[t] (rounded)
//              da_z = gt*(cand - h)*z*(1 - z)        -> dgx[t][C:2C]
//              drh  = conv3x3(da_c, flip_t(wc))                   f32
//              da_r = drh*h*r*(1 - r)                -> dgx[t][:C]
//              dh   = gt*(1 - z) + drh*r + conv3x3(dgx[t], flip_t(wg))
//              carry = dh (rounded; after t = 0 it is dh0)
//
// The rounding points are the TPU kernel's: rh, da_c, da_rz and the dh
// carry are rounded to the activation type each step; everything between
// them is f32. flip_t(w) (spatially flipped, in/out swapped; the wrapper
// forms it once per call) turns each transposed conv into a plain SAME 3x3
// conv. The weight gradients are conv weight-grads over the folded T*B
// batch, outside this kernel, as in the reference.
//
// Design: the TPU kernel keeps one whole plane per batch block in VMEM and
// walks T in one grid (<= 16 CTAs on 132 SMs). Here each step is four
// launches on the caller's stream, driven by a host loop over reversed T,
// because each 3x3 conv needs the whole plane its input was written to in
// the same step (a halo):
//   1. gate:  K1's gate launch (conv3x3_tile.cuh), which also writes r;
//             writes r, z (f32 scratch) and rh[t];
//   2. cand:  conv3x3(rh[t], wc) -> cand; writes dcx[t], the da_z half of
//             dgx[t] and the partial dh = gt*(1-z) (f32 scratch);
//   3. drh:   conv3x3(dcx[t], flip_t(wc)) -> drh; writes the da_r half of
//             dgx[t] and adds drh*r to the partial dh;
//   4. dh:    conv3x3(dgx[t], flip_t(wg)) over 2C input channels; writes
//             the rounded carry.
// Every launch uses K1's CTA tiles and CUDA-core FMAs. What bounds it is
// what bounds K1 (staging latency at the 4x4 and 8x8 levels, FMA rate at
// 32x32), with twice K1's conv work per step: 9*C*(2C + C + C + 2C) MACs
// per pixel. The carry, the f32 scratch planes and the weights stay in
// the 50 MB L2 between launches.
//
// Layouts: h0, hs, g, rh, dcx, dgx, the carry and the scratch planes are
// contiguous (B, H, W, Ch) per step; gx/cx are read at pixel stride `pix`
// and batch stride `bstride` (channel slices, or a stride-0-in-T
// broadcast), as in K1.

#include "conv3x3_tile.cuh"

namespace {

using namespace convgru;

// grid: grid_for<TL>(B, H, W, C)
template <class TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
cand_bwd_kernel(const T* __restrict__ rh, const T* __restrict__ cx,
                int64_t cx_bstride, int64_t cx_pix, const T* __restrict__ wc,
                const float* __restrict__ z, const T* __restrict__ h_prev,
                const T* __restrict__ g, const T* __restrict__ carry,
                T* __restrict__ dcx, T* __restrict__ dgx,
                float* __restrict__ dh, int H, int W, int C) {
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
    const float zz = z[o];
    const float hh = to_f(h_prev[o]);
    const float gt = to_f(g[o]) + to_f(carry[o]);
    dcx[o] = from_f<T>(gt * zz * (1.f - cand * cand));
    dgx[(at.plane + q) * 2 * C + C + oc] =
        from_f<T>(gt * (cand - hh) * zz * (1.f - zz));
    dh[o] = gt * (1.f - zz);
  });
}

// grid: grid_for<TL>(B, H, W, C)
template <class TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
drh_kernel(const T* __restrict__ dcx, const T* __restrict__ wct,
           const float* __restrict__ r, const T* __restrict__ h_prev,
           float* __restrict__ dh, T* __restrict__ dgx, int H, int W, int C) {
  __shared__ __align__(16) float in_s[TL::IN_SMEM];
  __shared__ __align__(16) float w_s[TL::W_SMEM];
  const TilePos<TL> at(H, W);

  float acc[TL::PM][TL::OM] = {};
  conv3x3_tile<TL, T>(dcx + at.plane * C, C, H, W, C, wct, C, at.y0, at.x0,
                      at.oc0, in_s, w_s, acc);

  for_each_output<TL>(H, W, C, at.y0, at.x0, at.oc0, acc,
                      [&](int64_t q, int oc, float drh) {
    const int64_t o = (at.plane + q) * C + oc;
    const float rr = r[o];
    dh[o] = dh[o] + drh * rr;
    dgx[(at.plane + q) * 2 * C + oc] =
        from_f<T>(drh * to_f(h_prev[o]) * rr * (1.f - rr));
  });
}

// grid: grid_for<TL>(B, H, W, C)
template <class TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
dh_kernel(const T* __restrict__ dgx, const T* __restrict__ wgt,
          const float* __restrict__ dh, T* __restrict__ carry, int H, int W,
          int C) {
  __shared__ __align__(16) float in_s[TL::IN_SMEM];
  __shared__ __align__(16) float w_s[TL::W_SMEM];
  const TilePos<TL> at(H, W);

  float acc[TL::PM][TL::OM] = {};
  conv3x3_tile<TL, T>(dgx + at.plane * 2 * C, 2 * C, H, W, 2 * C, wgt, C,
                      at.y0, at.x0, at.oc0, in_s, w_s, acc);

  for_each_output<TL>(H, W, C, at.y0, at.x0, at.oc0, acc,
                      [&](int64_t q, int oc, float a) {
    const int64_t o = (at.plane + q) * C + oc;
    carry[o] = from_f<T>(dh[o] + a);
  });
}

template <class TL, typename T>
int cand_bwd_launch(const void* rh, const void* cx, int64_t cx_bstride,
                    int64_t cx_pix, const void* wc, const float* z,
                    const void* h_prev, const void* g, const void* carry,
                    void* dcx, void* dgx, float* dh, int B, int H, int W,
                    int C, cudaStream_t stream) {
  cand_bwd_kernel<TL, T><<<grid_for<TL>(B, H, W, C), TL::THREADS, 0,
                           stream>>>(
      static_cast<const T*>(rh), static_cast<const T*>(cx), cx_bstride, cx_pix,
      static_cast<const T*>(wc), z, static_cast<const T*>(h_prev),
      static_cast<const T*>(g), static_cast<const T*>(carry),
      static_cast<T*>(dcx), static_cast<T*>(dgx), dh, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <class TL, typename T>
int drh_launch(const void* dcx, const void* wct, const float* r,
               const void* h_prev, float* dh, void* dgx, int B, int H, int W,
               int C, cudaStream_t stream) {
  drh_kernel<TL, T><<<grid_for<TL>(B, H, W, C), TL::THREADS, 0, stream>>>(
      static_cast<const T*>(dcx), static_cast<const T*>(wct), r,
      static_cast<const T*>(h_prev), dh, static_cast<T*>(dgx), H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <class TL, typename T>
int dh_launch(const void* dgx, const void* wgt, const float* dh, void* carry,
              int B, int H, int W, int C, cudaStream_t stream) {
  dh_kernel<TL, T><<<grid_for<TL>(B, H, W, C), TL::THREADS, 0, stream>>>(
      static_cast<const T*>(dgx), static_cast<const T*>(wgt), dh,
      static_cast<T*>(carry), H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each function makes ONE launch on `stream` (a cudaStream_t) and returns
// cudaGetLastError() right after it (0 = launched). Pointers other than
// gx/cx address step t's contiguous (B, H, W, Ch) planes.
extern "C" {

int convgru_bwd_gate_step(int dtype, int device, const void* h_prev,
                          const void* gx, int64_t gx_bstride, int64_t gx_pix,
                          const void* wg, void* rh, float* r, float* z, int B,
                          int H, int W, int C, void* stream) {
  CONVGRU_DISPATCH(dtype, device, H, W, convgru::gate_launch, h_prev, gx,
                   gx_bstride, gx_pix, wg, rh, z, r, B, H, W, C,
                   static_cast<cudaStream_t>(stream));
}

int convgru_bwd_cand_step(int dtype, int device, const void* rh,
                          const void* cx, int64_t cx_bstride, int64_t cx_pix,
                          const void* wc, const float* z, const void* h_prev,
                          const void* g, const void* carry, void* dcx,
                          void* dgx, float* dh, int B, int H, int W, int C,
                          void* stream) {
  CONVGRU_DISPATCH(dtype, device, H, W, cand_bwd_launch, rh, cx, cx_bstride,
                   cx_pix, wc, z, h_prev, g, carry, dcx, dgx, dh, B, H, W, C,
                   static_cast<cudaStream_t>(stream));
}

int convgru_bwd_drh_step(int dtype, int device, const void* dcx,
                         const void* wct, const float* r, const void* h_prev,
                         float* dh, void* dgx, int B, int H, int W, int C,
                         void* stream) {
  CONVGRU_DISPATCH(dtype, device, H, W, drh_launch, dcx, wct, r, h_prev, dh,
                   dgx, B, H, W, C, static_cast<cudaStream_t>(stream));
}

int convgru_bwd_dh_step(int dtype, int device, const void* dgx,
                        const void* wgt, const float* dh, void* carry, int B,
                        int H, int W, int C, void* stream) {
  CONVGRU_DISPATCH(dtype, device, H, W, dh_launch, dgx, wgt, dh, carry, B, H,
                   W, C, static_cast<cudaStream_t>(stream));
}

const char* convgru_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
