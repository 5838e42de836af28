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
// Each step is four launches on the caller's stream, driven by a host loop
// over reversed T, because each 3x3 conv needs the whole plane its input
// was written to in the same step (a halo):
//   1. gate:  K1's gate launch, which also writes r; writes r, z (f32
//             scratch) and rh[t];
//   2. cand:  conv3x3(rh[t], wc) -> cand; writes dcx[t], the da_z half of
//             dgx[t] and the partial dh = gt*(1-z) (f32 scratch);
//   3. drh:   conv3x3(dcx[t], flip_t(wc)) -> drh; writes the da_r half of
//             dgx[t] and adds drh*r to the partial dh;
//   4. dh:    conv3x3(dgx[t], flip_t(wg)) over 2C input channels; writes
//             the rounded carry.
//
// bf16: every launch is the implicit GEMM on the tensor cores of
// conv3x3_mma.cuh (M = the step's B*H*W pixels; N = 2C for the gate, C for
// the others; K = 9C, 9*2C for dh), its step of the math above as the
// epilogue. What bounds it on the H100 is what bounds K1 (convgru_seq.cu),
// with twice K1's conv work per step, 9*C*(2C + C + C + 2C) MACs per pixel:
// operations at 16x16 and up; at the 4x4 and 8x8 planes reading the
// weights (flip_t(wg) is 4.7 MB at C 512) and the latency of four dependent
// launches a step, where the plan cuts each contraction into slices so
// that a launch has at least 132 CTAs and reads each weight once, the last
// CTA of a tile adding the slices' f32 partial sums in order (two runs give
// the same bits). The carry, the f32 scratch planes and the weights stay
// in the 50 MB L2 between launches. f32 (the parity mode): the CUDA-core
// body of conv3x3_tile.cuh on K1's tiles.
//
// Layouts: h0, hs, g, rh, dcx, dgx, the carry and the scratch planes are
// contiguous (B, H, W, Ch) per step; gx/cx are read at pixel stride `pix`
// and batch stride `bstride` (channel slices, or a stride-0-in-T
// broadcast), as in K1. flip_t(w) is HWIO like w.

#include "conv3x3_mma.cuh"

namespace {

using namespace convgru;

// ---- f32: the CUDA-core launches (conv3x3_tile.cuh's body) ---------------

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

// ---- bf16: the epilogues of the tensor-core launches (conv3x3_mma.cuh) ---

using convgru_tc::bf16;

// 2. cand: a = conv3x3(rh, wc) at (q, n); writes dcx, da_z, partial dh.
struct CandBwdEpi {
  const bf16* cx;
  int64_t cx_bstride, cx_pix;
  const float* z;
  const bf16* h_prev;
  const bf16* g;
  const bf16* carry;
  bf16* dcx;
  bf16* dgx;
  float* dh;
  int C;
  struct In {
    float cx, z, h, gt;
  };
  __device__ __forceinline__ In load(int64_t q, int b, int64_t p,
                                     int n) const {
    const int64_t o = q * C + n;
    return {to_f(cx[b * cx_bstride + p * cx_pix + n]), z[o], to_f(h_prev[o]),
            to_f(g[o]) + to_f(carry[o])};
  }
  __device__ __forceinline__ void store(int64_t q, int n, const In& in,
                                        float a) const {
    const int64_t o = q * C + n;
    const float cand = tanhf(in.cx + a);
    dcx[o] = from_f<bf16>(in.gt * in.z * (1.f - cand * cand));
    dgx[q * 2 * C + C + n] =
        from_f<bf16>(in.gt * (cand - in.h) * in.z * (1.f - in.z));
    dh[o] = in.gt * (1.f - in.z);
  }
};

// 3. drh: a = conv3x3(dcx, flip_t(wc)); writes da_r, adds drh*r to dh.
struct DrhEpi {
  const float* r;
  const bf16* h_prev;
  float* dh;
  bf16* dgx;
  int C;
  struct In {
    float r, h, dh;
  };
  __device__ __forceinline__ In load(int64_t q, int, int64_t, int n) const {
    const int64_t o = q * C + n;
    return {r[o], to_f(h_prev[o]), dh[o]};
  }
  __device__ __forceinline__ void store(int64_t q, int n, const In& in,
                                        float drh) const {
    dh[q * C + n] = in.dh + drh * in.r;
    dgx[q * 2 * C + n] = from_f<bf16>(drh * in.h * in.r * (1.f - in.r));
  }
};

// 4. dh: a = conv3x3(dgx, flip_t(wg)); writes the rounded carry.
struct DhEpi {
  const float* dh;
  bf16* carry;
  int C;
  struct In {
    float dh;
  };
  __device__ __forceinline__ In load(int64_t q, int, int64_t, int n) const {
    return {dh[q * C + n]};
  }
  __device__ __forceinline__ void store(int64_t q, int n, const In& in,
                                        float a) const {
    carry[q * C + n] = from_f<bf16>(in.dh + a);
  }
};

template <typename T>
const T* cp(const void* p) {
  return static_cast<const T*>(p);
}
template <typename T>
T* mp(void* p) {
  return static_cast<T*>(p);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32 (CUDA-core
// body), 1 = bfloat16 (tensor cores, run as the plan (tile, slices) says;
// `work` and `counters` are the plan's split-K scratch, shared by the four
// launches, counters zero before the call's first launch, both unused with
// one slice). Each function makes ONE launch on `stream` (a cudaStream_t)
// and returns cudaGetLastError() right after it (0 = launched). Pointers
// other than gx/cx address step t's contiguous (B, H, W, Ch) planes.
extern "C" {

int convgru_bwd_gate_step(int dtype, int device, const void* h_prev,
                          const void* gx, int64_t gx_bstride, int64_t gx_pix,
                          const void* wg, void* rh, float* r, float* z, int B,
                          int H, int W, int C, int tile, int slices,
                          float* work, void* counters, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return convgru_tc::conv3x3_mma(
        tile, h_prev, wg, B, H, W, C, 2 * C, slices, work, counters,
        convgru_tc::GateEpi{cp<bf16>(h_prev), cp<bf16>(gx), gx_bstride,
                            gx_pix, mp<bf16>(rh), z, r, C},
        s);
  if (dtype == 0)
    return CONVGRU_F32(H, W, convgru::gate_launch, h_prev, gx, gx_bstride,
                       gx_pix, wg, rh, z, r, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int convgru_bwd_cand_step(int dtype, int device, const void* rh,
                          const void* cx, int64_t cx_bstride, int64_t cx_pix,
                          const void* wc, const float* z, const void* h_prev,
                          const void* g, const void* carry, void* dcx,
                          void* dgx, float* dh, int B, int H, int W, int C,
                          int tile, int slices, float* work, void* counters,
                          void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return convgru_tc::conv3x3_mma(
        tile, rh, wc, B, H, W, C, C, slices, work, counters,
        CandBwdEpi{cp<bf16>(cx), cx_bstride, cx_pix, z, cp<bf16>(h_prev),
                   cp<bf16>(g), cp<bf16>(carry), mp<bf16>(dcx), mp<bf16>(dgx),
                   dh, C},
        s);
  if (dtype == 0)
    return CONVGRU_F32(H, W, cand_bwd_launch, rh, cx, cx_bstride, cx_pix, wc,
                       z, h_prev, g, carry, dcx, dgx, dh, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int convgru_bwd_drh_step(int dtype, int device, const void* dcx,
                         const void* wct, const float* r, const void* h_prev,
                         float* dh, void* dgx, int B, int H, int W, int C,
                         int tile, int slices, float* work, void* counters,
                         void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return convgru_tc::conv3x3_mma(
        tile, dcx, wct, B, H, W, C, C, slices, work, counters,
        DrhEpi{r, cp<bf16>(h_prev), dh, mp<bf16>(dgx), C}, s);
  if (dtype == 0)
    return CONVGRU_F32(H, W, drh_launch, dcx, wct, r, h_prev, dh, dgx, B, H,
                       W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int convgru_bwd_dh_step(int dtype, int device, const void* dgx,
                        const void* wgt, const float* dh, void* carry, int B,
                        int H, int W, int C, int tile, int slices,
                        float* work, void* counters, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return convgru_tc::conv3x3_mma(tile, dgx, wgt, B, H, W, 2 * C, C, slices,
                                   work, counters,
                                   DhEpi{dh, mp<bf16>(carry), C}, s);
  if (dtype == 0)
    return CONVGRU_F32(H, W, dh_launch, dgx, wgt, dh, carry, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* convgru_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
