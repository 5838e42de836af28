// Single ConvGRU step (K4) for Hopper (sm_90a).
//
// Replaces dvdgan_tpu/kernels/convgru_cell.py:_cell_pallas ->
// _gru_cell_kernel, whose body is kernel_gru_step, the step K1 runs T times:
//
//   gh = conv3x3(h, wg)                  f32 accumulate; gx added in f32
//   r, z = sigmoid(gx + gh)              f32
//   rh = r * h                           f32, rounded to the activation type
//   ch = conv3x3(rh, wc)                 f32 accumulate
//   h' = (1 - z) h + z tanh(cx + ch)     f32, rounded once
//
// One step, no (T, ...) buffers. Two forms, chosen by the wrapper from the
// plane's shape:
//   * planes up to 8 x 8 (cell_plane_kernel, ONE launch): a CTA owns one
//     batch element's whole plane with all C channels, as the TPU kernel's
//     block does. Phase A computes the reset half of the gate conv and
//     keeps r*h, rounded, in shared memory for all C channels; phase B, per
//     block of output channels, runs the update half of the gate conv (from
//     h) and the candidate conv (from the shared r*h plane, whose SAME
//     padding is the plane's own border) into two register accumulators and
//     blends. r*h and z never reach global memory. Both convs run on the
//     register-tile routine of conv3x3_tile.cuh (CUDA-core FMAs), so in
//     bf16 its sums are taken in another order than K1's tensor cores.
//   * larger planes: K1's gate launch then its candidate launch, made by
//     the wrapper through K1's library (convgru_seq.cu: tensor cores in
//     bf16), r*h and z through global scratch: a CTA cannot wait for its
//     neighbours' r*h. So there K4's step is K1's, bit for bit.
//
// What bounds it on the H100: operations, 9*C*3C MACs per pixel. The
// one-launch form has only B CTAs (one per batch element), so at the
// generator's batch sizes it leaves most SMs idle: it is bound by one SM's
// FMA rate, not the card's. Splitting the channels of a plane over a
// cluster of CTAs (r*h shared through distributed shared memory) is left
// for later work.
//
// Layouts as K1: h, h_out contiguous (B, H, W, C) and not aliased; gx/cx
// read at pixel stride `pix` and batch stride `bstride`.

#include "conv3x3_tile.cuh"

namespace {

using namespace convgru;

// Whole planes of up to 8 x 8 (256 threads: 16 pixel groups x 16 channel
// groups) and of up to 4 x 4 (256 threads: 4 pixel groups x 64 channel
// groups, so that no thread idles on a 16-pixel plane).
using PlaneWide = Tile<8, 8, 64, 16>;
using PlaneSmall = Tile<4, 4, 256, 4>;
static_assert(PlaneWide::THREADS == 256 && PlaneSmall::THREADS == 256, "map");

template <class TL, typename T>
size_t plane_smem_bytes(int H, int W, int C) {
  static_assert(((TL::IN_SMEM + TL::W_SMEM) * 4) % 16 == 0, "align");
  return (size_t)(TL::IN_SMEM + TL::W_SMEM) * sizeof(float) +
         (size_t)H * W * C * sizeof(T);
}

// grid: (B); H <= TL::TH, W <= TL::TW.
template <class TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
cell_plane_kernel(const T* __restrict__ h, const T* __restrict__ gx,
                  int64_t gx_bstride, int64_t gx_pix, const T* __restrict__ cx,
                  int64_t cx_bstride, int64_t cx_pix, const T* __restrict__ wg,
                  const T* __restrict__ wc, T* __restrict__ h_out, int H, int W,
                  int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* in_s = reinterpret_cast<float*>(smem);
  float* w_s = in_s + TL::IN_SMEM;
  T* rh_s = reinterpret_cast<T*>(w_s + TL::W_SMEM);   // (H, W, C)

  const int64_t plane = (int64_t)blockIdx.x * H * W;
  const T* hb = h + plane * C;
  const T* gxb = gx + (int64_t)blockIdx.x * gx_bstride;
  const T* cxb = cx + (int64_t)blockIdx.x * cx_bstride;

  // ---- phase A: r*h on the plane, all C channels ------------------------
  for (int oc0 = 0; oc0 < C; oc0 += TL::OCB) {
    float acc[TL::PM][TL::OM] = {};
    conv3x3_tile<TL, T>(hb, C, H, W, C, wg, 2 * C, 0, 0, oc0, in_s, w_s, acc);
    for_each_output<TL>(H, W, C, 0, 0, oc0, acc,
                        [&](int64_t q, int oc, float a) {
      const float r = 1.f / (1.f + expf(-(to_f(gxb[q * gx_pix + oc]) + a)));
      rh_s[q * C + oc] = from_f<T>(r * to_f(hb[q * C + oc]));
    });
  }
  __syncthreads();

  // ---- phase B: z and the candidate per output-channel block, blend -----
  const int og = threadIdx.x % TL::OG;
  const int pg = threadIdx.x / TL::OG;
  const int y = pg / TL::XG;
  const int xb = (pg % TL::XG) * TL::PM;
  for (int oc0 = 0; oc0 < C; oc0 += TL::OCB) {
    float acc_z[TL::PM][TL::OM] = {};
    float acc_c[TL::PM][TL::OM] = {};
    conv3x3_tile<TL, T>(hb, C, H, W, C, wg, 2 * C, 0, 0, C + oc0, in_s, w_s,
                        acc_z);
    conv3x3_tile<TL, T>(rh_s, C, H, W, C, wc, C, 0, 0, oc0, in_s, w_s, acc_c);
    if (y >= H) continue;
#pragma unroll
    for (int p = 0; p < TL::PM; ++p) {
      const int x = xb + p;
      if (x >= W) continue;
      const int64_t q = (int64_t)y * W + x;
#pragma unroll
      for (int j = 0; j < TL::OM; ++j) {
        const int oc = oc0 + og * TL::OM + j;
        if (oc >= C) continue;
        const float z = 1.f / (1.f + expf(-(to_f(gxb[q * gx_pix + C + oc]) +
                                             acc_z[p][j])));
        const float cand = tanhf(to_f(cxb[q * cx_pix + oc]) + acc_c[p][j]);
        h_out[(plane + q) * C + oc] =
            from_f<T>(blend(z, to_f(hb[q * C + oc]), cand));
      }
    }
  }
}

template <class TL, typename T>
int plane_launch(const void* h, const void* gx, int64_t gx_bstride,
                 int64_t gx_pix, const void* cx, int64_t cx_bstride,
                 int64_t cx_pix, const void* wg, const void* wc, void* h_out,
                 int B, int H, int W, int C, cudaStream_t stream) {
  if (H > TL::TH || W > TL::TW) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = plane_smem_bytes<TL, T>(H, W, C);
  auto kernel = cell_plane_kernel<TL, T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, TL::THREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(gx), gx_bstride, gx_pix,
      static_cast<const T*>(cx), cx_bstride, cx_pix, static_cast<const T*>(wg),
      static_cast<const T*>(wc), static_cast<T*>(h_out), H, W, C);
  return static_cast<int>(cudaGetLastError());
}

bool plane_is_small(int H, int W) {
  return H <= PlaneSmall::TH && W <= PlaneSmall::TW;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each launching function makes ONE launch on `stream` (a cudaStream_t) and
// returns the CUDA error code of the launch (0 = launched).
extern "C" {

// The one-launch form: h_out = GRU step of h, for planes up to 8 x 8.
int convgru_cell_plane_step(int dtype, int device, const void* h,
                            const void* gx, int64_t gx_bstride, int64_t gx_pix,
                            const void* cx, int64_t cx_bstride, int64_t cx_pix,
                            const void* wg, const void* wc, void* h_out, int B,
                            int H, int W, int C, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = plane_is_small(H, W);
  if (dtype == 0)
    return small ? plane_launch<PlaneSmall, float>(
                       h, gx, gx_bstride, gx_pix, cx, cx_bstride, cx_pix, wg,
                       wc, h_out, B, H, W, C, s)
                 : plane_launch<PlaneWide, float>(
                       h, gx, gx_bstride, gx_pix, cx, cx_bstride, cx_pix, wg,
                       wc, h_out, B, H, W, C, s);
  if (dtype == 1)
    return small ? plane_launch<PlaneSmall, __nv_bfloat16>(
                       h, gx, gx_bstride, gx_pix, cx, cx_bstride, cx_pix, wg,
                       wc, h_out, B, H, W, C, s)
                 : plane_launch<PlaneWide, __nv_bfloat16>(
                       h, gx, gx_bstride, gx_pix, cx, cx_bstride, cx_pix, wg,
                       wc, h_out, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a CTA of the one-launch form needs, in bytes (the
// wrapper takes the two-launch form where this exceeds the card's 227 KB).
int64_t convgru_cell_plane_smem_bytes(int dtype, int H, int W, int C) {
  const bool small = plane_is_small(H, W);
  if (dtype == 0)
    return static_cast<int64_t>(
        small ? plane_smem_bytes<PlaneSmall, float>(H, W, C)
              : plane_smem_bytes<PlaneWide, float>(H, W, C));
  return static_cast<int64_t>(
      small ? plane_smem_bytes<PlaneSmall, __nv_bfloat16>(H, W, C)
            : plane_smem_bytes<PlaneWide, __nv_bfloat16>(H, W, C));
}

const char* convgru_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
