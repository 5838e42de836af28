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
// cuDNN or cuBLAS). Two launches per time step, driven by a host loop over
// T on the caller's stream (each conv needs the whole plane its input was
// written to in the same step):
//   * gate launch:      reads h_{t-1} and gx[t]; writes z (f32 scratch) and
//                       r*h (activation-type scratch).
//   * candidate launch: reads r*h with a zero SAME halo, cx[t], z, h_{t-1};
//                       writes hs[t].
//
// bf16: each launch is an implicit GEMM on the tensor cores
// (conv3x3_mma.cuh): M = the step's B*H*W pixels, N = 2C (gate) or C, K =
// 9C; bf16 operands staged by cp.async, f32 sums on mma.sync, the gate or
// candidate math as the epilogue. What bounds it on the H100: at the 16x16
// to 32x32 planes, operations (9*C*3C MACs per pixel and step); at the 4x4
// and 8x8 planes (32-256 pixels a step at C 256-512), reading the weights
// (wg is 4.7 MB at C 512) and the latency of two dependent launches per
// step. There a launch gets at least 132 CTAs by cutting the contraction
// into slices (each weight read once, partial sums added in slice order by
// the last CTA of a tile: the plan, kernels/convgru_seq.py:plan); the
// weights and the recurrent state stay in the 50 MB L2 between steps. The
// host loop (one ctypes call a launch) can set the pace at those planes:
// CUDA-graph capture of the chain is left for later work.
//
// f32 (the parity mode): the CUDA-core body of conv3x3_tile.cuh, a CTA per
// batch element x spatial tile x 64 output channels, 4 pixels x 4 channels
// of FMAs a thread.
//
// Layouts: h, rh, z, hs planes are contiguous (B, H, W, C); gx/cx are read
// at pixel stride `pix` and batch stride `bstride` (the hoisted input
// conv's channel slices, or a stride-0-in-T broadcast).

#include "conv3x3_mma.cuh"

namespace {

using convgru_tc::bf16;

template <typename T>
const T* cp(const void* p) {
  return static_cast<const T*>(p);
}
template <typename T>
T* mp(void* p) {
  return static_cast<T*>(p);
}

// Candidate epilogue: h' = (1 - z) h + z tanh(cx + ch), rounded once.
struct CandEpi {
  const bf16* cx;
  int64_t cx_bstride, cx_pix;
  const float* z;
  const bf16* h_prev;
  bf16* h_out;
  int C;
  struct In {
    float cx, z, h;
  };
  __device__ __forceinline__ In load(int64_t q, int b, int64_t p,
                                     int n) const {
    const int64_t o = q * C + n;
    return {convgru::to_f(cx[b * cx_bstride + p * cx_pix + n]), z[o],
            convgru::to_f(h_prev[o])};
  }
  __device__ __forceinline__ void store(int64_t q, int n, const In& in,
                                        float a) const {
    const float cand = tanhf(in.cx + a);
    h_out[q * C + n] = convgru::from_f<bf16>(convgru::blend(in.z, in.h, cand));
  }
};

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32 (CUDA-core
// body), 1 = bfloat16 (tensor cores, run as the plan (tile, slices) says;
// `work` and `counters` are the plan's split-K scratch, counters zero
// before the call's first launch, both unused with one slice). Each
// launching function makes ONE launch on `stream` (a cudaStream_t) and
// returns cudaGetLastError() right after it (0 = launched).
extern "C" {

int convgru_gate_step(int dtype, int device, const void* h, const void* gx,
                      int64_t gx_bstride, int64_t gx_pix, const void* wg,
                      void* rh, float* z, int B, int H, int W, int C,
                      int tile, int slices, float* work, void* counters,
                      void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return convgru_tc::conv3x3_mma(
        tile, h, wg, B, H, W, C, 2 * C, slices, work, counters,
        convgru_tc::GateEpi{cp<bf16>(h), cp<bf16>(gx), gx_bstride, gx_pix,
                            mp<bf16>(rh), z, nullptr, C},
        s);
  if (dtype == 0)
    return CONVGRU_F32(H, W, convgru::gate_launch, h, gx, gx_bstride, gx_pix,
                       wg, rh, z, nullptr, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int convgru_cand_step(int dtype, int device, const void* rh, const void* cx,
                      int64_t cx_bstride, int64_t cx_pix, const void* wc,
                      const float* z, const void* h_prev, void* h_out, int B,
                      int H, int W, int C, int tile, int slices, float* work,
                      void* counters, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return convgru_tc::conv3x3_mma(
        tile, rh, wc, B, H, W, C, C, slices, work, counters,
        CandEpi{cp<bf16>(cx), cx_bstride, cx_pix, z, cp<bf16>(h_prev),
                mp<bf16>(h_out), C},
        s);
  if (dtype == 0)
    return CONVGRU_F32(H, W, convgru::cand_launch, rh, cx, cx_bstride, cx_pix,
                       wc, z, h_prev, h_out, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// {frames, rows, columns, output channels, stages, shared memory bytes} of
// the tensor-core tile `tile` (0 = described).
int convgru_mma_tile(int tile, int* out) {
  return convgru_tc::tile_info(tile, out);
}

const char* convgru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
