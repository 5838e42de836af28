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
// channels in registers (CUDA-core FMAs). The tile and the gate launch are
// shared with the backward (K2), and both launches with the single-step
// entry (K4, convgru_cell.cu), in conv3x3_tile.cuh.
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
// Layouts: h, rh, z, hs planes are contiguous (B, H, W, C); gx/cx are read
// at pixel stride `pix` and batch stride `bstride` (the hoisted input
// conv's channel slices, or a stride-0-in-T broadcast).

#include "conv3x3_tile.cuh"

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each function makes ONE launch on `stream` (a cudaStream_t) and returns
// cudaGetLastError() right after it (0 = launched).
extern "C" {

int convgru_gate_step(int dtype, int device, const void* h, const void* gx,
                      int64_t gx_bstride, int64_t gx_pix, const void* wg,
                      void* rh, float* z, int B, int H, int W, int C,
                      void* stream) {
  CONVGRU_DISPATCH(dtype, device, H, W, convgru::gate_launch, h, gx,
                   gx_bstride, gx_pix, wg, rh, z, nullptr, B, H, W, C,
                   static_cast<cudaStream_t>(stream));
}

int convgru_cand_step(int dtype, int device, const void* rh, const void* cx,
                      int64_t cx_bstride, int64_t cx_pix, const void* wc,
                      const float* z, const void* h_prev, void* h_out, int B,
                      int H, int W, int C, void* stream) {
  CONVGRU_DISPATCH(dtype, device, H, W, convgru::cand_launch, rh, cx,
                   cx_bstride, cx_pix, wc, z, h_prev, h_out, B, H, W, C,
                   static_cast<cudaStream_t>(stream));
}

const char* convgru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
