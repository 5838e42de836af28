// Fused nearest-upsample-2x + SAME 3x3 conv (K5a forward, K5b backward) for
// Hopper (sm_90a).
//
// Replaces dvdgan_tpu/kernels/ups2x_fused.py:_fwd_pallas and :_bwd_pallas.
// Nearest-up-2x followed by a 3x3 conv is one 2x2-tap conv per output phase
// (p, q) in {0,1}^2 of the zero-padded source frame xp (N, H+2, W+2, Cin):
//
//   out[n, 2i+p, 2j+q, co] = sum_{a,b in {0,1}, ci}
//       xp[n, i+p+a, j+q+b, ci] * wall[(2a+b)*Cin + ci, (2p+q)*Cout + co]
//
// with wall (4*Cin, 4*Cout) the phase kernels, tap-major rows and phase-major
// columns (the 3x3 -> 2x2 tap sums are formed outside, ops/layers.py). f32
// accumulation, one rounding to the activation type. All products run in
// these kernels' own bodies (no cuDNN, no cuBLAS).
//
// The TPU kernel computes every phase at all (H+1)(W+1) positions (its MXU
// wants 4*Cout lanes), keeps a whole frame resident and sweeps rows. Here
// only the four useful phases of each source pixel are computed, 16*Cin*Cout
// MACs per source pixel, and the interleave is the store's address.
//
// Three launches, each split by dtype inside the kernel (if constexpr on T):
//
//  * bf16 (the fast path): tensor cores. Every launch is an implicit GEMM
//    over channels-last patches staged in shared memory in bf16 with
//    cp.async (16-byte copies, zero-filled past an edge; two or three
//    stages in flight over the contraction), bf16 operands and f32
//    accumulators on mma.sync.m16n8k16, fragments read with ldmatrix from
//    tiles whose row stride is 16 bytes mod 128 (conflict-free). A shifted
//    or strided window costs nothing: each lane hands ldmatrix its own row
//    address, so one staged patch serves every tap. Building blocks:
//    mma_bf16.cuh (shared with K6, K1 and K2).
//  * f32 (the parity mode): FMAs on the CUDA cores, the body of the first
//    port. Tensor cores with f32 operands would mean TF32, which loses
//    bits. A bf16 CUDA tensor always gets the tensor-core body.
//
// K5a, ONE launch (ups2x_fwd_kernel). bf16: a CTA owns a tile of 128 source
// pixels (TF frames x TH x TW: small planes fold frames in) and 32 output
// channels of all four phases; per phase the product is
//   out_pq[pix, co] = sum_tap xp[pix + (p+a, q+b), :] . wall[tap rows, pq cols]
// (M = pixels, K = 4 Cin, N = Cout). A is one staged (tile+2)^2 patch of a
// 32-channel chunk of xp; B the 16 (tap, phase) slices of wall_t =
// wall^T (4*Cout, 4*Cin), n-major as mma wants it. A warp owns 32 pixels x
// 32 channels x 4 phases (128 f32 accumulators a thread) and loads each of
// the 9 shifted A fragments once for the (tap, phase) pairs that share it.
// The sums are rounded once to bf16 and leave through shared memory, so the
// interleaved rows 2i+p are written as whole 16-byte vectors. f32: 256
// threads, each 4 phases x 4 pixels x 4 channels in registers, staged as f32
// in chunks of 8 channels.
//
// K5b, TWO launches:
//  * ups2x_dx_kernel: dxp (N, H+2, W+2, Cin) in f32, in gather form (no
//    atomics). A padded pixel (r, s) reads the 4x4 window of g at rows
//    2r-dr, columns 2s-dc (dr, dc in 0..3; phase p = dr & 1, tap a = dr >> 1,
//    the same per column): a stride-2 4x4 conv of g. bf16: M = padded
//    pixels, N = 32 Cin per CTA, K = 16 offsets x Cout; A from a staged g
//    patch laid out with even and odd columns apart (a stride-2 gather of
//    neighbouring pixels reads neighbouring rows), B = wall itself (for one
//    (tap, phase): rows ci, co contiguous: already n-major). f32: the same
//    gather from wall_t on the CUDA cores.
//  * ups2x_dw_kernel: dwall (4*Cin, 4*Cout) in f32,
//      dwall[(2a+b)Cin+ci, (2p+q)Cout+co] =
//          sum_{n,i,j} xp[n, i+p+a, j+q+b, ci] * g[n, 2i+p, 2j+q, co],
//    a reduction over N*H*W. The grid is (blocks of (ci, co); bf16: of
//    (phase, ci, co)) x (slices of the (frame, tile) sequence). bf16: a CTA
//    owns one phase, 64 ci x 32 co, all four taps (a warp each); M = ci,
//    N = co, K = pixels; the xp patch and the phase's g pixels lie with
//    pixels as rows and are read with ldmatrix.trans; the four taps share
//    the g operand and read four shifted xp windows. Each CTA writes its
//    partial sums to scratch; the LAST CTA of a block to finish (a counter
//    per block) adds the slices' partials in slice order, so two runs give
//    the same bits (no float atomics).
//
// What bounds them on the H100: operations (16*Cin*Cout MACs per source
// pixel, forward; twice that backward) against Cin elements read and 4*Cout
// written. The bf16 bodies reach 3-26% of the bf16 peak (PERF.md): 0.4-0.5
// ldmatrix.x4 per mma, one or two 4-warp CTAs an SM, and at the 4x4 and
// 8x8 planes 128-pixel CTAs that stage 1.6-2.3x halos and all 16 weight
// slices. wgmma, TMA and persistent CTAs are left for later work.
//
// Layouts: xp, out, g, dxp contiguous channels-last; wall, wall_t, dwall
// row-major.

#include "conv3x3_tile.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using convgru::to_f;

template <typename T>
constexpr bool kTC = sizeof(T) == 2;     // bf16: the tensor-core body

// ---- f32: CUDA-core FMAs ---------------------------------------------------

constexpr int NT = 256;                  // threads per CTA
constexpr int PM = 4, OM = 4;            // a thread's pixels x channels
constexpr int OCB = 32;                  // a CTA's output channels
constexpr int OG = OCB / OM;             // channel groups (8)
constexpr int PG = NT / OG;              // pixel groups (32)
constexpr int KC = 8;                    // contraction channels per chunk
constexpr int W_SMEM = 16 * KC * OCB;    // 16 (tap, phase) slices, floats
constexpr int BATCH = 8;                 // global loads in flight per thread

// A patch lies in shared memory as [channel][pixel] and is staged with the
// channel running fastest over the threads (the global reads are then
// contiguous). A channel stride of 4 * odd floats sends the 8 channels x 4
// pixels a warp stores at once to 32 different banks.
constexpr int channel_stride(int pixels) {
  return pixels % 8 == 4 ? pixels : pixels + 4;
}

// A CTA's tile of the output domain: TF frames x TH x TW pixels = 128.
template <int TF_, int TH_, int TW_>
struct FTile {
  static constexpr int TF = TF_, TH = TH_, TW = TW_;
  static constexpr int XG = TW / PM;
  static_assert(TW % PM == 0 && TF * TH * XG == PG, "128 pixels per CTA");
  // forward: the xp patch (stride 1, one-pixel halo each side)
  static constexpr int HH = TH + 2, HW = TW + 2;
  static constexpr int IN_PIX = TF * HH * HW;
  static constexpr int IN_CS = channel_stride(IN_PIX);
  static constexpr int IN_SMEM = KC * IN_CS;
  // dx: the g patch (rows 2r-3 .. 2r of every tile row r)
  static constexpr int GH = 2 * TH + 2, GW = 2 * TW + 2;
  static constexpr int G_PIX = TF * GH * GW;
  static constexpr int G_CS = channel_stride(G_PIX);
  static constexpr int G_SMEM = KC * G_CS;
  static_assert(IN_PIX % 4 == 0 && G_PIX % 4 == 0, "channel_stride");
  static_assert((G_SMEM + W_SMEM) * 4 <= 48 * 1024, "static smem limit");
};

using TileBig = FTile<1, 8, 16>;    // planes wider than 8
using TileMid = FTile<2, 8, 8>;     // planes up to 8 wide: two frames
using TileSmall = FTile<8, 4, 4>;   // 4x4 planes: eight frames

// The CTA's first frame, row and column of a (frames, Hd, Wd) domain tiled
// by TL (blockIdx.x), and pixel m of the tile as (frame, row, column).
template <class TL>
struct TileAt {
  int n0, y0, x0;
  __device__ TileAt(int Hd, int Wd) {
    const int tiles_x = (Wd + TL::TW - 1) / TL::TW;
    const int tiles_y = (Hd + TL::TH - 1) / TL::TH;
    int bx = blockIdx.x;
    x0 = (bx % tiles_x) * TL::TW;
    bx /= tiles_x;
    y0 = (bx % tiles_y) * TL::TH;
    n0 = (bx / tiles_y) * TL::TF;
  }
  static __device__ void pixel(int m, int& f, int& y, int& x) {
    x = m % TL::TW;
    y = (m / TL::TW) % TL::TH;
    f = m / (TL::TW * TL::TH);
  }
};

// The f32 bodies' view: also the channel block (blockIdx.y) and this
// thread's frame, row, first column and channel group.
template <class TL>
struct Place : TileAt<TL> {
  int c0, f, py, px0, og;
  __device__ Place(int Hd, int Wd) : TileAt<TL>(Hd, Wd) {
    c0 = blockIdx.y * OCB;
    const int pg = threadIdx.x / OG;
    og = threadIdx.x % OG;
    px0 = (pg % TL::XG) * PM;
    py = (pg / TL::XG) % TL::TH;
    f = pg / (TL::XG * TL::TH);
  }
};

template <class TL>
dim3 grid_for(int N, int Hd, int Wd, int channels) {
  const int tiles = ((Hd + TL::TH - 1) / TL::TH) * ((Wd + TL::TW - 1) / TL::TW);
  return dim3(((N + TL::TF - 1) / TL::TF) * tiles, (channels + OCB - 1) / OCB);
}

// Stages COUNT elements as f32, all NT threads, BATCH independent global
// loads in flight per thread. addr(i, from, to) gives element i's offset in
// `src` and in `dst`, and returns whether it exists (else 0 is stored).
template <int COUNT, typename T, class Addr>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, Addr addr) {
  constexpr int ITERS = (COUNT + NT - 1) / NT;
#pragma unroll 1
  for (int k0 = 0; k0 < ITERS; k0 += BATCH) {
    T v[BATCH];
    int to[BATCH];
    bool ok[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = threadIdx.x + (k0 + k) * NT;
      int64_t from = 0;
      to[k] = -1;
      ok[k] = false;
      if (k0 + k < ITERS && i < COUNT) ok[k] = addr(i, from, to[k]);
      if (ok[k]) v[k] = src[from];
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (to[k] >= 0) dst[to[k]] = ok[k] ? to_f(v[k]) : 0.f;
  }
}

// K5a, f32. grid: grid_for<TL>(N, H, W, Cout)
template <class TL>
__device__ __forceinline__ void fwd_cuda_core(const float* __restrict__ xp,
                                              const float* __restrict__ wall,
                                              float* __restrict__ out, int N,
                                              int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float in_s[TL::IN_SMEM];  // [ci][f, yy, xx]
  __shared__ __align__(16) float w_s[W_SMEM];        // [tap][phase][ci][oc]
  const Place<TL> at(H, W);
  const int HP = H + 2, WP = W + 2;

  float acc[4][PM][OM] = {};
  for (int ci0 = 0; ci0 < Cin; ci0 += KC) {
    __syncthreads();  // the previous chunk has been consumed
    stage<KC * TL::IN_PIX>(in_s, xp, [&](int i, int64_t& a, int& to) {
      const int cil = i % KC, pix = i / KC;
      const int xx = pix % TL::HW, yy = (pix / TL::HW) % TL::HH;
      const int n = at.n0 + pix / (TL::HW * TL::HH);
      const int y = at.y0 + yy, x = at.x0 + xx, ci = ci0 + cil;
      a = (((int64_t)n * HP + y) * WP + x) * Cin + ci;
      to = cil * TL::IN_CS + pix;
      return n < N && y < HP && x < WP && ci < Cin;
    });
    stage<W_SMEM>(w_s, wall, [&](int i, int64_t& a, int& to) {
      const int oc = at.c0 + i % OCB;
      const int ci = ci0 + (i / OCB) % KC;
      const int tp = i / (OCB * KC);          // tap * 4 + phase
      a = ((int64_t)(tp / 4) * Cin + ci) * (4 * Cout) + (tp % 4) * Cout + oc;
      to = i;
      return oc < Cout && ci < Cin;
    });
    __syncthreads();

#pragma unroll 1
    for (int cil = 0; cil < KC; ++cil) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row =
            in_s + cil * TL::IN_CS + (at.f * TL::HH + at.py + dy) * TL::HW +
            at.px0;
        float xin[PM + 2];
#pragma unroll
        for (int k = 0; k < PM + 2; ++k) xin[k] = row[k];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int a = dy - p;
          if (a < 0 || a > 1) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int b = dx - q;
              if (b < 0 || b > 1) continue;
              const float4 wv = *reinterpret_cast<const float4*>(
                  w_s + (((2 * a + b) * 4 + 2 * p + q) * KC + cil) * OCB +
                  at.og * OM);
#pragma unroll
              for (int px = 0; px < PM; ++px) {
                const float xv = xin[px + dx];
                acc[2 * p + q][px][0] = fmaf(xv, wv.x, acc[2 * p + q][px][0]);
                acc[2 * p + q][px][1] = fmaf(xv, wv.y, acc[2 * p + q][px][1]);
                acc[2 * p + q][px][2] = fmaf(xv, wv.z, acc[2 * p + q][px][2]);
                acc[2 * p + q][px][3] = fmaf(xv, wv.w, acc[2 * p + q][px][3]);
              }
            }
          }
        }
      }
    }
  }

  const int n = at.n0 + at.f, i = at.y0 + at.py;
  if (n >= N || i >= H) return;
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const int64_t orow = ((int64_t)n * 2 * H + 2 * i + ph / 2) * 2 * W;
#pragma unroll
    for (int px = 0; px < PM; ++px) {
      const int j = at.x0 + at.px0 + px;
      if (j >= W) continue;
#pragma unroll
      for (int k = 0; k < OM; ++k) {
        const int oc = at.c0 + at.og * OM + k;
        if (oc < Cout) out[(orow + 2 * j + ph % 2) * Cout + oc] = acc[ph][px][k];
      }
    }
  }
}

// K5b dxp, f32. grid: grid_for<TL>(N, H + 2, W + 2, Cin)
template <class TL>
__device__ __forceinline__ void dx_cuda_core(const float* __restrict__ g,
                                             const float* __restrict__ wall_t,
                                             float* __restrict__ dxp, int N,
                                             int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float g_s[TL::G_SMEM];  // [co][f, yy, xx]
  __shared__ __align__(16) float w_s[W_SMEM];      // [dr][dc][co][ci]
  const int HP = H + 2, WP = W + 2;
  const Place<TL> at(HP, WP);

  float acc[PM][OM] = {};
  for (int co0 = 0; co0 < Cout; co0 += KC) {
    __syncthreads();
    stage<KC * TL::G_PIX>(g_s, g, [&](int i, int64_t& a, int& to) {
      const int col = i % KC, pix = i / KC;
      const int xx = pix % TL::GW, yy = (pix / TL::GW) % TL::GH;
      const int n = at.n0 + pix / (TL::GW * TL::GH);
      const int gy = 2 * at.y0 - 3 + yy, gx = 2 * at.x0 - 3 + xx;
      const int co = co0 + col;
      a = (((int64_t)n * 2 * H + gy) * 2 * W + gx) * Cout + co;
      to = col * TL::G_CS + pix;
      return n < N && gy >= 0 && gy < 2 * H && gx >= 0 && gx < 2 * W &&
             co < Cout;
    });
    stage<W_SMEM>(w_s, wall_t, [&](int i, int64_t& a, int& to) {
      const int ci = at.c0 + i % OCB;
      const int co = co0 + (i / OCB) % KC;
      const int dd = i / (OCB * KC);          // dr * 4 + dc
      const int dr = dd / 4, dc = dd % 4;
      const int phase = 2 * (dr & 1) + (dc & 1), tap = 2 * (dr >> 1) + (dc >> 1);
      a = ((int64_t)phase * Cout + co) * (4 * Cin) + tap * Cin + ci;
      to = i;
      return ci < Cin && co < Cout;
    });
    __syncthreads();

#pragma unroll 1
    for (int col = 0; col < KC; ++col) {
#pragma unroll
      for (int dr = 0; dr < 4; ++dr) {
        const float* row =
            g_s + col * TL::G_CS +
            (at.f * TL::GH + 2 * at.py + 3 - dr) * TL::GW + 2 * at.px0;
        float gin[2 * PM + 2];
#pragma unroll
        for (int k = 0; k < 2 * PM + 2; ++k) gin[k] = row[k];
#pragma unroll
        for (int dc = 0; dc < 4; ++dc) {
          const float4 wv = *reinterpret_cast<const float4*>(
              w_s + ((dr * 4 + dc) * KC + col) * OCB + at.og * OM);
#pragma unroll
          for (int px = 0; px < PM; ++px) {
            const float gv = gin[2 * px + 3 - dc];
            acc[px][0] = fmaf(gv, wv.x, acc[px][0]);
            acc[px][1] = fmaf(gv, wv.y, acc[px][1]);
            acc[px][2] = fmaf(gv, wv.z, acc[px][2]);
            acc[px][3] = fmaf(gv, wv.w, acc[px][3]);
          }
        }
      }
    }
  }

  const int n = at.n0 + at.f, r = at.y0 + at.py;
  if (n >= N || r >= HP) return;
#pragma unroll
  for (int px = 0; px < PM; ++px) {
    const int s = at.x0 + at.px0 + px;
    if (s >= WP) continue;
#pragma unroll
    for (int k = 0; k < OM; ++k) {
      const int ci = at.c0 + at.og * OM + k;
      if (ci < Cin) dxp[(((int64_t)n * HP + r) * WP + s) * Cin + ci] = acc[px][k];
    }
  }
}

// K5b dwall, f32.
constexpr int DWB = 32;           // a CTA's block of ci and of co
constexpr int DW_TARGET = 264;    // CTAs a launch aims at: two per SM

inline int dw_tile(int H, int W) { return H <= 4 && W <= 4 ? 4 : 8; }

inline int dw_units(int N, int H, int W) {
  const int t = dw_tile(H, W);
  return N * ((H + t - 1) / t) * ((W + t - 1) / t);
}

// grid: (dw_blocks, slices). Thread = (phase, 4 ci, 4 co); tile TS x TS
// source pixels of one frame per step of the CTA's loop.
template <int TS>
__device__ __forceinline__ void dw_cuda_core(
    const float* __restrict__ xp, const float* __restrict__ g,
    float* __restrict__ partial, float* __restrict__ dwall,
    unsigned int* __restrict__ counters, int N, int H, int W, int Cin,
    int Cout, int units_per_slice) {
  constexpr int XW = TS + 2, GWD = 2 * TS;
  constexpr int X_SMEM = XW * XW * DWB, G_SMEM = GWD * GWD * DWB;
  static_assert((X_SMEM + G_SMEM) * 4 + 16 <= 48 * 1024, "static smem limit");
  __shared__ __align__(16) float x_s[X_SMEM];  // [yy][xx][ci]
  __shared__ __align__(16) float g_s[G_SMEM];  // [yy][xx][co]

  const int co_blocks = (Cout + DWB - 1) / DWB;
  const int ci0 = (blockIdx.x / co_blocks) * DWB;
  const int co0 = (blockIdx.x % co_blocks) * DWB;
  const int slices = gridDim.y;
  const int tiles_x = (W + TS - 1) / TS, tiles_y = (H + TS - 1) / TS;
  const int tiles = tiles_x * tiles_y, units = N * tiles;
  const int u0 = blockIdx.y * units_per_slice;
  const int u1 = min(units, u0 + units_per_slice);
  const int HP = H + 2, WP = W + 2;

  const int tid = threadIdx.x;
  const int phase = tid / 64, p = phase >> 1, q = phase & 1;
  const int cig = tid % 8, cog = (tid % 64) / 8;

  float acc[4][4][4] = {};   // [tap][ci][co]
  for (int u = u0; u < u1; ++u) {
    const int n = u / tiles, tile = u % tiles;
    const int i0 = (tile / tiles_x) * TS, j0 = (tile % tiles_x) * TS;
    __syncthreads();
    stage<X_SMEM>(x_s, xp, [&](int i, int64_t& a, int& to) {
      const int ci = ci0 + i % DWB;
      const int y = i0 + (i / DWB) / XW, x = j0 + (i / DWB) % XW;
      a = (((int64_t)n * HP + y) * WP + x) * Cin + ci;
      to = i;
      return y < HP && x < WP && ci < Cin;
    });
    stage<G_SMEM>(g_s, g, [&](int i, int64_t& a, int& to) {
      const int co = co0 + i % DWB;
      const int gy = 2 * i0 + (i / DWB) / GWD, gx = 2 * j0 + (i / DWB) % GWD;
      a = (((int64_t)n * 2 * H + gy) * 2 * W + gx) * Cout + co;
      to = i;
      return gy < 2 * H && gx < 2 * W && co < Cout;
    });
    __syncthreads();

#pragma unroll 1
    for (int i = 0; i < TS; ++i) {
#pragma unroll 2
      for (int j = 0; j < TS; ++j) {
        const float4 gv = *reinterpret_cast<const float4*>(
            g_s + ((2 * i + p) * GWD + 2 * j + q) * DWB + cog * 4);
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          const float4 xv = *reinterpret_cast<const float4*>(
              x_s + ((i + p + tap / 2) * XW + j + q + tap % 2) * DWB + cig * 4);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[tap][c][0] = fmaf(xs[c], gv.x, acc[tap][c][0]);
            acc[tap][c][1] = fmaf(xs[c], gv.y, acc[tap][c][1]);
            acc[tap][c][2] = fmaf(xs[c], gv.z, acc[tap][c][2]);
            acc[tap][c][3] = fmaf(xs[c], gv.w, acc[tap][c][3]);
          }
        }
      }
    }
  }

  // this slice's partial sums, then the last CTA of the block adds them all
  const int64_t slice_stride = (int64_t)16 * Cin * Cout;
  auto index = [&](int tap, int c, int d) -> int64_t {
    const int ci = ci0 + cig * 4 + c, co = co0 + cog * 4 + d;
    if (ci >= Cin || co >= Cout) return -1;
    return ((int64_t)tap * Cin + ci) * (4 * Cout) + phase * Cout + co;
  };
  float* mine = partial + blockIdx.y * slice_stride;
#pragma unroll
  for (int tap = 0; tap < 4; ++tap)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int64_t o = index(tap, c, d);
        if (o >= 0) mine[o] = acc[tap][c][d];
      }
  if (!tc::last_to_arrive(counters + blockIdx.x, slices)) return;
#pragma unroll 1
  for (int tap = 0; tap < 4; ++tap)
    for (int c = 0; c < 4; ++c)
      for (int d = 0; d < 4; ++d) {
        const int64_t o = index(tap, c, d);
        if (o < 0) continue;
        float sum = 0.f;
        for (int s = 0; s < slices; ++s) sum += __ldcg(partial + s * slice_stride + o);
        dwall[o] = sum;
      }
}

// ---- bf16: tensor cores ----------------------------------------------------

using tc::ldmatrix_x4;
using tc::ldmatrix_x4_trans;
using tc::mma_16816;

constexpr int TC_NT = 128;               // threads per CTA: four warps

template <typename T>
constexpr int threads_for = kTC<T> ? TC_NT : NT;

// K5a, bf16. grid: grid_for<TL>(N, H, W, Cout) (32 channels a CTA).
constexpr int FKC = 32, FLD = FKC + 8;   // channels a step; row stride 80 B
constexpr int OLD = OCB + 8;             // the output tile's row stride

template <class TL>
struct FwdTC {
  static constexpr int PATCH = TL::IN_PIX;            // [f][yy][xx]
  static constexpr int WROWS = 16 * OCB;              // [tap][phase][co]
  static constexpr int STAGE = (PATCH + WROWS) * FLD;
  static constexpr int OUT = TL::TF * 4 * TL::TH * TL::TW * OLD;
  static constexpr int SMEM = (2 * STAGE > OUT ? 2 * STAGE : OUT) * 2;
};

template <class TL>
__device__ __forceinline__ void fwd_tensor_core(
    const bf16* __restrict__ xp, const bf16* __restrict__ wall_t,
    bf16* __restrict__ out, int N, int H, int W, int Cin, int Cout) {
  using L = FwdTC<TL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const TileAt<TL> at(H, W);
  const int co0 = blockIdx.y * OCB;
  const int HP = H + 2, WP = W + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = Cin % 8 == 0 && tc::aligned16(xp) && tc::aligned16(wall_t);

  // ldmatrix rows of this lane: A, pixel 32 warp + 16 mt + lane % 16 of the
  // patch (channels + 8 for lanes 16-31); B, row lane % 8 (+ 8 for lanes
  // 16-31: the second n-tile) of a 16-row pair, channels + 8 for lanes 8-15
  // and 24-31
  int a_row[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    int f, y, x;
    TileAt<TL>::pixel(32 * warp + 16 * mt + (lane & 15), f, y, x);
    a_row[mt] = ((f * TL::HH + y) * TL::HW + x) * FLD + (lane >> 4) * 8;
  }
  const int b_row = ((lane >> 4) * 8 + (lane & 7)) * FLD + ((lane >> 3) & 1) * 8;

  float acc[4][2][4][4];     // [phase][m-tile][n-tile][fragment]
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) tc::zero(acc[ph]);

  auto load = [&](int step, int buf) {
    const int ci0 = step * FKC;
    bf16* xs = smem + buf * L::STAGE;
    bf16* ws = xs + L::PATCH * FLD;
    tc::stage_rows<TC_NT, FKC, FLD>(xs, L::PATCH, Cin - ci0, vec, xp,
        [&](int r) -> const bf16* {
      const int xx = r % TL::HW, yy = (r / TL::HW) % TL::HH;
      const int n = at.n0 + r / (TL::HW * TL::HH);
      const int y = at.y0 + yy, x = at.x0 + xx;
      return n < N && y < HP && x < WP
                 ? xp + (((int64_t)n * HP + y) * WP + x) * Cin + ci0
                 : nullptr;
    });
    tc::stage_rows<TC_NT, FKC, FLD>(ws, L::WROWS, Cin - ci0, vec, wall_t,
        [&](int r) -> const bf16* {
      const int co = co0 + r % OCB, s = r / OCB;     // s = tap * 4 + phase
      return co < Cout ? wall_t + (int64_t)((s & 3) * Cout + co) * (4 * Cin) +
                             (s >> 2) * Cin + ci0
                       : nullptr;
    });
  };
  auto compute = [&](int, int buf) {
    const bf16* xs = smem + buf * L::STAGE;
    const bf16* ws = xs + L::PATCH * FLD;
#pragma unroll
    for (int kk = 0; kk < FKC; kk += 16) {
#pragma unroll
      for (int sy = 0; sy < 3; ++sy)
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) {
          // the A fragments at shift (sy, sx): every (tap, phase) with
          // p + a = sy and q + b = sx reads them
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(a[mt], xs + a_row[mt] + (sy * TL::HW + sx) * FLD + kk);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int ta = sy - p;
            if (ta < 0 || ta > 1) continue;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int tb = sx - q;
              if (tb < 0 || tb > 1) continue;
              const int s = (2 * ta + tb) * 4 + 2 * p + q;
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                uint32_t b[4];
                ldmatrix_x4(b, ws + (s * OCB + 16 * j) * FLD + b_row + kk);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  mma_16816(acc[2 * p + q][mt][2 * j], a[mt], b[0], b[1]);
                  mma_16816(acc[2 * p + q][mt][2 * j + 1], a[mt], b[2], b[3]);
                }
              }
            }
          }
        }
    }
  };
  tc::pipeline<2>((Cin + FKC - 1) / FKC, load, compute);

  // round once into an interleaved output tile [f][2TH][2TW][OLD], then
  // whole 16-byte vectors of its rows to `out`
  bf16* os = smem;
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int f, y, x;
        TileAt<TL>::pixel(32 * warp + 16 * mt + g + 8 * h, f, y, x);
        bf16* row = os + ((f * 2 * TL::TH + 2 * y + (ph >> 1)) * 2 * TL::TW +
                          2 * x + (ph & 1)) * OLD + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(row + nt * 8) =
              __floats2bfloat162_rn(acc[ph][mt][nt][2 * h],
                                    acc[ph][mt][nt][2 * h + 1]);
      }
  __syncthreads();
  constexpr int OW = 2 * TL::TW, OH = 2 * TL::TH, OV = OCB / 8;
  const bool ovec = Cout % 8 == 0 && tc::aligned16(out);
  for (int u = threadIdx.x; u < TL::TF * OH * OW * OV; u += TC_NT) {
    const int v = u % OV, pix = u / OV;
    const int ox = pix % OW, oy = (pix / OW) % OH, n = at.n0 + pix / (OW * OH);
    const int Y = 2 * at.y0 + oy, X = 2 * at.x0 + ox, co = co0 + 8 * v;
    if (n >= N || Y >= 2 * H || X >= 2 * W || co >= Cout) continue;
    bf16* dst = out + (((int64_t)n * 2 * H + Y) * 2 * W + X) * Cout + co;
    const bf16* src = os + pix * OLD + 8 * v;
    if (ovec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < 8 && co + k < Cout; ++k) dst[k] = src[k];
    }
  }
}

// K5b dxp, bf16. grid: grid_for<TL>(N, H + 2, W + 2, Cin) (32 a CTA).
constexpr int XKC = 16, XLD = XKC + 8;   // channels of g a step; 48 B rows

template <class TL>
struct DxTC {
  static constexpr int GROWS = TL::G_PIX;     // [f][yy][column parity][xx/2]
  static constexpr int WROWS = 16 * OCB;      // [tap][phase][ci]
  static constexpr int STAGE = (GROWS + WROWS) * XLD;
  static constexpr int SMEM = 2 * STAGE * 2;
  static_assert(TL::GW % 2 == 0, "the g patch's column halves");
};

template <class TL>
__device__ __forceinline__ void dx_tensor_core(
    const bf16* __restrict__ g, const bf16* __restrict__ wall,
    float* __restrict__ dxp, int N, int H, int W, int Cin, int Cout) {
  using L = DxTC<TL>;
  constexpr int GH = TL::GH, GW = TL::GW, HALF = GW / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int HP = H + 2, WP = W + 2;
  const TileAt<TL> at(HP, WP);
  const int ci0 = blockIdx.y * OCB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const bool vec = Cout % 8 == 0 && tc::aligned16(g) && tc::aligned16(wall);

  // A: padded pixel (f, ry, rx) at offset (dr, dc) reads g patch row
  // 2 ry + 3 - dr, column 2 rx + 3 - dc, which lies in the column half of
  // parity (3 - dc) & 1 at rx + (3 - dc) / 2
  int a_row[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    int f, y, x;
    TileAt<TL>::pixel(32 * warp + 16 * mt + (lane & 15), f, y, x);
    a_row[mt] = ((f * GH + 2 * y) * GW + x) * XLD + (lane >> 4) * 8;
  }
  const int b_row = ((lane >> 4) * 8 + (lane & 7)) * XLD + ((lane >> 3) & 1) * 8;

  float acc[2][4][4];        // [m-tile][n-tile][fragment]
  tc::zero(acc);

  auto load = [&](int step, int buf) {
    const int co0 = step * XKC;
    bf16* gs = smem + buf * L::STAGE;
    bf16* ws = gs + L::GROWS * XLD;
    tc::stage_rows<TC_NT, XKC, XLD>(gs, L::GROWS, Cout - co0, vec, g,
        [&](int r) -> const bf16* {
      const int c = r % GW, yy = (r / GW) % GH;
      const int n = at.n0 + r / (GW * GH);
      const int xx = 2 * (c % HALF) + c / HALF;
      const int gy = 2 * at.y0 - 3 + yy, gx = 2 * at.x0 - 3 + xx;
      return n < N && gy >= 0 && gy < 2 * H && gx >= 0 && gx < 2 * W
                 ? g + (((int64_t)n * 2 * H + gy) * 2 * W + gx) * Cout + co0
                 : nullptr;
    });
    tc::stage_rows<TC_NT, XKC, XLD>(ws, L::WROWS, Cout - co0, vec, wall,
        [&](int r) -> const bf16* {
      const int ci = ci0 + r % OCB, s = r / OCB;     // s = tap * 4 + phase
      return ci < Cin ? wall + ((int64_t)(s >> 2) * Cin + ci) * (4 * Cout) +
                            (s & 3) * Cout + co0
                      : nullptr;
    });
  };
  auto compute = [&](int, int buf) {
    const bf16* gs = smem + buf * L::STAGE;
    const bf16* ws = gs + L::GROWS * XLD;
    float part[2][4][4];     // this step's sums (see tc::promote)
    tc::zero(part);
#pragma unroll
    for (int dr = 0; dr < 4; ++dr)
#pragma unroll
      for (int dc = 0; dc < 4; ++dc) {
        const int s = (2 * (dr >> 1) + (dc >> 1)) * 4 + 2 * (dr & 1) + (dc & 1);
        const int shift =
            (3 - dr) * GW + ((3 - dc) & 1) * HALF + ((3 - dc) >> 1);
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], gs + a_row[mt] + shift * XLD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, ws + (s * OCB + 16 * j) * XLD + b_row);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_16816(part[mt][2 * j], a[mt], b[0], b[1]);
            mma_16816(part[mt][2 * j + 1], a[mt], b[2], b[3]);
          }
        }
      }
    tc::promote(acc, part);
  };
  tc::pipeline<2>((Cout + XKC - 1) / XKC, load, compute);

  const bool pair = Cin % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int f, y, x;
      TileAt<TL>::pixel(32 * warp + 16 * mt + gq + 8 * h, f, y, x);
      const int n = at.n0 + f, r = at.y0 + y, s = at.x0 + x;
      if (n >= N || r >= HP || s >= WP) continue;
      float* row = dxp + (((int64_t)n * HP + r) * WP + s) * Cin;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ci = ci0 + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pair) {
          if (ci < Cin) *reinterpret_cast<float2*>(row + ci) = make_float2(v0, v1);
        } else {
          if (ci < Cin) row[ci] = v0;
          if (ci + 1 < Cin) row[ci + 1] = v1;
        }
      }
    }
}

// K5b dwall, bf16. grid: (dw_blocks: phase x ci blocks x co blocks, slices)
constexpr int WCI = 64;                  // a CTA's ci (its co: OCB)
constexpr int WXLD = WCI + 8, WGLD = OCB + 8;   // 144 B and 80 B rows
constexpr int DW_STAGES = 3;
constexpr int DW_TC_TARGET = 396;        // CTAs a launch aims at: three per SM

template <int TS>
struct DwTC {
  static constexpr int XROWS = (TS + 2) * (TS + 2), GROWS = TS * TS;
  static constexpr int STAGE = XROWS * WXLD + GROWS * WGLD;
  static constexpr int SMEM = DW_STAGES * STAGE * 2;
  static_assert(GROWS % 16 == 0, "whole k-steps of pixels");
};

template <int TS>
__device__ __forceinline__ void dw_tensor_core(
    const bf16* __restrict__ xp, const bf16* __restrict__ g,
    float* __restrict__ partial, float* __restrict__ dwall,
    unsigned int* __restrict__ counters, int N, int H, int W, int Cin,
    int Cout, int units_per_slice) {
  using L = DwTC<TS>;
  constexpr int XW = TS + 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int co_blocks = (Cout + OCB - 1) / OCB, ci_blocks = (Cin + WCI - 1) / WCI;
  int bx = blockIdx.x;
  const int co0 = (bx % co_blocks) * OCB;
  bx /= co_blocks;
  const int ci0 = (bx % ci_blocks) * WCI;
  const int phase = bx / ci_blocks, p = phase >> 1, q = phase & 1;
  const int slices = gridDim.y;
  const int tiles_x = (W + TS - 1) / TS, tiles_y = (H + TS - 1) / TS;
  const int tiles = tiles_x * tiles_y, units = N * tiles;
  const int u0 = blockIdx.y * units_per_slice;
  const int u1 = min(units, u0 + units_per_slice);
  const int HP = H + 2, WP = W + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;   // warp = tap
  const int gq = lane >> 2, t = lane & 3;
  const int ta = warp >> 1, tb = warp & 1;
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && tc::aligned16(xp) &&
                   tc::aligned16(g);

  // ldmatrix.trans rows of this lane within a 16-pixel k-step: A (xp^T),
  // pixel lane % 8 + 8 (lane / 16) at the tap's shift, ci + 8 for lanes
  // 8-15 and 24-31; B (g), pixel lane % 8 + 8 ((lane / 8) % 2), co + 8 for
  // lanes 16-31
  const int ka = (lane & 7) + (lane >> 4) * 8;
  const int kb = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;

  float acc[4][4][4];        // [m-tile: 16 ci][n-tile: 8 co][fragment]
  tc::zero(acc);

  auto load = [&](int step, int buf) {
    const int u = u0 + step, n = u / tiles, tile = u % tiles;
    const int i0 = (tile / tiles_x) * TS, j0 = (tile % tiles_x) * TS;
    bf16* xs = smem + buf * L::STAGE;
    bf16* gs = xs + L::XROWS * WXLD;
    tc::stage_rows<TC_NT, WCI, WXLD>(xs, L::XROWS, Cin - ci0, vec, xp,
        [&](int r) -> const bf16* {
      const int y = i0 + r / XW, x = j0 + r % XW;
      return y < HP && x < WP
                 ? xp + (((int64_t)n * HP + y) * WP + x) * Cin + ci0
                 : nullptr;
    });
    tc::stage_rows<TC_NT, OCB, WGLD>(gs, L::GROWS, Cout - co0, vec, g,
        [&](int r) -> const bf16* {
      const int i = i0 + r / TS, j = j0 + r % TS;
      return i < H && j < W
                 ? g + (((int64_t)n * 2 * H + 2 * i + p) * 2 * W + 2 * j + q) *
                           Cout + co0
                 : nullptr;
    });
  };
  auto compute = [&](int, int buf) {
    const bf16* xs = smem + buf * L::STAGE;
    const bf16* gs = xs + L::XROWS * WXLD;
    float part[4][4][4];     // this unit's sums (see tc::promote)
    tc::zero(part);
#pragma unroll
    for (int k0 = 0; k0 < L::GROWS; k0 += 16) {
      const int pa = k0 + ka, pb = k0 + kb;
      const bf16* arow =
          xs + ((pa / TS + p + ta) * XW + pa % TS + q + tb) * WXLD + a_col;
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4_trans(a[mt], arow + 16 * mt);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, gs + pb * WGLD + b_col + 16 * j);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_16816(part[mt][2 * j], a[mt], b[0], b[1]);
          mma_16816(part[mt][2 * j + 1], a[mt], b[2], b[3]);
        }
      }
    }
    tc::promote(acc, part);
  };
  tc::pipeline<DW_STAGES>(max(u1 - u0, 0), load, compute);

  // this slice's partial sums (or, as the only slice, dwall itself), then
  // the last CTA of the block adds the slices in order
  const int64_t slice_stride = (int64_t)16 * Cin * Cout;
  float* mine = slices == 1 ? dwall : partial + blockIdx.y * slice_stride;
  const bool pair = Cout % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + 16 * mt + gq + 8 * h;
      if (ci >= Cin) continue;
      float* row = mine + ((int64_t)warp * Cin + ci) * (4 * Cout) + phase * Cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pair) {
          if (co < Cout) *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
        } else {
          if (co < Cout) row[co] = v0;
          if (co + 1 < Cout) row[co + 1] = v1;
        }
      }
    }
  if (slices == 1 || !tc::last_to_arrive(counters + blockIdx.x, slices))
    return;
  for (int e = threadIdx.x; e < 4 * WCI * OCB; e += TC_NT) {
    const int co = co0 + e % OCB, ci = ci0 + (e / OCB) % WCI, tap = e / (OCB * WCI);
    if (ci >= Cin || co >= Cout) continue;
    const int64_t o = ((int64_t)tap * Cin + ci) * (4 * Cout) + phase * Cout + co;
    float sum = 0.f;
#pragma unroll 4
    for (int s = 0; s < slices; ++s) sum += __ldcg(partial + s * slice_stride + o);
    dwall[o] = sum;
  }
}

// ---- the kernels: one per launch, the body chosen by dtype ----------------

// xp (N, H+2, W+2, Cin) -> out (N, 2H, 2W, Cout). w: wall (f32) or wall_t
// (bf16).
template <class TL, typename T>
__global__ void __launch_bounds__(threads_for<T>)
ups2x_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ w,
                 T* __restrict__ out, int N, int H, int W, int Cin, int Cout) {
  if constexpr (kTC<T>)
    fwd_tensor_core<TL>(xp, w, out, N, H, W, Cin, Cout);
  else
    fwd_cuda_core<TL>(xp, w, out, N, H, W, Cin, Cout);
}

// g (N, 2H, 2W, Cout) -> dxp (N, H+2, W+2, Cin) f32. w: wall_t (f32) or
// wall (bf16).
template <class TL, typename T>
__global__ void __launch_bounds__(threads_for<T>)
ups2x_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
                float* __restrict__ dxp, int N, int H, int W, int Cin,
                int Cout) {
  if constexpr (kTC<T>)
    dx_tensor_core<TL>(g, w, dxp, N, H, W, Cin, Cout);
  else
    dx_cuda_core<TL>(g, w, dxp, N, H, W, Cin, Cout);
}

template <int TS, typename T>
__global__ void __launch_bounds__(threads_for<T>)
ups2x_dw_kernel(const T* __restrict__ xp, const T* __restrict__ g,
                float* __restrict__ partial, float* __restrict__ dwall,
                unsigned int* __restrict__ counters, int N, int H, int W,
                int Cin, int Cout, int units_per_slice) {
  if constexpr (kTC<T>)
    dw_tensor_core<TS>(xp, g, partial, dwall, counters, N, H, W, Cin, Cout,
                       units_per_slice);
  else
    dw_cuda_core<TS>(xp, g, partial, dwall, counters, N, H, W, Cin, Cout,
                     units_per_slice);
}

// ---- launches --------------------------------------------------------------

// Dynamic shared memory of a tensor-core kernel (none for the f32 bodies,
// whose tiles are static), raised past the 48 KB default where needed.
template <class Kernel>
cudaError_t smem_for(Kernel kernel, int bytes) {
  if (bytes == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <class TL, typename T>
int fwd_launch(const void* xp, const void* w, void* out, int N, int H, int W,
               int Cin, int Cout, cudaStream_t stream) {
  const int bytes = kTC<T> ? FwdTC<TL>::SMEM : 0;
  const cudaError_t e = smem_for(ups2x_fwd_kernel<TL, T>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ups2x_fwd_kernel<TL, T>
      <<<grid_for<TL>(N, H, W, Cout), threads_for<T>, bytes, stream>>>(
          static_cast<const T*>(xp), static_cast<const T*>(w),
          static_cast<T*>(out), N, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <class TL, typename T>
int dx_launch(const void* g, const void* w, float* dxp, int N, int H, int W,
              int Cin, int Cout, cudaStream_t stream) {
  const int bytes = kTC<T> ? DxTC<TL>::SMEM : 0;
  const cudaError_t e = smem_for(ups2x_dx_kernel<TL, T>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ups2x_dx_kernel<TL, T>
      <<<grid_for<TL>(N, H + 2, W + 2, Cin), threads_for<T>, bytes, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(w), dxp, N, H, W,
          Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

// The dwall grid: blocks of (ci, co) (bf16: of (phase, ci, co)) x slices of
// the (frame, tile) sequence, enough CTAs to fill the card.
int dw_blocks(bool tensor_core, int Cin, int Cout) {
  const int co = (Cout + OCB - 1) / OCB;
  return tensor_core ? 4 * ((Cin + WCI - 1) / WCI) * co
                     : ((Cin + DWB - 1) / DWB) * co;
}

int dw_slices(bool tensor_core, int N, int H, int W, int Cin, int Cout) {
  const int blocks = dw_blocks(tensor_core, Cin, Cout), units = dw_units(N, H, W);
  const int target = tensor_core ? DW_TC_TARGET : DW_TARGET;
  const int want = (target + blocks - 1) / blocks;
  return want < units ? want : units;
}

template <int TS, typename T>
int dw_launch(const void* xp, const void* g, float* partial, float* dwall,
              unsigned int* counters, int N, int H, int W, int Cin, int Cout,
              cudaStream_t stream) {
  const int bytes = kTC<T> ? DwTC<TS>::SMEM : 0;
  const cudaError_t e = smem_for(ups2x_dw_kernel<TS, T>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int units = dw_units(N, H, W);
  const int slices = dw_slices(kTC<T>, N, H, W, Cin, Cout);
  const dim3 grid(dw_blocks(kTC<T>, Cin, Cout), slices);
  ups2x_dw_kernel<TS, T><<<grid, threads_for<T>, bytes, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(g), partial, dwall,
      counters, N, H, W, Cin, Cout, (units + slices - 1) / slices);
  return static_cast<int>(cudaGetLastError());
}

// LAUNCH<tile for an Hd x Wd domain, T>(args...)
#define UPS2X_DISPATCH(T, Hd, Wd, LAUNCH, ...)                                \
  ((Hd) <= 4 && (Wd) <= 4 ? LAUNCH<TileSmall, T>(__VA_ARGS__)                 \
   : (Wd) <= 8            ? LAUNCH<TileMid, T>(__VA_ARGS__)                   \
                          : LAUNCH<TileBig, T>(__VA_ARGS__))

bool bad_shape(int N, int H, int W, int Cin, int Cout) {
  return N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32 (CUDA-core
// bodies), 1 = bfloat16 (tensor-core bodies). Each launching function makes
// ONE launch on `stream` (a cudaStream_t) and returns cudaGetLastError()
// right after it (0 = launched).
extern "C" {

// K5a: out (N, 2H, 2W, Cout) from xp (N, H+2, W+2, Cin) and w: wall
// (4Cin, 4Cout) for float32, its transpose wall_t (4Cout, 4Cin) for
// bfloat16.
int ups2x_fwd(int dtype, int device, const void* xp, const void* w,
              void* out, int N, int H, int W, int Cin, int Cout, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bad_shape(N, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return UPS2X_DISPATCH(float, H, W, fwd_launch, xp, w, out, N, H, W, Cin,
                          Cout, s);
  if (dtype == 1)
    return UPS2X_DISPATCH(bf16, H, W, fwd_launch, xp, w, out, N, H, W, Cin,
                          Cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5b, first launch: dxp (N, H+2, W+2, Cin) f32 from g (N, 2H, 2W, Cout)
// and w: wall_t (4Cout, 4Cin) for float32, wall (4Cin, 4Cout) for bfloat16.
int ups2x_bwd_dx(int dtype, int device, const void* g, const void* w,
                 float* dxp, int N, int H, int W, int Cin, int Cout,
                 void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bad_shape(N, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return UPS2X_DISPATCH(float, H + 2, W + 2, dx_launch, g, w, dxp, N, H, W,
                          Cin, Cout, s);
  if (dtype == 1)
    return UPS2X_DISPATCH(bf16, H + 2, W + 2, dx_launch, g, w, dxp, N, H, W,
                          Cin, Cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5b, second launch: dwall (4Cin, 4Cout) f32 from xp and g. `partial` is
// f32 scratch of ups2x_dw_slices() x 16*Cin*Cout elements, `counters`
// ups2x_dw_blocks() unsigned ints that are ZERO at the launch.
int ups2x_bwd_dw(int dtype, int device, const void* xp, const void* g,
                 float* partial, float* dwall, void* counters, int N, int H,
                 int W, int Cin, int Cout, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bad_shape(N, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  const bool small = dw_tile(H, W) == 4;
  if (dtype == 0)
    return small ? dw_launch<4, float>(xp, g, partial, dwall, cnt, N, H, W, Cin,
                                       Cout, s)
                 : dw_launch<8, float>(xp, g, partial, dwall, cnt, N, H, W, Cin,
                                       Cout, s);
  if (dtype == 1)
    return small ? dw_launch<4, bf16>(xp, g, partial, dwall, cnt, N, H, W, Cin,
                                      Cout, s)
                 : dw_launch<8, bf16>(xp, g, partial, dwall, cnt, N, H, W, Cin,
                                      Cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dwall launch's grid for `dtype`: blocks, and slices of the reduction.
int ups2x_dw_blocks(int dtype, int Cin, int Cout) {
  return dw_blocks(dtype == 1, Cin, Cout);
}

int ups2x_dw_slices(int dtype, int N, int H, int W, int Cin, int Cout) {
  return dw_slices(dtype == 1, N, H, W, Cin, Cout);
}

const char* ups2x_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
