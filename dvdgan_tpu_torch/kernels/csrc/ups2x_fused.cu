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
// these kernels' own bodies (CUDA-core FMAs; no cuDNN, no cuBLAS).
//
// The TPU kernel computes every phase at all (H+1)(W+1) positions (its MXU
// wants 4*Cout lanes), keeps a whole frame resident and sweeps rows. Here
// only the four useful phases of each source pixel are computed, 16*Cin*Cout
// MACs per source pixel, and the interleave is the store's address.
//
// K5a, ONE launch (ups2x_fwd_kernel): a CTA owns a tile of source pixels
// (TF frames x TH x TW: small planes fold frames into the tile so that every
// CTA has 128 pixels) and 32 output channels. It stages the (tile+2)^2 patch
// of xp and the 16 (tap, phase) weight slices for a chunk of 8 input
// channels in shared memory as f32; each thread accumulates 4 phases x 4
// pixels x 4 channels in registers and writes straight into the interleaved
// (N, 2H, 2W, Cout) tensor.
//
// K5b, TWO launches:
//  * ups2x_dx_kernel: dxp (N, H+2, W+2, Cin) in f32, in gather form (no
//    atomics). A padded pixel (r, s) reads the 4x4 window of g at rows
//    2r-dr, columns 2s-dc (dr, dc in 0..3; phase p = dr & 1, tap a = dr >> 1,
//    the same per column), so it is a stride-2 4x4 conv of g with the
//    transposed weights wall_t (4*Cout, 4*Cin), on the forward's tiles.
//  * ups2x_dw_kernel: dwall (4*Cin, 4*Cout) in f32,
//      dwall[(2a+b)Cin+ci, (2p+q)Cout+co] =
//          sum_{n,i,j} xp[n, i+p+a, j+q+b, ci] * g[n, 2i+p, 2j+q, co],
//    a reduction over N*H*W. The grid is (32x32 blocks of (ci, co)) x
//    (slices of the (frame, tile) sequence); a CTA stages an xp patch and a
//    g patch per tile, each thread accumulates one phase's 4 taps x 4 ci x
//    4 co, and writes its partial sums to scratch. The LAST CTA of a block
//    to finish (a counter per block) adds the slices' partials in slice
//    order, so two runs give the same bits (no float atomics).
//
// What bounds them on the H100: operations. Each does 16*Cin*Cout MACs per
// source pixel on the CUDA cores, against Cin elements read and 4*Cout
// written (forward). wgmma/TMA are left for later work.
//
// Layouts: xp, out, g, dxp contiguous channels-last; wall, wall_t, dwall
// row-major.

#include "conv3x3_tile.cuh"

namespace {

using convgru::from_f;
using convgru::to_f;

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

// The CTA's place in a (frames, Hd, Wd) domain: blockIdx.x = (frame group,
// tile row, tile column), blockIdx.y = channel block.
template <class TL>
struct Place {
  int n0, y0, x0, c0;
  int f, py, px0, og;     // this thread's frame, row, first column, channels
  __device__ Place(int Hd, int Wd) {
    const int tiles_x = (Wd + TL::TW - 1) / TL::TW;
    const int tiles_y = (Hd + TL::TH - 1) / TL::TH;
    int bx = blockIdx.x;
    x0 = (bx % tiles_x) * TL::TW;
    bx /= tiles_x;
    y0 = (bx % tiles_y) * TL::TH;
    n0 = (bx / tiles_y) * TL::TF;
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

// ---- K5a -----------------------------------------------------------------

// grid: grid_for<TL>(N, H, W, Cout)
template <class TL, typename T>
__global__ void __launch_bounds__(NT)
ups2x_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wall,
                 T* __restrict__ out, int N, int H, int W, int Cin, int Cout) {
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
        if (oc < Cout)
          out[(orow + 2 * j + ph % 2) * Cout + oc] = from_f<T>(acc[ph][px][k]);
      }
    }
  }
}

// ---- K5b: dxp ------------------------------------------------------------

// grid: grid_for<TL>(N, H + 2, W + 2, Cin)
template <class TL, typename T>
__global__ void __launch_bounds__(NT)
ups2x_dx_kernel(const T* __restrict__ g, const T* __restrict__ wall_t,
                float* __restrict__ dxp, int N, int H, int W, int Cin,
                int Cout) {
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

// ---- K5b: dwall ----------------------------------------------------------

constexpr int DWB = 32;           // a CTA's block of ci and of co
constexpr int DW_TARGET = 264;    // CTAs a launch aims at: two per SM

inline int dw_tile(int H, int W) { return H <= 4 && W <= 4 ? 4 : 8; }

inline int dw_blocks(int Cin, int Cout) {
  return ((Cin + DWB - 1) / DWB) * ((Cout + DWB - 1) / DWB);
}

inline int dw_units(int N, int H, int W) {
  const int t = dw_tile(H, W);
  return N * ((H + t - 1) / t) * ((W + t - 1) / t);
}

inline int dw_slices(int N, int H, int W, int Cin, int Cout) {
  const int blocks = dw_blocks(Cin, Cout), units = dw_units(N, H, W);
  const int want = (DW_TARGET + blocks - 1) / blocks;
  return want < units ? want : units;
}

// grid: (dw_blocks, slices). Thread = (phase, 4 ci, 4 co); tile TS x TS
// source pixels of one frame per step of the CTA's loop.
template <int TS, typename T>
__global__ void __launch_bounds__(NT)
ups2x_dw_kernel(const T* __restrict__ xp, const T* __restrict__ g,
                float* __restrict__ partial, float* __restrict__ dwall,
                unsigned int* __restrict__ counters, int N, int H, int W,
                int Cin, int Cout, int units_per_slice) {
  constexpr int XW = TS + 2, GWD = 2 * TS;
  constexpr int X_SMEM = XW * XW * DWB, G_SMEM = GWD * GWD * DWB;
  static_assert((X_SMEM + G_SMEM) * 4 + 16 <= 48 * 1024, "static smem limit");
  __shared__ __align__(16) float x_s[X_SMEM];  // [yy][xx][ci]
  __shared__ __align__(16) float g_s[G_SMEM];  // [yy][xx][co]
  __shared__ bool last;

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
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&counters[blockIdx.x], 1u) == (unsigned int)(slices - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
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

// ---- launches ------------------------------------------------------------

template <class TL, typename T>
int fwd_launch(const void* xp, const void* wall, void* out, int N, int H, int W,
               int Cin, int Cout, cudaStream_t stream) {
  ups2x_fwd_kernel<TL, T><<<grid_for<TL>(N, H, W, Cout), NT, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wall),
      static_cast<T*>(out), N, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <class TL, typename T>
int dx_launch(const void* g, const void* wall_t, float* dxp, int N, int H,
              int W, int Cin, int Cout, cudaStream_t stream) {
  ups2x_dx_kernel<TL, T><<<grid_for<TL>(N, H + 2, W + 2, Cin), NT, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wall_t), dxp, N, H, W,
      Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <int TS, typename T>
int dw_launch(const void* xp, const void* g, float* partial, float* dwall,
              unsigned int* counters, int N, int H, int W, int Cin, int Cout,
              int slices, cudaStream_t stream) {
  const int units = dw_units(N, H, W);
  const dim3 grid(dw_blocks(Cin, Cout), slices);
  ups2x_dw_kernel<TS, T><<<grid, NT, 0, stream>>>(
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

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each launching function makes ONE launch on `stream` (a cudaStream_t) and
// returns cudaGetLastError() right after it (0 = launched).
extern "C" {

// K5a: out (N, 2H, 2W, Cout) from xp (N, H+2, W+2, Cin), wall (4Cin, 4Cout).
int ups2x_fwd(int dtype, int device, const void* xp, const void* wall,
              void* out, int N, int H, int W, int Cin, int Cout, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bad_shape(N, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return UPS2X_DISPATCH(float, H, W, fwd_launch, xp, wall, out, N, H, W, Cin,
                          Cout, s);
  if (dtype == 1)
    return UPS2X_DISPATCH(__nv_bfloat16, H, W, fwd_launch, xp, wall, out, N, H,
                          W, Cin, Cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5b, first launch: dxp (N, H+2, W+2, Cin) f32 from g (N, 2H, 2W, Cout) and
// wall_t (4Cout, 4Cin), the transpose of wall.
int ups2x_bwd_dx(int dtype, int device, const void* g, const void* wall_t,
                 float* dxp, int N, int H, int W, int Cin, int Cout,
                 void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bad_shape(N, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return UPS2X_DISPATCH(float, H + 2, W + 2, dx_launch, g, wall_t, dxp, N, H,
                          W, Cin, Cout, s);
  if (dtype == 1)
    return UPS2X_DISPATCH(__nv_bfloat16, H + 2, W + 2, dx_launch, g, wall_t,
                          dxp, N, H, W, Cin, Cout, s);
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
  const int slices = dw_slices(N, H, W, Cin, Cout);
  const bool small = dw_tile(H, W) == 4;
  if (dtype == 0)
    return small ? dw_launch<4, float>(xp, g, partial, dwall, cnt, N, H, W, Cin,
                                       Cout, slices, s)
                 : dw_launch<8, float>(xp, g, partial, dwall, cnt, N, H, W, Cin,
                                       Cout, slices, s);
  if (dtype == 1)
    return small ? dw_launch<4, __nv_bfloat16>(xp, g, partial, dwall, cnt, N, H,
                                               W, Cin, Cout, slices, s)
                 : dw_launch<8, __nv_bfloat16>(xp, g, partial, dwall, cnt, N, H,
                                               W, Cin, Cout, slices, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dwall launch's grid: blocks of (ci, co), and slices of the reduction.
int ups2x_dw_blocks(int Cin, int Cout) { return dw_blocks(Cin, Cout); }

int ups2x_dw_slices(int N, int H, int W, int Cin, int Cout) {
  return dw_slices(N, H, W, Cin, Cout);
}

const char* ups2x_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
