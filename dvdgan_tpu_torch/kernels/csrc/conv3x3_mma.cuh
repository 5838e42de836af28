// The bf16 body of the ConvGRU sequence kernels, K1 (convgru_seq.cu: gate
// and candidate launch) and K2 (convgru_bwd.cu: gate, candidate, drh and dh
// launch): a SAME 3x3 conv as an implicit GEMM on the tensor cores, with an
// elementwise epilogue per output. f32 keeps the CUDA-core body of
// conv3x3_tile.cuh (the parity mode: f32 operands on the tensor cores would
// mean TF32).
//
// GEMM view of one launch, one time step:
//   M = B*H*W pixels, the batch folded in (b, y, x);
//   N = Cout (2C for the gate; C for the candidate, drh and dh launches);
//   K = 9 taps x Cin (C; 2C for dh), walked as k-steps of one tap of a
//       chunk of KC = 16 input channels, chunk-major: k = 9 * chunk + tap.
//   A[(b, y, x), (tap, ci)] = src[b, y + dy - 1, x + dx - 1, ci] (zero
//       outside the plane: a halo never reads another batch element);
//   B[(tap, ci), co] = w[dy, dx, ci, co], the HWIO weights as they are:
//       k-major rows, read with ldmatrix.trans (no transposed copy).
//
// A CTA owns a pixel tile (TF frames x TH x TW: small planes fold batch
// elements into it), BN output channels and a slice of the k-steps: grid =
// (pixel tiles, channel blocks, slices). Per chunk it stages, with cp.async
// (16-byte copies, zero-filled past an edge; plain loads where a channel
// count is not a multiple of 8), the tile's (TH+2) x (TW+2) patch of each
// frame and the slice's taps of the weight rows; 3-5 chunks are in
// flight. One staged patch serves all nine taps: each lane hands ldmatrix
// the row address of its pixel shifted by the tap. Four warps, 2 (pixels)
// x 2 (channels); bf16 operands, f32 accumulators on mma.sync.m16n8k16.
// Each chunk's sums are promoted into f32 totals with plain adds: one
// accumulator over hundreds of mmas drifts from round-to-nearest sums
// (K5b, ups2x_fused.cu).
//
// Split K: where the pixel tiles x channel blocks of a launch are fewer
// than the card's 132 SMs (the 4x4 and 8x8 planes: 32-1024 pixels a step;
// a few larger steps at 128-pixel tiles), the plan (kernels/convgru_seq.py:
// plan) cuts the k-steps into slices so that the launch has at least 132
// CTAs, each reading its part of the weights once per pixel tile. Each
// slice writes its f32 partial sums to a workspace; the last CTA of a tile
// to finish (a counter per tile, which it resets for the next launch) adds
// them in slice order and runs the epilogue: the same bits on every run,
// no float atomics and no extra launch. Slice s takes k-steps
// [s * ksteps / S, (s + 1) * ksteps / S).
//
// The epilogue sees each output once, as f32, in two calls: in =
// epi.load(q, b, p, n) reads what the output needs besides the conv's sum
// (the gate or candidate inputs, the saved scratch), epi.store(q, n, in, a)
// computes and writes it; q is the pixel's index in the step's (B, H, W)
// plane, b its batch element, p its index in that element's (H, W) plane,
// n the output channel and a the conv's sum. A thread loads for a group of
// outputs before it stores any, so that the loads are in flight together.

#pragma once

#include "conv3x3_tile.cuh"
#include "mma_bf16.cuh"

namespace convgru_tc {
// internal linkage: each library that includes this header keeps its own
// instances (two of them are loaded in one process)
namespace {

using bf16 = __nv_bfloat16;
using convgru::from_f;
using convgru::to_f;

constexpr int NT = 128;          // threads per CTA: four warps
constexpr int KC = 16;           // input channels a chunk (one mma k-step)
constexpr int LDA = KC + 8;      // the patch's row stride: 48 B
constexpr int TAPS = 9;

// A CTA's tile: TF frames x TH x TW pixels, BN output channels, STAGES
// chunks in flight. A warp owns half the pixels (MT m-tiles of 16) and half
// the channels (NTL n-tiles of 8). Shared memory per stage: the patch
// (A_ROWS rows of KC channels) and the weight rows of the nine taps (B_ROWS
// rows of BN channels), each with a row stride that is an odd multiple of
// 16 bytes (conflict-free ldmatrix). After the main loop the same memory
// holds the tile's f32 sums (row stride LDS) for the epilogue.
template <int TF_, int TH_, int TW_, int BN_, int STAGES_>
struct MmaTile {
  static constexpr int TF = TF_, TH = TH_, TW = TW_, BN = BN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int BM = TF * TH * TW;
  static constexpr int MT = BM / 32;
  static constexpr int NTL = BN / 16;
  static constexpr int HH = TH + 2, HW = TW + 2;
  static constexpr int A_ROWS = TF * HH * HW;
  static constexpr int LDB = BN + 8;
  static constexpr int B_ROWS = TAPS * KC;
  static constexpr int STAGE = A_ROWS * LDA + B_ROWS * LDB;   // elements
  static constexpr int SMEM = STAGES * STAGE * 2;             // bytes
  static constexpr int LDS = BN + 4;
  static_assert(BM % 32 == 0 && BN % 32 == 0,
                "2 x 2 warps of whole m-tiles and n-tile pairs");
  static_assert(SMEM <= 227 * 1024, "one CTA's shared memory");
  static_assert(BM * LDS * 4 <= SMEM, "the sums fit the stages");
};

// The tiles, by the index the plan passes (kernels/convgru_seq.py:
// MMA_TILES holds the same table). Small steps (B*H*W*C up to 2^17) take
// 32-pixel tiles (4x4 planes: two frames; else 4x8) with 32 channels, five
// stages deep (their slices are latency-bound); larger steps two 8x8
// frames or 8x16 pixels with 64 channels, three stages (two CTAs an SM).
using TileS4 = MmaTile<2, 4, 4, 32, 5>;
using TileS8 = MmaTile<1, 4, 8, 32, 5>;
using TileP8 = MmaTile<2, 8, 8, 64, 3>;
using TileW = MmaTile<1, 8, 16, 64, 3>;

template <class TL>
inline int m_tiles(int B, int H, int W) {
  return ((B + TL::TF - 1) / TL::TF) * ((H + TL::TH - 1) / TL::TH) *
         ((W + TL::TW - 1) / TL::TW);
}

// The CTA's first frame, row and column (blockIdx.x), and pixel m of its
// tile as (frame, row, column) within it.
template <class TL>
struct TileAt {
  int f0, y0, x0;
  __device__ TileAt(int H, int W) {
    const int tiles_x = (W + TL::TW - 1) / TL::TW;
    const int tiles_y = (H + TL::TH - 1) / TL::TH;
    int bx = blockIdx.x;
    x0 = (bx % tiles_x) * TL::TW;
    bx /= tiles_x;
    y0 = (bx % tiles_y) * TL::TH;
    f0 = (bx / tiles_y) * TL::TF;
  }
  static __device__ void pixel(int m, int& f, int& y, int& x) {
    x = m % TL::TW;
    y = (m / TL::TW) % TL::TH;
    f = m / (TL::TW * TL::TH);
  }
};

// src (B, H, W, Cin) contiguous, w (3, 3, Cin, Cout) contiguous. work: f32
// scratch of slices x B*H*W x Cout and counters: one per (pixel tile,
// channel block), zero at the first launch; both unused with one slice.
// grid: (m_tiles<TL>, ceil(Cout / BN), slices).
template <class TL, class Epi>
__global__ void __launch_bounds__(NT)
conv3x3_mma_kernel(const bf16* __restrict__ src, const bf16* __restrict__ w,
                   int B, int H, int W, int Cin, int Cout, int ksteps,
                   float* __restrict__ work,
                   unsigned int* __restrict__ counters, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const TileAt<TL> at(H, W);
  const int n0 = blockIdx.y * TL::BN;
  const int slices = gridDim.z, slice = blockIdx.z;
  const int k0 = (int)((int64_t)slice * ksteps / slices);
  const int k1 = (int)((int64_t)(slice + 1) * ksteps / slices);
  const int c_first = k0 / TAPS;
  const int steps = (k1 - 1) / TAPS - c_first + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * (TL::BM / 2), wn = (warp & 1) * (TL::BN / 2);
  const bool vec_a = Cin % 8 == 0 && tc::aligned16(src);
  const bool vec_b = Cout % 8 == 0 && tc::aligned16(w);

  // ldmatrix rows of this lane: A, its pixel (lane % 16 of the m-tile) in
  // the patch, channels + 8 for lanes 16-31; B (.trans), k-row lane % 8
  // (+ 8 for lanes 8-15 and 24-31), channels + 8 for lanes 16-31
  int a_row[TL::MT];
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt) {
    int f, y, x;
    TileAt<TL>::pixel(wm + 16 * mt + (lane & 15), f, y, x);
    a_row[mt] = ((f * TL::HH + y) * TL::HW + x) * LDA + (lane >> 4) * 8;
  }
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * TL::LDB + wn +
                    (lane >> 4) * 8;

  float acc[TL::MT][TL::NTL][4];
  tc::zero(acc);

  // the taps [t0, t1) of chunk c that lie in this slice
  auto taps_of = [&](int c, int& t0, int& t1) {
    t0 = max(k0 - c * TAPS, 0);
    t1 = min(k1 - c * TAPS, TAPS);
  };
  auto load = [&](int step, int buf) {
    const int c = c_first + step, ci0 = c * KC;
    int t0, t1;
    taps_of(c, t0, t1);
    bf16* as = smem + buf * TL::STAGE;
    bf16* bs = as + TL::A_ROWS * LDA;
    tc::stage_rows<NT, KC, LDA>(as, TL::A_ROWS, Cin - ci0, vec_a, src,
                                [&](int r) -> const bf16* {
      const int xx = r % TL::HW, yy = (r / TL::HW) % TL::HH;
      const int b = at.f0 + r / (TL::HW * TL::HH);
      const int y = at.y0 + yy - 1, x = at.x0 + xx - 1;
      return b < B && y >= 0 && y < H && x >= 0 && x < W
                 ? src + (((int64_t)b * H + y) * W + x) * Cin + ci0
                 : nullptr;
    });
    tc::stage_rows<NT, TL::BN, TL::LDB>(bs + t0 * KC * TL::LDB,
                                        (t1 - t0) * KC, Cout - n0, vec_b, w,
                                        [&](int r) -> const bf16* {
      const int tap = t0 + r / KC, ci = ci0 + r % KC;
      return ci < Cin ? w + ((int64_t)tap * Cin + ci) * Cout + n0 : nullptr;
    });
  };
  auto compute = [&](int step, int buf) {
    int t0, t1;
    taps_of(c_first + step, t0, t1);
    const bf16* as = smem + buf * TL::STAGE;
    const bf16* bs = as + TL::A_ROWS * LDA;
    float part[TL::MT][TL::NTL][4];      // this chunk's sums
    tc::zero(part);
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      if (tap < t0 || tap >= t1) continue;
      const int shift = ((tap / 3) * TL::HW + tap % 3) * LDA;
      uint32_t a[TL::MT][4];
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt)
        tc::ldmatrix_x4(a[mt], as + a_row[mt] + shift);
#pragma unroll
      for (int j = 0; j < TL::NTL / 2; ++j) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, bs + tap * KC * TL::LDB + b_off + 16 * j);
#pragma unroll
        for (int mt = 0; mt < TL::MT; ++mt) {
          tc::mma_16816(part[mt][2 * j], a[mt], b[0], b[1]);
          tc::mma_16816(part[mt][2 * j + 1], a[mt], b[2], b[3]);
        }
      }
    }
    tc::promote(acc, part);
  };
  tc::pipeline<TL::STAGES>(steps, load, compute);

  // pixel m of the tile in the step's plane, if it lies in it
  const int64_t plane = (int64_t)H * W;
  auto place = [&](int m, int64_t& q, int& b, int64_t& p) {
    int f, y, x;
    TileAt<TL>::pixel(m, f, y, x);
    b = at.f0 + f;
    y += at.y0;
    x += at.x0;
    if (b >= B || y >= H || x >= W) return false;
    p = (int64_t)y * W + x;
    q = b * plane + p;
    return true;
  };
  // The tile's sums go to shared memory (one slice) or to this slice's
  // part of the workspace; then the CTA that holds all of them (with more
  // than one slice, the last to finish) runs the epilogue.
  const int g = lane >> 2, t = lane & 3;
  const int64_t M = B * plane;
  float* sums_s = reinterpret_cast<float*>(smem_raw);
  float* mine = work + slice * M * Cout;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + 16 * mt + g + 8 * h;
      int64_t q, p;
      int b;
      const bool in_plane = place(m, q, b, p);
#pragma unroll
      for (int nt = 0; nt < TL::NTL; ++nt) {
        const int nl = wn + 8 * nt + 2 * t, n = n0 + nl;
        const float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (slices == 1) {
          *reinterpret_cast<float2*>(sums_s + m * TL::LDS + nl) = v;
        } else if (in_plane && Cout % 2 == 0 && n < Cout) {
          *reinterpret_cast<float2*>(mine + q * Cout + n) = v;
        } else if (in_plane) {
          if (n < Cout) mine[q * Cout + n] = v.x;
          if (n + 1 < Cout) mine[q * Cout + n + 1] = v.y;
        }
      }
    }
  if (slices == 1)
    __syncthreads();
  else if (!tc::last_to_arrive(
               counters + blockIdx.y * gridDim.x + blockIdx.x, slices))
    return;

  // The epilogue: a thread takes 4 neighbouring channels of a pixel (the
  // threads of a warp neighbouring quads), G quads at a time, and reads
  // every input of the group (the epilogue's, the slices' partial sums in
  // order) before it writes any, so that the loads are in flight together.
  constexpr int V = 4, G = 4, QN = TL::BN / V, UNITS = TL::BM * QN;
  const bool quads = Cout % V == 0;
  auto partial = [&](int s, int64_t q, int n, float (&out)[V]) {
    const float* src4 = work + (s * M + q) * Cout + n;
    if (quads) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src4));
      out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = n + v < Cout ? __ldcg(src4 + v) : 0.f;
    }
  };
  for (int u0 = threadIdx.x; u0 < UNITS; u0 += G * NT) {
    int64_t q[G], p[G];
    int b[G], nq[G];
    bool ok[G];
    typename Epi::In in[G][V];
    float sum[G][V];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int u = u0 + i * NT, m = u / QN, nl = (u % QN) * V;
      nq[i] = n0 + nl;
      ok[i] = u < UNITS && nq[i] < Cout && place(m, q[i], b[i], p[i]);
      if (!ok[i]) continue;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (nq[i] + v < Cout) in[i][v] = epi.load(q[i], b[i], p[i], nq[i] + v);
      if (slices == 1) {
        const float4 s4 =
            *reinterpret_cast<const float4*>(sums_s + m * TL::LDS + nl);
        sum[i][0] = s4.x, sum[i][1] = s4.y, sum[i][2] = s4.z, sum[i][3] = s4.w;
      } else {
        partial(0, q[i], nq[i], sum[i]);
      }
    }
#pragma unroll 2
    for (int s = 1; s < slices; ++s) {
      float part[G][V];
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (ok[i]) partial(s, q[i], nq[i], part[i]);
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (ok[i]) sum[i][v] += part[i][v];
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (ok[i] && nq[i] + v < Cout)
          epi.store(q[i], nq[i] + v, in[i][v], sum[i][v]);
  }
}

// One launch of the tile TL. Returns the CUDA error code (0 = launched).
template <class TL, class Epi>
int launch_tile(const bf16* src, const bf16* w, int B, int H, int W, int Cin,
                int Cout, int slices, float* work, unsigned int* counters,
                const Epi& epi, cudaStream_t stream) {
  const int ksteps = TAPS * ((Cin + KC - 1) / KC);
  if (slices < 1 || slices > ksteps ||
      (slices > 1 && (work == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv3x3_mma_kernel<TL, Epi>;
  // more than the default 48 KB of shared memory: allowed once per device
  // (this library's own flag: the header's names have internal linkage)
  static unsigned long long raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 64 && !(raised >> dev & 1ull)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e == cudaSuccess) raised |= 1ull << dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(m_tiles<TL>(B, H, W), (Cout + TL::BN - 1) / TL::BN, slices);
  kernel<<<grid, NT, TL::SMEM, stream>>>(src, w, B, H, W, Cin, Cout, ksteps,
                                         work, counters, epi);
  return static_cast<int>(cudaGetLastError());
}

// LAUNCH<tile>(args...) for the tile index the plan chose.
template <class Epi>
int conv3x3_mma(int tile, const void* src, const void* w, int B, int H,
                int W, int Cin, int Cout, int slices, float* work,
                void* counters, const Epi& epi, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* s = static_cast<const bf16*>(src);
  const bf16* wt = static_cast<const bf16*>(w);
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  switch (tile) {
    case 0: return launch_tile<TileS4>(s, wt, B, H, W, Cin, Cout, slices,
                                       work, cnt, epi, stream);
    case 1: return launch_tile<TileS8>(s, wt, B, H, W, Cin, Cout, slices,
                                       work, cnt, epi, stream);
    case 2: return launch_tile<TileP8>(s, wt, B, H, W, Cin, Cout, slices,
                                       work, cnt, epi, stream);
    case 3: return launch_tile<TileW>(s, wt, B, H, W, Cin, Cout, slices,
                                      work, cnt, epi, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile table as the kernels see it: {TF, TH, TW, BN, STAGES, shared
// memory bytes} of tile `tile` (a test holds the plan's copy to it).
inline int tile_info(int tile, int* out) {
  auto fill = [&](auto tl) {
    using TL = decltype(tl);
    out[0] = TL::TF;
    out[1] = TL::TH;
    out[2] = TL::TW;
    out[3] = TL::BN;
    out[4] = TL::STAGES;
    out[5] = TL::SMEM;
    return 0;
  };
  switch (tile) {
    case 0: return fill(TileS4{});
    case 1: return fill(TileS8{});
    case 2: return fill(TileP8{});
    case 3: return fill(TileW{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Gate epilogue (K1; K2's recompute with r): s = sigmoid(gx + gh) in f32;
// channels n < C give r: rh = r*h rounded to bf16 (and r in f32 where `r`
// is not null), the others z (f32).
struct GateEpi {
  const bf16* h;
  const bf16* gx;
  int64_t gx_bstride, gx_pix;
  bf16* rh;
  float* z;
  float* r;
  int C;
  struct In {
    float gx, h;
  };
  __device__ __forceinline__ In load(int64_t q, int b, int64_t p,
                                     int n) const {
    return {to_f(gx[b * gx_bstride + p * gx_pix + n]),
            n < C ? to_f(h[q * C + n]) : 0.f};
  }
  __device__ __forceinline__ void store(int64_t q, int n, const In& in,
                                        float a) const {
    const float s = 1.f / (1.f + expf(-(in.gx + a)));
    if (n < C) {
      const int64_t o = q * C + n;
      rh[o] = from_f<bf16>(s * in.h);
      if (r != nullptr) r[o] = s;
    } else {
      z[q * C + (n - C)] = s;
    }
  }
};

}  // namespace
}  // namespace convgru_tc
