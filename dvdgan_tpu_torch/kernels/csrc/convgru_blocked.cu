// Spatially blocked whole-sequence ConvGRU forward (K3) for Hopper (sm_90a).
//
// Replaces dvdgan_tpu/kernels/convgru_blocked.py:_blocked_pallas (the
// function behind gru_sequence_blocked), the forward for the large planes of
// the generator (64x64x128 and 128x128x64 at 256 px, 64x64x64 at 128 px;
// ops/convgru.py draws the line between K1 and K3). It computes K1's
// function with K1's rounding points (convgru_seq.cu):
//
//   gh = conv3x3(h, wg)                  f32 sums; gx added in f32
//   r, z = sigmoid(gx + gh)              f32
//   rh = r * h                           f32, rounded to the activation type
//   ch = conv3x3(rh, wc)                 f32 sums
//   h' = (1 - z) h + z tanh(cx + ch)     f32, rounded once
//
// ONE launch per time step, driven by a host loop over T on the caller's
// stream. The TPU kernel sweeps the plane twice per step (a gate phase that
// writes r*h and z planes, then a candidate phase that reads r*h with
// halos), because a block's candidate conv needs its neighbours' r*h and a
// sequential grid can wait for them. CUDA blocks cannot wait for each other,
// so here a CTA owns one batch element x one TH x TW spatial tile and ALL C
// channels of it, and computes what it needs of its neighbours itself:
//   stage A: r on the tile plus a one-pixel rim (the gate conv's reset half,
//            read from h with a two-pixel halo), and r*h, rounded, into
//            shared memory for all C channels (zero outside the plane: the
//            candidate conv's SAME padding, and a rim never reads the
//            neighbouring frame);
//   stage B: per block of output channels, the update half of the gate conv
//            (from h) and the candidate conv (from the r*h tile in shared
//            memory) into two register accumulators, then the blend, and h'
//            is written. r*h and z never reach device memory.
// A rim pixel's r is the r its owner computes, bit for bit: every pixel's
// sums run through the same k order, and an mma's per-element order does not
// depend on the row's place in the tile. So the output has the same bits
// under every tile.
//
// What bounds it on the H100: operations. Per pixel and step the convs do
// 9*C*3C MACs, plus 9*C*C on the rim (the reset half costs (TH+2)(TW+2) /
// (TH*TW) of itself: 1.56x at 8x8, 1.41x at 8x16, 1.27x at 16x16), against
// 3C + C + C elements read and C written: ~100x more operations per byte
// than the card's balance point. The weights (27 C^2 elements, 885 KB at C
// 128) are re-read from L2 by every CTA each step, so larger tiles read
// them less often; but a CTA must hold r*h for all C channels, so channels
// cannot be split across CTAs, and a larger tile means fewer CTAs.
//
// bf16 (tensor cores): both convs are implicit GEMMs on mma.sync.m16n8k16
// (bf16 operands, f32 sums; the helpers of mma_bf16.cuh). A CTA of eight
// warps stages its tile's (TH+4) x (TW+4) h patch with all C channels once
// (cp.async), and keeps it and the (TH+2) x (TW+2) r*h tile in shared
// memory at a row stride of C + 8 (an odd multiple of 16 bytes: ldmatrix
// without bank conflicts), so neither is staged again; only the weights
// stream through a 3-stage cp.async pipeline (per stage one 16-channel
// chunk of the 9 taps' rows, BN output channels, read with ldmatrix.trans
// as in conv3x3_mma.cuh). GEMM view per step of a CTA:
//   stage A: M = the rim region's (TH+2)(TW+2) pixels in m-tiles of 16 (the
//            last one padded), N = the C reset channels in blocks of BN,
//            K = 9 taps x C (chunk-major: k = 9 * chunk + tap);
//   stage B: M = the TH x TW pixels; per block of BN channels two GEMMs of
//            the same K, the update half (A = the h patch shifted by one
//            pixel) and the candidate (A = the r*h tile), one after the
//            other into two accumulators.
// Each chunk's nine mmas are summed in a fresh tile and promoted into f32
// totals with plain adds (K1's order). Epilogues work on the fragments in
// registers: gx/cx/h loads of a thread's outputs are issued before any
// store, pairs of channels as bf16x2. The tile (8x8, 8x16 or 16x16, each
// with its warp layout) is chosen per shape by kernels/convgru_blocked.py:
// plan; `tools/torch_k3_tiles.py` times each at the driven shapes.
//
// f32 (parity mode: f32 operands on the tensor cores would mean TF32): the
// CUDA-core body on conv3x3_tile.cuh, an 8 x 8 tile; phase A maps 240 of the
// CTA's 256 threads onto a (TH+2) x (TW+4) region (the rim, its width
// rounded up to the threads' 4-pixel groups).
//
// Layouts: h_prev and h_out planes are contiguous (B, H, W, C) and must not
// alias (neighbouring CTAs read h_prev's halo); gx/cx are read at pixel
// stride `pix` and batch stride `bstride` (the hoisted input conv's channel
// slices), as in K1.

#include "conv3x3_tile.cuh"
#include "mma_bf16.cuh"

namespace {

// dynamic shared memory a CTA may ask for on sm_90 (227 KB)
constexpr int MAX_SMEM = 232448;

// ------------------------------------------------------------------------
// f32: the CUDA-core body
namespace f32body {

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

size_t smem_bytes(int C) {
  return (size_t)(IN_S + W_S) * sizeof(float) + (size_t)RH * RW * C * sizeof(float);
}

// grid: (tiles_y * tiles_x, B); two CTAs per SM.
__global__ void __launch_bounds__(NT, 2)
blocked_step_kernel(const float* __restrict__ h_prev,
                    const float* __restrict__ gx, int64_t gx_bstride,
                    int64_t gx_pix, const float* __restrict__ cx,
                    int64_t cx_bstride, int64_t cx_pix,
                    const float* __restrict__ wg,
                    const float* __restrict__ wc, float* __restrict__ h_out,
                    int H, int W, int C) {
  using T = float;
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

int launch(const float* h_prev, const float* gx, int64_t gx_bstride,
           int64_t gx_pix, const float* cx, int64_t cx_bstride,
           int64_t cx_pix, const float* wg, const float* wc, float* h_out,
           int B, int H, int W, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  if (smem > (size_t)MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), B);
  const cudaError_t e = cudaFuncSetAttribute(
      blocked_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  blocked_step_kernel<<<grid, NT, smem, stream>>>(
      h_prev, gx, gx_bstride, gx_pix, cx, cx_bstride, cx_pix, wg, wc, h_out,
      H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32body

// ------------------------------------------------------------------------
// bf16: the tensor-core body
namespace bf16body {

using bf16 = __nv_bfloat16;
using convgru::blend;

constexpr int NT = 256;      // threads per CTA: eight warps
constexpr int KC = 16;       // input channels a chunk (one mma k-step)
constexpr int TAPS = 9;
constexpr int STAGES = 3;    // weight chunks in flight

// A CTA's tile: TH x TW output pixels; BN output channels per GEMM block.
// Stage A's warps form WMA (m-tiles, dealt round-robin) x 8/WMA (channels),
// stage B's WMB x 8/WMB; a warp holds MTW m-tiles x NTW n-tiles of 8.
template <int TH_, int TW_, int BN_, int WMA_, int WMB_>
struct BlkTile {
  static constexpr int TH = TH_, TW = TW_, BN = BN_;
  static constexpr int RH = TH + 2, RW = TW + 2;   // the rim region: r*h
  static constexpr int PH = TH + 4, PW = TW + 4;   // the h patch
  static constexpr int MA = RH * RW, MTA = (MA + 15) / 16;
  static constexpr int WMA = WMA_, MTWA = (MTA + WMA - 1) / WMA;
  static constexpr int NTWA = BN / 8 / (8 / WMA);
  static constexpr int MB = TH * TW, MTB = MB / 16;
  static constexpr int WMB = WMB_, MTWB = (MTB + WMB - 1) / WMB;
  static constexpr int NTWB = BN / 8 / (8 / WMB);
  static constexpr int LDB = BN + 8;               // weight row stride
  static constexpr int STAGE = TAPS * KC * LDB;    // elements
  static_assert(MB % 16 == 0 && 8 % WMA == 0 && 8 % WMB == 0, "warps");
  static_assert(NTWA % 2 == 0 && NTWB % 2 == 0, "n-tile pairs (ldmatrix x4)");
};

// The tiles, by the index the plan passes (kernels/convgru_blocked.py:
// TILES holds the same table).
using Tile8x8 = BlkTile<8, 8, 64, 4, 4>;
using Tile8x16 = BlkTile<8, 16, 64, 4, 4>;
using Tile16x16 = BlkTile<16, 16, 32, 8, 8>;

// Shared memory of a CTA at C channels: the h patch and the r*h tile at row
// stride ceil16(C) + 8, and the weight stages.
template <class TL>
size_t smem_bytes(int C) {
  const int ldh = (C + KC - 1) / KC * KC + 8;
  return ((size_t)(TL::PH * TL::PW + TL::RH * TL::RW) * ldh +
          (size_t)STAGES * TL::STAGE) * sizeof(bf16);
}

// acc += A x B over K = 9 taps x cin (chunk-major), for one warp: A's rows
// from a plane in shared memory AW pixels wide (row stride ldh), this lane's
// row of m-tile i at tap (0, 0) at a_row[i] (mt_ok[i]: the m-tile exists);
// B = the weight rows w + (tap * cin + ci) * ldw, columns [0, BN), zero at
// and past `left`, streamed through `stages`; the warp's n-tiles start at
// column wn0. All NT threads call it (the staging and barriers are the
// CTA's).
template <int BN, int AW, int MTW, int NTW>
__device__ __forceinline__ void gemm(const bf16* a, int ldh,
                                     const int (&a_row)[MTW],
                                     const bool (&mt_ok)[MTW], int wn0,
                                     const bf16* w, int ldw, int left,
                                     int cin, int nchunks, bool vec_b,
                                     bf16* stages, float (&acc)[MTW][NTW][4]) {
  constexpr int LDB = BN + 8, STAGE = TAPS * KC * LDB;
  const int lane = threadIdx.x & 31;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn0 +
                    (lane >> 4) * 8;
  auto load = [&](int step, int buf) {
    const int ci0 = step * KC;
    tc::stage_rows<NT, BN, LDB>(stages + buf * STAGE, TAPS * KC, left, vec_b,
                                w, [&](int r) -> const bf16* {
      const int tap = r / KC, ci = ci0 + r % KC;
      return ci < cin ? w + ((int64_t)tap * cin + ci) * ldw : nullptr;
    });
  };
  auto compute = [&](int step, int buf) {
    const bf16* bs = stages + buf * STAGE;
    float part[MTW][NTW][4];      // this chunk's sums
    tc::zero(part);
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int shift = ((tap / 3) * AW + tap % 3) * ldh + step * KC;
      uint32_t af[MTW][4];
#pragma unroll
      for (int i = 0; i < MTW; ++i)
        if (mt_ok[i]) tc::ldmatrix_x4(af[i], a + a_row[i] + shift);
#pragma unroll
      for (int j = 0; j < NTW / 2; ++j) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, bs + tap * KC * LDB + b_off + 16 * j);
#pragma unroll
        for (int i = 0; i < MTW; ++i)
          if (mt_ok[i]) {
            tc::mma_16816(part[i][2 * j], af[i], b[0], b[1]);
            tc::mma_16816(part[i][2 * j + 1], af[i], b[2], b[3]);
          }
      }
    }
    tc::promote(acc, part);
  };
  tc::pipeline<STAGES>(nchunks, load, compute);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}
// Channels n, n + 1 of a bf16 row as floats: one 4-byte load where `pair`
// (the address is 4-byte aligned), else n alone (n + 1 past C gives 0).
__device__ __forceinline__ float2 load2(const bf16* p, bool pair, bool two) {
  if (pair)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(__bfloat162float(p[0]),
                     two ? __bfloat162float(p[1]) : 0.f);
}

// grid: (tiles_y * tiles_x, B); one CTA an SM.
template <class TL>
__global__ void __launch_bounds__(NT, 1)
blocked_mma_kernel(const bf16* __restrict__ h_prev,
                   const bf16* __restrict__ gx, int64_t gx_bstride,
                   int64_t gx_pix, const bf16* __restrict__ cx,
                   int64_t cx_bstride, int64_t cx_pix,
                   const bf16* __restrict__ wg, const bf16* __restrict__ wc,
                   bf16* __restrict__ h_out, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cpad = (C + KC - 1) / KC * KC, ldh = cpad + 8;
  const int nchunks = cpad / KC;
  bf16* hp_s = reinterpret_cast<bf16*>(smem_raw);    // (PH, PW, ldh)
  bf16* rh_s = hp_s + TL::PH * TL::PW * ldh;         // (RH, RW, ldh)
  bf16* st_s = rh_s + TL::RH * TL::RW * ldh;         // STAGES x STAGE

  const int tiles_x = (W + TL::TW - 1) / TL::TW;
  const int y0 = (blockIdx.x / tiles_x) * TL::TH;
  const int x0 = (blockIdx.x % tiles_x) * TL::TW;
  const int64_t plane = (int64_t)blockIdx.y * H * W;
  const bf16* hb = h_prev + plane * C;
  const bf16* gxb = gx + (int64_t)blockIdx.y * gx_bstride;
  const bf16* cxb = cx + (int64_t)blockIdx.y * cx_bstride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool vec_b = C % 8 == 0 && tc::aligned16(wg) && tc::aligned16(wc);
  // gx, cx and h_out as channel pairs: even C and strides, aligned rows
  const bool pairs = C % 2 == 0 && gx_bstride % 2 == 0 && gx_pix % 2 == 0 &&
                     cx_bstride % 2 == 0 && cx_pix % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(gx) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(cx) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(h_out) & 3) == 0;

  // The h patch, (y0 - 2, x0 - 2) at its origin, all channels: zero outside
  // the plane and at channels C .. cpad. In flight until the first GEMM's
  // pipeline waits for its first chunk.
  {
    const bool vec = C % 8 == 0 && tc::aligned16(h_prev);
    const int cv = cpad / 8;
    for (int u = threadIdx.x; u < TL::PH * TL::PW * cv; u += NT) {
      const int r = u / cv, c = (u - r * cv) * 8;
      const int y = y0 - 2 + r / TL::PW, x = x0 - 2 + r % TL::PW;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const bf16* src = in ? hb + ((int64_t)y * W + x) * C + c : hb;
      bf16* dst = hp_s + r * ldh + c;
      if (vec) {
        tc::cp_async_16(dst, src, in && c < C);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = in && c + e < C ? src[e] : __float2bfloat16(0.f);
      }
    }
    tc::cp_async_commit();
  }

  // ---- stage A: r*h on the tile and its rim, all channels ---------------
  {
    const int wm = warp % TL::WMA;
    const int wn0 = (warp / TL::WMA) * TL::NTWA * 8;
    int a_row[TL::MTWA];
    bool ok[TL::MTWA];
    int mrow[TL::MTWA];
#pragma unroll
    for (int i = 0; i < TL::MTWA; ++i) {
      const int mt = wm + TL::WMA * i;
      ok[i] = mt < TL::MTA;
      mrow[i] = 16 * mt;
      int m = mrow[i] + (lane & 15);
      if (m >= TL::MA) m = 0;            // padding rows: read pixel 0
      a_row[i] = ((m / TL::RW) * TL::PW + m % TL::RW) * ldh + (lane >> 4) * 8;
    }
    for (int nb = 0; nb < cpad; nb += TL::BN) {
      float acc[TL::MTWA][TL::NTWA][4];
      tc::zero(acc);
      gemm<TL::BN, TL::PW>(hp_s, ldh, a_row, ok, wn0, wg + nb, 2 * C, C - nb,
                           C, nchunks, vec_b, st_s, acc);
      // r = sigmoid(gx_r + sum), rh = bf16(r * h). The h patch is zero
      // outside the plane and past C, so rh is too (gx is not read there).
      float2 gv[TL::MTWA][2][TL::NTWA];
#pragma unroll
      for (int i = 0; i < TL::MTWA; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = mrow[i] + g + 8 * hh;
          const int y = y0 - 1 + m / TL::RW, x = x0 - 1 + m % TL::RW;
          const bool in = ok[i] && m < TL::MA && y >= 0 && y < H && x >= 0 &&
                          x < W;
          const int64_t q = (int64_t)y * W + x;
#pragma unroll
          for (int j = 0; j < TL::NTWA; ++j) {
            const int n = nb + wn0 + 8 * j + 2 * t;
            gv[i][hh][j] = in && n < C
                               ? load2(gxb + q * gx_pix + n, pairs, n + 1 < C)
                               : make_float2(0.f, 0.f);
          }
        }
#pragma unroll
      for (int i = 0; i < TL::MTWA; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = mrow[i] + g + 8 * hh;
          if (!ok[i] || m >= TL::MA) continue;
          const int ry = m / TL::RW, rx = m % TL::RW;
          const bf16* hrow = hp_s + ((ry + 1) * TL::PW + rx + 1) * ldh;
          bf16* rrow = rh_s + (ry * TL::RW + rx) * ldh;
#pragma unroll
          for (int j = 0; j < TL::NTWA; ++j) {
            const int n = nb + wn0 + 8 * j + 2 * t;
            if (n >= cpad) continue;
            const float2 hv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(hrow + n));
            const float r0 = sigmoid(gv[i][hh][j].x + acc[i][j][2 * hh]);
            const float r1 = sigmoid(gv[i][hh][j].y + acc[i][j][2 * hh + 1]);
            *reinterpret_cast<__nv_bfloat162*>(rrow + n) =
                __floats2bfloat162_rn(r0 * hv.x, r1 * hv.y);
          }
        }
    }
  }
  __syncthreads();

  // ---- stage B: z and the candidate per block of channels, blend --------
  {
    const int wm = warp % TL::WMB;
    const int wn0 = (warp / TL::WMB) * TL::NTWB * 8;
    int a_h[TL::MTWB], a_r[TL::MTWB], mrow[TL::MTWB];
    bool ok[TL::MTWB];
#pragma unroll
    for (int i = 0; i < TL::MTWB; ++i) {
      const int mt = wm + TL::WMB * i;
      ok[i] = mt < TL::MTB;
      mrow[i] = 16 * mt;
      const int m = (ok[i] ? mrow[i] : 0) + (lane & 15);
      const int py = m / TL::TW, px = m % TL::TW;
      a_h[i] = ((py + 1) * TL::PW + px + 1) * ldh + (lane >> 4) * 8;
      a_r[i] = (py * TL::RW + px) * ldh + (lane >> 4) * 8;
    }
    for (int nb = 0; nb < C; nb += TL::BN) {
      float acc_z[TL::MTWB][TL::NTWB][4], acc_c[TL::MTWB][TL::NTWB][4];
      tc::zero(acc_z);
      tc::zero(acc_c);
      gemm<TL::BN, TL::PW>(hp_s, ldh, a_h, ok, wn0, wg + C + nb, 2 * C,
                           C - nb, C, nchunks, vec_b, st_s, acc_z);
      gemm<TL::BN, TL::RW>(rh_s, ldh, a_r, ok, wn0, wc + nb, C, C - nb, C,
                           nchunks, vec_b, st_s, acc_c);
      // the inputs of all this thread's outputs, then the blends
      float2 zv[TL::MTWB][2][TL::NTWB], cv[TL::MTWB][2][TL::NTWB];
#pragma unroll
      for (int i = 0; i < TL::MTWB; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = mrow[i] + g + 8 * hh;
          const int y = y0 + m / TL::TW, x = x0 + m % TL::TW;
          const bool in = ok[i] && y < H && x < W;
          const int64_t q = (int64_t)y * W + x;
#pragma unroll
          for (int j = 0; j < TL::NTWB; ++j) {
            const int n = nb + wn0 + 8 * j + 2 * t;
            const bool use = in && n < C;
            zv[i][hh][j] = use ? load2(gxb + q * gx_pix + C + n, pairs,
                                       n + 1 < C)
                               : make_float2(0.f, 0.f);
            cv[i][hh][j] = use ? load2(cxb + q * cx_pix + n, pairs, n + 1 < C)
                               : make_float2(0.f, 0.f);
          }
        }
#pragma unroll
      for (int i = 0; i < TL::MTWB; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = mrow[i] + g + 8 * hh;
          const int py = m / TL::TW, px = m % TL::TW;
          const int y = y0 + py, x = x0 + px;
          if (!ok[i] || y >= H || x >= W) continue;
          const bf16* hrow = hp_s + ((py + 2) * TL::PW + px + 2) * ldh;
          bf16* orow = h_out + (plane + (int64_t)y * W + x) * C;
#pragma unroll
          for (int j = 0; j < TL::NTWB; ++j) {
            const int n = nb + wn0 + 8 * j + 2 * t;
            if (n >= C) continue;
            const float2 hv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(hrow + n));
            const float z0 = sigmoid(zv[i][hh][j].x + acc_z[i][j][2 * hh]);
            const float z1 = sigmoid(zv[i][hh][j].y + acc_z[i][j][2 * hh + 1]);
            const float c0 = tanhf(cv[i][hh][j].x + acc_c[i][j][2 * hh]);
            const float c1 = tanhf(cv[i][hh][j].y + acc_c[i][j][2 * hh + 1]);
            const float o0 = blend(z0, hv.x, c0), o1 = blend(z1, hv.y, c1);
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(orow + n) =
                  __floats2bfloat162_rn(o0, o1);
            } else {
              orow[n] = __float2bfloat16_rn(o0);
              if (n + 1 < C) orow[n + 1] = __float2bfloat16_rn(o1);
            }
          }
        }
    }
  }
}

template <class TL>
int launch_tile(const bf16* h_prev, const bf16* gx, int64_t gx_bstride,
                int64_t gx_pix, const bf16* cx, int64_t cx_bstride,
                int64_t cx_pix, const bf16* wg, const bf16* wc, bf16* h_out,
                int B, int H, int W, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes<TL>(C);
  if (smem > (size_t)MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = blocked_mma_kernel<TL>;
  // the card's whole 227 KB allowed once per device (this library's flag)
  static unsigned long long raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 64 && !(raised >> dev & 1ull)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess) raised |= 1ull << dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((H + TL::TH - 1) / TL::TH) * ((W + TL::TW - 1) / TL::TW),
                  B);
  kernel<<<grid, NT, smem, stream>>>(h_prev, gx, gx_bstride, gx_pix, cx,
                                     cx_bstride, cx_pix, wg, wc, h_out, H, W,
                                     C);
  return static_cast<int>(cudaGetLastError());
}

// F(tile type) for the tile index the plan passes; -1 if there is none.
template <class F>
int64_t with_tile(int tile, F&& f) {
  switch (tile) {
    case 0: return f(Tile8x8{});
    case 1: return f(Tile8x16{});
    case 2: return f(Tile16x16{});
  }
  return -1;
}

}  // namespace bf16body
}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
extern "C" {

// ONE launch on `stream` (a cudaStream_t): h_out = GRU step of h_prev.
// `tile` indexes bf16body's tiles (the plan's choice; f32 has one tile).
// Returns the CUDA error code of the launch (0 = launched).
int convgru_blocked_step(int dtype, int device, const void* h_prev,
                         const void* gx, int64_t gx_bstride, int64_t gx_pix,
                         const void* cx, int64_t cx_bstride, int64_t cx_pix,
                         const void* wg, const void* wc, void* h_out, int B,
                         int H, int W, int C, int tile, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return f32body::launch(
        static_cast<const float*>(h_prev), static_cast<const float*>(gx),
        gx_bstride, gx_pix, static_cast<const float*>(cx), cx_bstride,
        cx_pix, static_cast<const float*>(wg), static_cast<const float*>(wc),
        static_cast<float*>(h_out), B, H, W, C, s);
  if (dtype == 1) {
    using bf16body::bf16;
    const int64_t r = bf16body::with_tile(tile, [&](auto tl) -> int64_t {
      return bf16body::launch_tile<decltype(tl)>(
          static_cast<const bf16*>(h_prev), static_cast<const bf16*>(gx),
          gx_bstride, gx_pix, static_cast<const bf16*>(cx), cx_bstride,
          cx_pix, static_cast<const bf16*>(wg), static_cast<const bf16*>(wc),
          static_cast<bf16*>(h_out), B, H, W, C, s);
    });
    return r < 0 ? static_cast<int>(cudaErrorInvalidValue)
                 : static_cast<int>(r);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory one CTA needs at C channels with tile `tile` (f32:
// its one tile), in bytes; -1 for an unknown tile. The wrapper refuses what
// exceeds the card's 227 KB before it launches.
int64_t convgru_blocked_smem_bytes(int dtype, int C, int tile) {
  if (dtype == 0) return static_cast<int64_t>(f32body::smem_bytes(C));
  return bf16body::with_tile(tile, [&](auto tl) -> int64_t {
    return static_cast<int64_t>(bf16body::smem_bytes<decltype(tl)>(C));
  });
}

// The bf16 tile table as the kernel sees it: {TH, TW, BN, stage-A warps
// along M, stage-B warps along M, stages, threads} of tile `tile` (a test
// holds the plan's copy to it). Returns 0, or an error for an unknown tile.
int convgru_blocked_tile(int tile, int* out) {
  const int64_t r = bf16body::with_tile(tile, [&](auto tl) -> int64_t {
    using TL = decltype(tl);
    out[0] = TL::TH;
    out[1] = TL::TW;
    out[2] = TL::BN;
    out[3] = TL::WMA;
    out[4] = TL::WMB;
    out[5] = bf16body::STAGES;
    out[6] = bf16body::NT;
    return 0;
  });
  return r < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

const char* convgru_blocked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
