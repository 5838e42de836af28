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
// plane's shape (kernels/convgru_cell.py: plan):
//   * planes up to 8 x 8, ONE launch, in which r*h and z never reach global
//     memory:
//     - bf16 (cell_cluster_kernel): a thread-block cluster of K CTAs owns
//       one batch element's plane; CTA j owns the output channels S_j =
//       [j C/K, (j + 1) C/K). Each CTA stages the whole h plane (all C
//       channels; the SAME halo is a zero row that out-of-plane taps point
//       at) and runs the gate conv for the columns r[S_j] and z[S_j] only,
//       an implicit GEMM on mma.sync (M = the plane's pixels, N = 2 C/K,
//       K = 9 taps x C), Wg's slice streamed through cp.async stages. It
//       writes r*h[S_j], rounded, over h[S_j] in its own plane buffer and
//       keeps z[S_j] and h[S_j] in registers. After a cluster barrier it
//       gathers the other CTAs' r*h slices from their shared memory (DSMEM)
//       into its buffer, which then holds the whole r*h plane, and runs the
//       candidate conv for S_j the same way (Wc's slice streamed; its first
//       chunks are in flight during the exchange), then the blend. A second
//       cluster barrier, arrived at after the gather and waited on at the
//       exit, keeps each CTA's shared memory alive while its peers read it.
//       Nothing is reduced across CTAs: each output's 9 C-deep contraction
//       runs in one fixed order (16-channel chunks, chunk-major, the nine
//       taps of a chunk summed on the tensor cores from zero and added to
//       the f32 total: K1's order), so the step has the same bits for every
//       cluster size K and every run.
//     - f32, the parity mode (cell_plane_kernel): a CTA owns a batch
//       element's whole plane with all C channels on the CUDA cores
//       (conv3x3_tile.cuh): r*h for all channels into shared memory, then
//       per block of output channels the update half of the gate conv and
//       the candidate conv into two register accumulators and the blend.
//   * larger planes: K1's gate launch then its candidate launch, made by
//     the wrapper through K1's library (convgru_seq.cu: tensor cores in
//     bf16), r*h and z through global scratch: a CTA cannot wait for its
//     neighbours' r*h. So there K4's step is K1's, bit for bit.
//
// What bounds it on the H100: the weights, 9 C x 3C bf16 (3.5 MB at C 256,
// 14.2 MB at C 512), against 16-64 pixels of work each at the generator's
// 4x4 and 8x8 planes. A cluster spreads each batch element's weights over
// K SMs (every batch element reads them all: from L2 after the first), so
// the B K CTAs of a launch stream them through B K SMs: 128 CTAs at B 16
// and K 8, 16 (K 8) or 32 (K 16, a non-portable cluster size) at B 2.
// Within an SM the staged weights are read by ldmatrix once for every warp
// that holds a tile of their columns, so a warp owns two m-tiles and a B
// fragment serves both. At 8x8 the mma chains take about half of a launch
// and the weight copies a third (builds without each, -DK4_DIAG below).
// Each thread's cp.async offsets are worked out once: issuing the copies
// with per-piece index arithmetic cost as much as the copies.
//
// Layouts as K1: h, h_out contiguous (B, H, W, C) and not aliased; gx/cx
// read at pixel stride `pix` and batch stride `bstride`.

#include <cooperative_groups.h>

#include "conv3x3_tile.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace convgru;
using bf16 = __nv_bfloat16;

// ---- f32: one CTA per plane on the CUDA cores ------------------------------

// Whole planes of up to 8 x 8 (256 threads: 16 pixel groups x 16 channel
// groups) and of up to 4 x 4 (256 threads: 4 pixel groups x 64 channel
// groups, so that no thread idles on a 16-pixel plane).
using PlaneWide = Tile<8, 8, 64, 16>;
using PlaneSmall = Tile<4, 4, 256, 4>;
static_assert(PlaneWide::THREADS == 256 && PlaneSmall::THREADS == 256, "map");

template <class TL>
size_t plane_smem_bytes(int H, int W, int C) {
  static_assert(((TL::IN_SMEM + TL::W_SMEM) * 4) % 16 == 0, "align");
  return (size_t)(TL::IN_SMEM + TL::W_SMEM) * sizeof(float) +
         (size_t)H * W * C * sizeof(float);
}

// grid: (B); H <= TL::TH, W <= TL::TW.
template <class TL>
__global__ void __launch_bounds__(TL::THREADS)
cell_plane_kernel(const float* __restrict__ h, const float* __restrict__ gx,
                  int64_t gx_bstride, int64_t gx_pix,
                  const float* __restrict__ cx, int64_t cx_bstride,
                  int64_t cx_pix, const float* __restrict__ wg,
                  const float* __restrict__ wc, float* __restrict__ h_out,
                  int H, int W, int C) {
  using T = float;
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

template <class TL>
int plane_launch(const void* h, const void* gx, int64_t gx_bstride,
                 int64_t gx_pix, const void* cx, int64_t cx_bstride,
                 int64_t cx_pix, const void* wg, const void* wc, void* h_out,
                 int B, int H, int W, int C, cudaStream_t stream) {
  if (H > TL::TH || W > TL::TW) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = plane_smem_bytes<TL>(H, W, C);
  auto kernel = cell_plane_kernel<TL>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  using T = float;
  kernel<<<B, TL::THREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(gx), gx_bstride, gx_pix,
      static_cast<const T*>(cx), cx_bstride, cx_pix, static_cast<const T*>(wg),
      static_cast<const T*>(wc), static_cast<T*>(h_out), H, W, C);
  return static_cast<int>(cudaGetLastError());
}

bool plane_is_small(int H, int W) {
  return H <= PlaneSmall::TH && W <= PlaneSmall::TW;
}

// ---- bf16: one launch of thread-block clusters -----------------------------

constexpr int NT = 256;          // threads per CTA: eight warps
constexpr int KC = 16;           // input channels a chunk: one mma k-step
constexpr int TAPS = 9;
// Weight chunks in flight (2, 3 and 4 timed within 4% of each other at
// every driven plane on the H100, 6 slower at 4x4; 3 leaves shared memory
// to spare). -D switches for timing variants
// (tools/torch_k4_variants.py):
// K4_STAGES; K4_DIAG 1 skips the mmas, 2 the weight copies (the outputs are
// then wrong), which splits a launch's time between them.
#ifndef K4_STAGES
#define K4_STAGES 3
#endif
#ifndef K4_DIAG
#define K4_DIAG 0
#endif
constexpr int STAGES = K4_STAGES;
constexpr int PLANE_MAX = 8;     // rows and columns of a plane
constexpr int MAX_CLUSTER = 16;  // 8 is portable; 16 needs the opt-in

// The plane buffer's row stride (bf16): C rounded up to whole chunks, plus
// 8, an odd multiple of 16 bytes (conflict-free ldmatrix).
__host__ __device__ inline int plane_ld(int C) {
  return (C + KC - 1) / KC * KC + 8;
}

// A CTA's GEMM shape: MTT m-tiles of 16 pixels cover the plane, NTT n-tiles
// of 8 channels cover its slice (padded to SP). A warp owns MW m-tiles x NW
// n-tiles (each n-tile with its r and z columns in the gate): two m-tiles
// where the plane has four, so that a B fragment read from shared memory
// serves two mmas (the reads of the staged weights, not the tensor cores,
// bound these small planes); with fewer tiles than eight warps the last
// warps only stage. A stage holds one chunk's weight rows (9 taps x 16
// channels), each row the slice's r columns then its z columns (gate)
// or its columns (candidate), at a row stride of an odd multiple of 16
// bytes.
template <int MTT_, int NTT_>
struct Shape {
  static constexpr int MTT = MTT_, NTT = NTT_;
  static constexpr int MW = MTT >= 2 ? 2 : 1;
  static constexpr int NW = MTT / MW * NTT > 8 ? MTT / MW * NTT / 8 : 1;
  static constexpr int WNG = NTT / NW;               // warps along n
  static constexpr int ACTIVE = MTT / MW * WNG;
  static constexpr int SP = 8 * NTT;
  static constexpr int LDW = 2 * SP + 8;
  static constexpr int STAGE = TAPS * KC * LDW;     // elements
  static_assert(ACTIVE <= 8 && NTT % NW == 0, "eight warps");
};

template <class SH>
size_t cluster_smem_bytes(int HW, int C) {
  return ((size_t)(HW + 1) * plane_ld(C) + (size_t)STAGES * SH::STAGE) *
         sizeof(bf16);
}

// Two 8x8 bf16 matrices, transposed (mma_bf16.cuh's ldmatrix_x4_trans for
// one n-tile): lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(tc::smem_addr(p)));
}

// The cluster barrier in two halves: arrive (this CTA's earlier shared and
// distributed shared memory accesses are released) and wait (for every
// CTA of the cluster to have arrived).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The main loop of one conv: chunk `it` is computed while the next
// STAGES - 1 are in flight (load(chunk, buffer) commits nothing; the
// prologue's groups may have been issued long before, `prologue`).
template <class Load>
__device__ __forceinline__ void prologue(int steps, Load&& load) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    tc::cp_async_commit();
  }
}
template <class Load, class Compute>
__device__ __forceinline__ void main_loop(int steps, Load&& load,
                                          Compute&& compute) {
#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    const int next = it + STAGES - 1;
    if (next < steps) load(next, next % STAGES);
    tc::cp_async_commit();
    tc::cp_async_wait_pending<STAGES - 1>();
    __syncthreads();
    compute(it, it % STAGES);
    __syncthreads();
  }
}

// grid (K, B), cluster (K, 1, 1): the cluster's CTA of rank j takes the
// output channels [j S, (j + 1) S) of batch element blockIdx.y (S = C / K).
template <class SH>
__global__ void __launch_bounds__(NT, 1)
cell_cluster_kernel(const bf16* __restrict__ h, const bf16* __restrict__ gx,
                    int64_t gx_bstride, int64_t gx_pix,
                    const bf16* __restrict__ cx, int64_t cx_bstride,
                    int64_t cx_pix, const bf16* __restrict__ wg,
                    const bf16* __restrict__ wc, bf16* __restrict__ h_out,
                    int H, int W, int C, int S) {
  namespace cg = cooperative_groups;
  constexpr int MW = SH::MW, NW = SH::NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int j = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y, c0 = j * S;
  const int HW = H * W, LD = plane_ld(C), chunks = (C + KC - 1) / KC;
  bf16* plane = reinterpret_cast<bf16*>(smem_raw);   // (HW + 1) x LD
  bf16* stages = plane + (size_t)(HW + 1) * LD;
  const bf16* hb = h + (int64_t)b * HW * C;
  const bf16* gxb = gx + (int64_t)b * gx_bstride;
  const bf16* cxb = cx + (int64_t)b * cx_bstride;
  const bool vec = C % 8 == 0 && tc::aligned16(h) && tc::aligned16(wg) &&
                   tc::aligned16(wc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // the h plane, all C channels (zero past C), and the zero row HW
  {
    const int cv = 2 * chunks;
    for (int u = threadIdx.x; u < (HW + 1) * cv; u += NT) {
      const int r = u / cv, c = (u - r * cv) * 8;
      bf16* d = plane + (size_t)r * LD + c;
      if (vec) {
        const bool ok = r < HW && c < C;
        tc::cp_async_16(d, ok ? hb + (int64_t)r * C + c : h, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = r < HW && c + e < C ? hb[(int64_t)r * C + c + e]
                                     : __float2bfloat16(0.f);
      }
    }
    tc::cp_async_commit();
  }

  // Chunk c of a conv's weight slice into stage `buf`: the r and z columns
  // of the gate (wg (3, 3, C, 2C)), or the candidate's (wc (3, 3, C, C)),
  // zero past the slice and past C. A thread's 16-byte pieces are the same
  // every chunk but for the chunk's first channel: their offsets are worked
  // out once (their tap's first weight row, their channel in the chunk,
  // their stage offset; the column is the same for all: NT is a multiple
  // of the vectors a row).
  constexpr int V = SH::SP / 8, UNITS = TAPS * KC * V;
  constexpr int UPT = (UNITS + NT - 1) / NT;
  static_assert(NT % V == 0, "one column a thread");
  const int w_col = 8 * (threadIdx.x % V);
  int w_tap[UPT], w_ci[UPT], s_off[UPT];
#pragma unroll
  for (int k = 0; k < UPT; ++k) {
    const int u = threadIdx.x + k * NT, r = u / V;
    w_tap[k] = r / KC * C;
    w_ci[k] = u < UNITS ? r % KC : C;
    s_off[k] = r * SH::LDW + w_col;
  }
  auto load = [&](bool gate, int c, int buf) {
    if (K4_DIAG == 2) return;
    bf16* dst = stages + (size_t)buf * SH::STAGE;
    const bf16* w = gate ? wg : wc;
    const int64_t ldg = gate ? 2 * C : C;
    const int ci0 = c * KC;
    if (!vec) {            // channel counts that are not whole vectors
      auto rows = [&](bf16* to, int col0) {
        tc::stage_rows<NT, SH::SP, SH::LDW>(
            to, TAPS * KC, S, false, w, [&](int r) -> const bf16* {
              const int ci = ci0 + r % KC;
              return ci < C ? w + ((int64_t)(r / KC) * C + ci) * ldg + col0
                            : nullptr;
            });
      };
      rows(dst, c0);
      if (gate) rows(dst + SH::SP, C + c0);
      return;
    }
#pragma unroll
    for (int k = 0; k < UPT; ++k) {
      if (k * NT + (int)threadIdx.x >= UNITS) continue;
      const int ci = ci0 + w_ci[k];
      const bool ok = w_col < S && ci < C;
      const bf16* src = w + (int64_t)(w_tap[k] + ci) * ldg + c0 + w_col;
      tc::cp_async_16(dst + s_off[k], ok ? src : w, ok);
      if (gate) tc::cp_async_16(dst + s_off[k] + SH::SP, ok ? src + C : w, ok);
    }
  };
  auto load_gate = [&](int c, int buf) { load(true, c, buf); };
  auto load_cand = [&](int c, int buf) { load(false, c, buf); };

  // this warp's tiles: m-tiles mt0 .. mt0 + MW - 1, n-tiles nt0 .. nt0 +
  // NW - 1; its lane's ldmatrix rows: A, its pixel (lane % 16 of an m-tile)
  // shifted by each tap (the zero row outside the plane), channels + 8 for
  // lanes 16-31; B (.trans), k-row lane % 8 (+ 8 for lanes 8-15 and 24-31)
  const bool active = warp < SH::ACTIVE;
  const int mt0 = warp / SH::WNG * MW, nt0 = warp % SH::WNG * NW;
  int a_off[MW][TAPS];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    const int m = 16 * (mt0 + mi) + (lane & 15), y = m / W, x = m % W;
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
      const bool in = m < HW && yy >= 0 && yy < H && xx >= 0 && xx < W;
      a_off[mi][tap] = (in ? yy * W + xx : HW) * LD + (lane >> 4) * 8;
    }
  }
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * SH::LDW + 8 * nt0;

  // ---- the gate conv: r[S_j] and z[S_j] ---------------------------------
  float acc_r[MW][NW][4], acc_z[MW][NW][4];
  tc::zero(acc_r);
  tc::zero(acc_z);
  auto gate = [&](int c, int buf) {
    if (!active) return;
    const bf16* ws = stages + (size_t)buf * SH::STAGE + b_off +
                     (lane >> 4) * SH::SP;
    float pr[MW][NW][4], pz[MW][NW][4];   // this chunk's sums
    tc::zero(pr);
    tc::zero(pz);
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      uint32_t a[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
        tc::ldmatrix_x4(a[mi], plane + a_off[mi][tap] + c * KC);
#pragma unroll
      for (int ni = 0; ni < NW; ++ni) {
        uint32_t bb[4];
        tc::ldmatrix_x4_trans(bb, ws + tap * KC * SH::LDW + 8 * ni);
        if (K4_DIAG != 1)
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            tc::mma_16816(pr[mi][ni], a[mi], bb[0], bb[1]);
            tc::mma_16816(pz[mi][ni], a[mi], bb[2], bb[3]);
          }
      }
    }
    tc::promote(acc_r, pr);
    tc::promote(acc_z, pz);
  };
  prologue(chunks, load_gate);
  main_loop(chunks, load_gate, gate);
  prologue(chunks, load_cand);     // in flight during the exchange

  // r, z = sigmoid(gx + gh); r*h rounded over h[S_j] in the plane buffer;
  // z and h kept for the blend. Accumulator element e of tile (mi, ni):
  // pixel 16 (mt0 + mi) + g (+ 8 for e >= 2), channel 8 (nt0 + ni) + 2t +
  // e % 2 of S_j.
  float zk[MW][NW][4], hk[MW][NW][4];
  if (active) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * (mt0 + mi) + g + 8 * (e >> 1);
          const int n = 8 * (nt0 + ni) + 2 * t + (e & 1);
          zk[mi][ni][e] = hk[mi][ni][e] = 0.f;
          if (m >= HW || n >= S) continue;
          const int c = c0 + n;
          const float gr = to_f(gxb[m * gx_pix + c]);
          const float gz = to_f(gxb[m * gx_pix + C + c]);
          const float r = 1.f / (1.f + expf(-(gr + acc_r[mi][ni][e])));
          zk[mi][ni][e] = 1.f / (1.f + expf(-(gz + acc_z[mi][ni][e])));
          bf16* p = plane + (size_t)m * LD + c;
          hk[mi][ni][e] = to_f(*p);
          *p = from_f<bf16>(r * hk[mi][ni][e]);
        }
  }

  // ---- the exchange: every CTA's r*h slice into this CTA's plane --------
  cluster.sync();
  if (K > 1) {
    const int sv = S / 8, per_peer = HW * sv, units = (K - 1) * per_peer;
    constexpr int U = 4;                   // loads in flight a thread
    for (int u0 = threadIdx.x; u0 < units; u0 += U * NT) {
      uint4 v[U];
      int at[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int u = u0 + q * NT;
        at[q] = -1;
        if (u >= units) continue;
        const int i = (j + 1 + u / per_peer) % K;     // the peer
        const int rest = u % per_peer, r = rest / sv;
        at[q] = r * LD + i * S + (rest % sv) * 8;
        const bf16* src = cluster.map_shared_rank(plane, i) + at[q];
        v[q] = *reinterpret_cast<const uint4*>(src);
      }
#pragma unroll
      for (int q = 0; q < U; ++q)
        if (at[q] >= 0) *reinterpret_cast<uint4*>(plane + at[q]) = v[q];
    }
  }
  cluster_arrive();        // done reading the peers' shared memory
  __syncthreads();

  // ---- the candidate conv for S_j, the blend ----------------------------
  float acc_c[MW][NW][4];
  tc::zero(acc_c);
  auto cand = [&](int c, int buf) {
    if (!active) return;
    const bf16* ws = stages + (size_t)buf * SH::STAGE + b_off;
    float pc[MW][NW][4];
    tc::zero(pc);
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      uint32_t a[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
        tc::ldmatrix_x4(a[mi], plane + a_off[mi][tap] + c * KC);
      const bf16* wt = ws + tap * KC * SH::LDW;
      if constexpr (NW == 1) {
        uint32_t bb[2];
        ldmatrix_x2_trans(bb, wt);
        if (K4_DIAG != 1)
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
            tc::mma_16816(pc[mi][0], a[mi], bb[0], bb[1]);
      } else {
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) {
          uint32_t bb[4];
          tc::ldmatrix_x4_trans(bb, wt + 16 * i + (lane >> 4) * 8);
          if (K4_DIAG != 1)
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) {
              tc::mma_16816(pc[mi][2 * i], a[mi], bb[0], bb[1]);
              tc::mma_16816(pc[mi][2 * i + 1], a[mi], bb[2], bb[3]);
            }
        }
      }
    }
    tc::promote(acc_c, pc);
  };
  main_loop(chunks, load_cand, cand);

  if (active) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * (mt0 + mi) + g + 8 * (e >> 1);
          const int n = 8 * (nt0 + ni) + 2 * t + (e & 1);
          if (m >= HW || n >= S) continue;
          const int c = c0 + n;
          const float ch = tanhf(to_f(cxb[m * cx_pix + c]) + acc_c[mi][ni][e]);
          h_out[((int64_t)b * HW + m) * C + c] =
              from_f<bf16>(blend(zk[mi][ni][e], hk[mi][ni][e], ch));
        }
  }
  cluster_wait();          // no CTA leaves while a peer may read it
}

// The cluster form's GEMM shape for a plane of H x W pixels, C channels and
// clusters of K CTAs: false where it does not take them (a plane over 8 x 8,
// K not dividing C, K over 16, a slice of more than 64 channels, or, with
// K > 1, a slice that is not whole 16-byte vectors).
bool cluster_shape(int H, int W, int C, int K, int& mtt, int& ntt) {
  if (H < 1 || W < 1 || H > PLANE_MAX || W > PLANE_MAX || C < 1 || K < 1 ||
      K > MAX_CLUSTER || C % K)
    return false;
  const int S = C / K, n = (S + 7) / 8;
  if ((K > 1 && S % 8) || n > 8) return false;
  ntt = n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8;
  mtt = H * W <= 16 ? 1 : 4;
  return true;
}

// f(Shape<MTT, NTT>{}) for the shape's instance.
template <class F>
auto with_shape(int mtt, int ntt, F&& f) {
  if (mtt == 1) {
    switch (ntt) {
      case 1: return f(Shape<1, 1>{});
      case 2: return f(Shape<1, 2>{});
      case 4: return f(Shape<1, 4>{});
      default: return f(Shape<1, 8>{});
    }
  }
  switch (ntt) {
    case 1: return f(Shape<4, 1>{});
    case 2: return f(Shape<4, 2>{});
    case 4: return f(Shape<4, 4>{});
    default: return f(Shape<4, 8>{});
  }
}

template <class SH>
int cluster_launch(const void* h, const void* gx, int64_t gx_bstride,
                   int64_t gx_pix, const void* cx, int64_t cx_bstride,
                   int64_t cx_pix, const void* wg, const void* wc,
                   void* h_out, int B, int H, int W, int C, int K,
                   cudaStream_t stream) {
  const size_t smem = cluster_smem_bytes<SH>(H * W, C);
  auto kernel = cell_cluster_kernel<SH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && K > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, B, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(h), static_cast<const bf16*>(gx),
      gx_bstride, gx_pix, static_cast<const bf16*>(cx), cx_bstride, cx_pix,
      static_cast<const bf16*>(wg), static_cast<const bf16*>(wc),
      static_cast<bf16*>(h_out), H, W, C, C / K);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launching function makes ONE
// launch on `stream` (a cudaStream_t) and returns the CUDA error code of
// the launch (0 = launched); a refused launch (a cluster too large for the
// card, too much shared memory) returns its error and never runs.
extern "C" {

// The f32 one-launch form (dtype 0 = float32; the only one it takes):
// h_out = GRU step of h, for planes up to 8 x 8, a CTA per batch element.
int convgru_cell_plane_step(int dtype, int device, const void* h,
                            const void* gx, int64_t gx_bstride, int64_t gx_pix,
                            const void* cx, int64_t cx_bstride, int64_t cx_pix,
                            const void* wg, const void* wc, void* h_out, int B,
                            int H, int W, int C, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return plane_is_small(H, W)
             ? plane_launch<PlaneSmall>(h, gx, gx_bstride, gx_pix, cx,
                                        cx_bstride, cx_pix, wg, wc, h_out, B,
                                        H, W, C, s)
             : plane_launch<PlaneWide>(h, gx, gx_bstride, gx_pix, cx,
                                       cx_bstride, cx_pix, wg, wc, h_out, B,
                                       H, W, C, s);
}

// Dynamic shared memory a CTA of the f32 one-launch form needs, in bytes.
int64_t convgru_cell_plane_smem_bytes(int H, int W, int C) {
  return static_cast<int64_t>(plane_is_small(H, W)
                                  ? plane_smem_bytes<PlaneSmall>(H, W, C)
                                  : plane_smem_bytes<PlaneWide>(H, W, C));
}

// The bf16 one-launch form: clusters of K CTAs (grid (K, B)), each CTA C / K
// output channels of a batch element's plane.
int convgru_cell_cluster_step(int device, const void* h, const void* gx,
                              int64_t gx_bstride, int64_t gx_pix,
                              const void* cx, int64_t cx_bstride,
                              int64_t cx_pix, const void* wg, const void* wc,
                              void* h_out, int B, int H, int W, int C, int K,
                              void* stream) {
  int mtt = 0, ntt = 0;
  if (B < 1 || B > 65535 || !cluster_shape(H, W, C, K, mtt, ntt))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_shape(mtt, ntt, [&](auto sh) {
    return cluster_launch<decltype(sh)>(h, gx, gx_bstride, gx_pix, cx,
                                        cx_bstride, cx_pix, wg, wc, h_out, B,
                                        H, W, C, K, s);
  });
}

// Dynamic shared memory a CTA of the cluster form needs, in bytes; 0 where
// the form does not take the shape. out[0..1]: its m-tiles and n-tiles.
int64_t convgru_cell_cluster_smem_bytes(int H, int W, int C, int K,
                                        int* out) {
  int mtt = 0, ntt = 0;
  if (!cluster_shape(H, W, C, K, mtt, ntt)) return 0;
  out[0] = mtt;
  out[1] = ntt;
  return with_shape(mtt, ntt, [&](auto sh) {
    return static_cast<int64_t>(cluster_smem_bytes<decltype(sh)>(H * W, C));
  });
}

const char* convgru_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
