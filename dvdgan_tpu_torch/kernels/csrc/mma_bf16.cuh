// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the
// kernels that run their products on mma.sync: attention_spatial.cu (K6),
// ups2x_fused.cu (K5a, K5b), conv3x3_mma.cuh (K1, K2) and
// convgru_blocked.cu (K3).
//
//  * cp.async: 16-byte copies from global to shared memory that bypass L1
//    and registers; a thread's copies form a group at commit, and a wait
//    lets a given number of the newest groups stay in flight.
//  * ldmatrix: four (two) 8x8 bf16 matrices from shared memory, one 16-byte
//    row per lane address, straight into mma fragment registers; .trans
//    hands each lane a column pair instead of a row pair.
//  * mma.sync.m16n8k16: D (16x8, f32) += A (16x16, bf16, row) * B (16x8,
//    bf16, col). With g = lane / 4 and t = lane % 4, A holds rows g and g + 8
//    at columns 2t, 2t + 1 (+ 8); B holds k = 2t, 2t + 1 (+ 8) of column g;
//    the accumulator rows g and g + 8 at columns 2t, 2t + 1 (PTX ISA).
//
// A tile whose row stride is an odd multiple of 16 bytes modulo 128 serves
// an ldmatrix of eight consecutive rows without bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `rows` rows of `cols` elements (cols a multiple of the 16-byte
// vector) from global src (row stride lsrc) to shared dst (row stride ldst)
// with cp.async (16 bytes each, past L1), all NT threads of the block. The
// copy is in flight until cp_async_wait().
template <int NT, typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, int ldst, const T* src,
                                                int lsrc, int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int cv = cols / V;
  for (int u = threadIdx.x; u < rows * cv; u += NT) {
    const int r = u / cv, c = (u - r * cv) * V;
    const uint32_t d = smem_addr(dst + (size_t)r * ldst + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + (size_t)r * lsrc + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One 16-byte cp.async of this thread; with `valid` false it reads nothing
// and writes 16 zero bytes (src must still be a global address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most `N` of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four (two) 8x8 bf16 matrices from shared memory, one 16-byte row per lane
// address: lanes 8i .. 8i + 7 give the rows of matrix i; lane l then holds
// row l / 4, columns 2 (l % 4) and + 1 of each: an mma fragment register.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// The same, transposed: lane l holds rows 2 (l % 4) and + 1 of column l / 4
// of each matrix (a fragment of a matrix stored k-major).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Stages `rows` rows of COLS bf16 into dst (row stride LD), all NT threads
// of the block. Row r starts at row_src(r) (nullptr: a zero row); its
// elements at and past `left` are zero. With `vec` (every row start 16-byte
// aligned, `left` a multiple of 8) as 16-byte cp.async copies, in flight
// until the pipeline waits; else as plain loads and stores (channel counts
// that are not multiples of 8).
template <int NT, int COLS, int LD, class RowSrc>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int rows,
                                           int left, bool vec,
                                           const __nv_bfloat16* base,
                                           RowSrc row_src) {
  if (vec) {
    constexpr int V = COLS / 8;
    for (int u = threadIdx.x; u < rows * V; u += NT) {
      const int r = u / V, c = (u % V) * 8;
      const __nv_bfloat16* s = row_src(r);
      const bool ok = s != nullptr && c < left;
      cp_async_16(dst + r * LD + c, ok ? s + c : base, ok);
    }
  } else {
    for (int u = threadIdx.x; u < rows * COLS; u += NT) {
      const int r = u / COLS, c = u % COLS;
      const __nv_bfloat16* s = row_src(r);
      dst[r * LD + c] =
          s != nullptr && c < left ? s[c] : __float2bfloat16(0.f);
    }
  }
}

// A contraction's main loop, STAGES buffers deep: load(step, buffer)
// stages a step (its copies form one cp.async group), compute(step,
// buffer) uses one. The next STAGES - 1 steps are in flight while one is
// computed.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void pipeline(int steps, Load&& load,
                                         Compute&& compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    const int next = it + STAGES - 1;
    if (next < steps) load(next, next % STAGES);
    cp_async_commit();
    cp_async_wait_pending<STAGES - 1>();
    __syncthreads();
    compute(it, it % STAGES);
    __syncthreads();
  }
}

// Accumulator tiles [M][N][4] of a warp. The tensor cores add each mma's
// products to its f32 accumulator with a rounding of their own, and over a
// long chain (K5b: up to 512 mmas) that drifts from round-to-nearest sums
// (past the GPU tests' 1e-5 x max|ref| at 4x4, 512 -> 512). So a long
// contraction sums each step in a fresh tile (zero) and adds that to the
// total with plain f32 adds (promote).
template <int M, int N>
__device__ __forceinline__ void zero(float (&a)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][j][e] = 0.f;
}
template <int M, int N>
__device__ __forceinline__ void promote(float (&acc)[M][N][4],
                                        const float (&part)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// Split reductions in a fixed order: each of `count` CTAs that share an
// output block writes its partial sums to device memory and calls this;
// it is true for the last to get here, which then sees every partial and
// adds them in slice order (no float atomics: the same bits on every run).
// That CTA sets the counter back to 0 for the next launch.
__device__ __forceinline__ bool last_to_arrive(unsigned int* counter,
                                               int count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == (unsigned int)(count - 1);
    if (last) *counter = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

}  // namespace tc
