// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the
// kernels that run their products on mma.sync: attention_spatial.cu (K6)
// and ups2x_fused.cu (K5a, K5b).
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

}  // namespace tc
