// Building blocks of the bf16 `mma.sync` attention kernels (attention_mma.cu,
// attention_bwd_mma.cu): cp.async copies into shared memory, ldmatrix,
// the m16n8k16 bf16 product with fp32 accumulation, and the row loader that
// zero-pads a head to a multiple of 16 columns in a padded shared tile.
// Each including source gets its own copy (anonymous namespace).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// bf16 of padding per shared-memory row: ldmatrix meets no bank conflict
constexpr int PAD = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes from global to shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + rows) of one head's (T, D) matrix into a shared tile of DP
// columns and row stride DP + PAD, by threads tid = 0 .. nthreads - 1 (a
// multiple of 32): zeros past T and past D
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int rows, int Tn,
                                          int D, bool vec, int tid, int nthreads) {
  constexpr int LD = DP + PAD;
  constexpr int CPR = DP / 8;                  // 16-byte chunks per row
  if (vec) {                                   // D % 8 == 0, 16-byte aligned rows
    // a thread copies one column chunk of every step-th row
    const int c = (tid % CPR) * 8;
    const int step = nthreads / CPR;
    const bool col_in = c < D;
    for (int r = tid / CPR; r < rows; r += step) {
      const bool in = col_in && r0 + r < Tn;
      const bf16* p = in ? src + static_cast<long long>(r0 + r) * D + c : src;
      cp_async16(smem_u32(dst + r * LD + c), p, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * DP; e += nthreads) {
      const int r = e / DP;
      const int c = e % DP;
      const int gr = r0 + r;
      dst[r * LD + c] = (gr < Tn && c < D) ? src[static_cast<long long>(gr) * D + c]
                                           : __float2bfloat16(0.f);
    }
  }
}

}  // namespace
