// Building blocks of the `mma.sync` kernels.  For the bf16 attention kernels
// (attention_mma.cu, attention_bwd_mma.cu): cp.async copies into shared
// memory, ldmatrix, the m16n8k16 bf16 product with fp32 accumulation, and
// the row loader that zero-pads a head to a multiple of 16 columns in a
// padded shared tile.  For the fp32 `tf32x3` kernels (attention_tf32x3.cu,
// attention_bwd_tf32x3.cu, conv3x3_wgrad_tf32x3.cu): the split of an fp32
// value into TF32 hi + lo, the m16n8k8 tf32 product, the fp32 row loader and
// the fragment loaders that split as they read.
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

// v = hi + lo (to about 2^-20 relative), both TF32 words: the low 13 bits
// of v, then of v - hi, cleared
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;
}

// c (16x8 fp32) += a (16x8 tf32, row) * b (8x8 tf32, col).  Not volatile:
// the compiler may interleave the products of independent accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// floats of padding per shared fp32 row of the tf32x3 attention kernels: a
// row stride of 4 mod 16 floats reads (row g, column t) and (row 2t, column
// g) fragments (g = lane / 4, t = lane % 4) free of bank conflicts
constexpr int FPAD = 4;

// rows [r0, r0 + rows) of one head's (T, D) fp32 matrix into a shared tile
// of DP columns and row stride DP + FPAD, by threads tid = 0 .. nthreads - 1
// (a multiple of 32, at least DP / 4): zeros past T and past D
template <int DP>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int r0, int rows,
                                              int Tn, int D, bool vec, int tid, int nthreads) {
  constexpr int LD = DP + FPAD;
  constexpr int CPR = DP / 4;                  // 16-byte chunks per row
  if (vec) {                                   // D % 4 == 0, 16-byte aligned rows
    const int c = (tid % CPR) * 4;
    const int step = nthreads / CPR;
    const bool col_in = c < D;
    for (int r = tid / CPR; r < rows; r += step) {
      const bool in = col_in && r0 + r < Tn;
      const float* p = in ? src + static_cast<long long>(r0 + r) * D + c : src;
      cp_async16(smem_u32(dst + r * LD + c), p, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * DP; e += nthreads) {
      const int r = e / DP;
      const int c = e % DP;
      const int gr = r0 + r;
      dst[r * LD + c] = (gr < Tn && c < D) ? src[static_cast<long long>(gr) * D + c] : 0.f;
    }
  }
}

// The tf32x3 fragments, each value split into (hi, lo) as it is read from a
// shared fp32 tile of row stride LD.  m16n8k8 tf32: A (16 x 8) holds (row g,
// column t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, col) holds
// (k t, n g), (k t + 4, n g); C holds (row g, columns 2t, 2t + 1), (g + 8,
// the same).

// A: rows 0 .. 15 of `tile`, columns 8 kc ..
template <int LD>
__device__ __forceinline__ void a_frag_split(const float* tile, int kc, int lane,
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = tile + (lane >> 2) * LD + kc * 8 + (lane & 3);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * LD], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * LD + 4], hi[3], lo[3]);
}

// B = rows^T: n runs over rows n0 .. n0 + 7 of `rows`, k over columns 8 kc ..
// (S = Q K^T with `rows` a tile of K)
template <int LD>
__device__ __forceinline__ void b_rows_split(const float* rows, int n0, int kc, int lane,
                                             uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = rows + (n0 + (lane >> 2)) * LD + kc * 8 + (lane & 3);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// B = rows: k runs over rows k0 .. k0 + 7 of `rows` in the order 0, 2, 4, 6,
// 1, 3, 5, 7, n over columns c0 .. c0 + 7.  The same order of k in the A
// operand makes a C fragment an A fragment as it stands (`a_from_c`): the
// sum over k does not depend on its order (P V with `rows` a tile of V)
template <int LD>
__device__ __forceinline__ void b_pairs_split(const float* rows, int k0, int c0, int lane,
                                              uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = rows + (k0 + 2 * (lane & 3)) * LD + c0 + (lane >> 2);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[LD], hi[1], lo[1]);
}

// A fragment, k in `b_pairs_split`'s order, from C-fragment values: c0, c1 of
// row g (columns 2t, 2t + 1) and c2, c3 of row g + 8
__device__ __forceinline__ void a_from_c(float c0, float c1, float c2, float c3,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(c0, hi[0], lo[0]);
  split_tf32(c2, hi[1], lo[1]);
  split_tf32(c1, hi[2], lo[2]);
  split_tf32(c3, hi[3], lo[3]);
}

}  // namespace
