// Flash self-attention in fp32 on Hopper's tensor cores, each product taken
// as three TF32 products of split operands, with the ADM legacy scaling:
// out = softmax((q * d^-1/4) (k * d^-1/4)^T) v, the softmax in fp32, for
// head widths d <= 128.  The `tf32x3` variant of ops/attention.py::plan
// (fp32 with d <= 128: the UNet's attention when it samples, adapts or
// trains in fp32, the CLIs' default compute dtype).
//
// Replaces, for fp32, the Pallas TPU kernel `_flash_kernel` /
// `flash_attention` of diffusion_models_dev_project_tpu/ops/attention.py
// (online softmax over key blocks, padded keys masked to -1e30, any T, d
// zero-padded), which the JAX package runs in fp32; its einsum path runs at
// Precision.HIGHEST, so one TF32 product per fp32 product would not do.
//
// What bounds it on the H100: on the UNet's path q, k, v are (8, 256, 64)
// and (8, 64, 64) per image, about 0.07 GFLOP over 2 MB per call: a few
// microseconds at the TF32 rate for three products.  Like the bf16 `mma`
// kernel (attention_mma.cu), whose skeleton it keeps, it is bound by
// latency: the launch, the chain of key tiles each warp walks, and how many
// SMs the grid reaches.  What the design does about it:
//
// - Both products on the tensor cores, `mma.sync.m16n8k8` tf32 -> fp32, and
//   not `wgmma`: a `wgmma` tile is 64 rows per warpgroup, which leaves most
//   of the 132 SMs idle at T = 256, and `wgmma` takes 32-bit operands only
//   K-major.  Every operand value v is split in registers as it is read,
//   hi = v with its low 13 bits cleared and lo = v - hi the same, and each
//   8-wide slice of a product issues hi*hi, hi*lo, lo*hi into one fp32
//   accumulator, in that order (the split and the product are those of
//   conv3x3_wgrad_tf32x3.cu, mma_common.cuh).
// - One warp owns 16 query rows.  At d <= 64 it splits its Q fragments once
//   and keeps hi and lo in registers for its whole key loop; at d = 128 they
//   would not fit beside O, so it splits them from shared memory per tile.
// - The blocking of `mma`: a block of 4 warps is `groups` row groups of 16
//   rows times `splits` key splits (4 at T = 256: 128 blocks at batch 1, one
//   tile chain of 2 key tiles a warp).  Each split runs its own online
//   softmax; at the end the splits of a row group merge (O, m, l) through
//   shared memory in split order.  Key tiles are 32 keys, not `mma`'s 64:
//   fp32 tiles are twice bf16's bytes, and two stages of 4 splits fit in
//   shared memory only so.  At d > 64 at most 2 splits.
// - S = Q K^T from the unscaled q and k, then S * d^-1/2 * log2(e) in fp32
//   and exp2; the running max per row reduced over the 4 lanes of a row,
//   the sums kept per lane from the fp32 P and reduced once at the end.
//   Keys past T score -1e30 (no inf - inf).
// - P stays in registers.  The C fragment of S holds keys 2t, 2t + 1 of a
//   lane's rows, the A fragment of P V wants keys t, t + 4: the product
//   takes each slice's 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7 in both
//   operands, reading V's B fragment from rows 2t and 2t + 1, so P's C
//   fragment is its A fragment as it stands (a sum over keys does not
//   depend on their order).  P is split into hi and lo in registers.
// - Each split streams its K and V tiles through shared-memory stages of
//   its own by `cp.async` 16-byte copies (scalar loads when d % 4 != 0 or a
//   pointer is not 16-byte aligned), on its own named barrier.  Two stages
//   let the next tile land during this one, but at d = 64 take 140 KB for 4
//   splits, one block per SM; when the grid has more blocks than the card
//   has SMs, the plan takes one stage, and three blocks share an SM, their
//   warps hiding each other's copies.  Rows are padded to 4 mod 16 floats:
//   the fragment reads meet no bank conflict.
// - No atomics, no split across blocks and a fixed merge order: two
//   launches give the same bits.  The kernel runs on the caller's stream
//   and allocates nothing, so a CUDA graph can capture it.
// - Given an `lse` buffer, split 0 of each row group writes the row's lse2 =
//   m + log2(l) after the merge (fp32, the log2 domain of S above), for the
//   backward (attention_bwd_tf32x3.cu).
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"

namespace {

constexpr int BK = 32;          // keys per shared-memory tile
constexpr int WARPS = 4;        // warps per block: row groups x key splits

// shared memory of a block in floats: Q (16 rows per row group), then
// `stages` K and V tiles; after the key loop the same bytes hold the
// partial results of the warps of key splits 1.. for the merge
template <int DP>
constexpr int q_floats(int groups) { return 16 * groups * (DP + FPAD); }
template <int DP>
constexpr int ring_floats(int stages) { return stages * 2 * BK * (DP + FPAD); }
template <int DP>   // floats of one warp's partial result: O, then m and l of two rows, per lane
__host__ __device__ constexpr int partial_floats() { return (DP / 8) * 4 * 32 + 4 * 32; }
template <int DP>
constexpr int smem_bytes(int groups, int splits, int stages) {
  return 4 * (q_floats<DP>(groups) +
              (ring_floats<DP>(stages) > groups * (splits - 1) * partial_floats<DP>()
                   ? ring_floats<DP>(stages)
                   : groups * (splits - 1) * partial_floats<DP>()));
}
// the most any valid launch asks: key splits 1, 2 or 4 (at most 2 for
// DP = 128), two stages per split
template <int DP>
constexpr int max_smem_bytes() {
  int most = 0;
  for (int splits = 1; splits <= (DP <= 64 ? 4 : 2); splits *= 2) {
    const int b = smem_bytes<DP>(WARPS / splits, splits, 2 * splits);
    most = b > most ? b : most;
  }
  return most;
}

// DP: the widest head this instantiation takes (64 or 128).  The warps of
// split s (warps s*groups ..) take key tiles s, s + splits, ... with their
// own online softmax, load those tiles themselves through one or two
// (`two`) stages of their own, and sync on their own named barrier.  K and
// V of a tile are separate copy groups: Q K^T and the softmax run while V
// lands.
template <int DP>
__global__ void __launch_bounds__(32 * WARPS)
attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int Tn, int D, float scale_log2, int splits,
                        int two_stages, int vec, int pairs) {
  constexpr int LD = DP + FPAD;
  constexpr int TILE = BK * LD;
  constexpr int KS = DP / 8;        // 8-wide slices of d (and column tiles of O)
  constexpr int ST = BK / 8;        // 8-key column tiles of S
  constexpr bool HOLD = DP <= 64;   // Q's split fragments in registers for the whole loop
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = WARPS / splits;
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* ring = Qs + 16 * groups * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = warp / groups;
  const int group = warp - split * groups;
  const int gthreads = 32 * groups;                  // threads of this split
  const int gtid = threadIdx.x - split * gthreads;
  const int g = lane >> 2;          // C-fragment rows g and g + 8
  const int t4 = lane & 3;          // C-fragment columns 2*t4 and 2*t4 + 1
  const int nks = (D + 7) / 8;      // slices of d that hold data
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const int q0 = blockIdx.x * 16 * groups;
  const int ntiles = (Tn + BK - 1) / BK;
  const bool vec_ok = vec != 0;
  // this split's stages: two when asked for and some split has a second
  // tile, else one, refilled after each tile
  const bool two = two_stages != 0 && ntiles > splits;
  float* stages = ring + split * (two ? 2 : 1) * 2 * TILE;
  const auto split_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(split + 1), "r"(gthreads) : "memory");
  };
  const auto load_tile = [&](float* stage, int j) {    // K then V: two copy groups
    load_rows_f32<DP>(stage, k + base, j * BK, BK, Tn, D, vec_ok, gtid, gthreads);
    cp_async_commit();
    load_rows_f32<DP>(stage + TILE, v + base, j * BK, BK, Tn, D, vec_ok, gtid, gthreads);
    cp_async_commit();
  };

  // Q of all row groups, by the whole block; then this split's first tile
  load_rows_f32<DP>(Qs, q + base, q0, 16 * groups, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  cp_async_commit();
  load_tile(stages, split);
  cp_async_wait<2>();
  __syncthreads();

  const float* Qw = Qs + group * 16 * LD;
  uint32_t qh[HOLD ? KS : 1][4], ql[HOLD ? KS : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      if (kc < nks) a_frag_split<LD>(Qw, kc, lane, qh[kc], ql[kc]);
    }
  }
  float o[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g + 8 (log2 domain)
  float l0 = 0.f, l1 = 0.f;               // this lane's part of the running sums

  for (int j = split, buf = 0; j < ntiles; j += splits, buf ^= two ? 1 : 0) {
    const float* Kb = stages + buf * 2 * TILE;
    const float* Vb = Kb + TILE;
    const bool next = two && j + splits < ntiles;
    if (next) {                           // the next tile streams in during this one
      load_tile(stages + (buf ^ 1) * 2 * TILE, j + splits);
      cp_async_wait<3>();
    } else {
      cp_async_wait<1>();
    }
    split_sync();                         // K of tile j has landed
    // S = Q K^T for this warp's 16 rows and the tile's 32 keys: per slice of
    // d, hi*hi over the 4 key tiles, then hi*lo, then lo*hi
    float s[ST][4];
#pragma unroll
    for (int i = 0; i < ST; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      if (kc < nks) {
        uint32_t ah[4], al[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qh[kc][e];
            al[e] = ql[kc][e];
          }
        } else {
          a_frag_split<LD>(Qw, kc, lane, ah, al);
        }
        uint32_t bh[ST][2], bl[ST][2];
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) b_rows_split<LD>(Kb, nt * 8, kc, lane, bh[nt], bl[nt]);
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) mma_tf32(s[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) mma_tf32(s[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) mma_tf32(s[nt], al, bh[nt][0], bh[nt][1]);
      }
    }

    // scale, mask, online softmax
    const int k0 = j * BK;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        s[nt][e] = key < Tn ? s[nt][e] * scale_log2 : -1e30f;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0);   // 0 on the split's first tile
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }
    // P = exp2(S - m) in fp32; the row sums from it
    float p[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      p[nt][0] = exp2f(s[nt][0] - mn0);
      p[nt][1] = exp2f(s[nt][1] - mn0);
      p[nt][2] = exp2f(s[nt][2] - mn1);
      p[nt][3] = exp2f(s[nt][3] - mn1);
      l0 += p[nt][0] + p[nt][1];
      l1 += p[nt][2] + p[nt][3];
    }

    if (next) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    split_sync();                         // V of tile j has landed
    // O += P V, 8 keys at a time in `b_pairs_split`'s order; per group of 4
    // column tiles of O, hi*hi over the 4, then hi*lo, then lo*hi
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      uint32_t ph[4], pl[4];
      a_from_c(p[nt][0], p[nt][1], p[nt][2], p[nt][3], ph, pl);
#pragma unroll
      for (int ot0 = 0; ot0 < KS; ot0 += 4) {
        if (ot0 < nks) {
          uint32_t vh[4][2], vl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            b_pairs_split<LD>(Vb, nt * 8, (ot0 + i) * 8, lane, vh[i], vl[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(o[ot0 + i], ph, vh[i][0], vh[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(o[ot0 + i], ph, vl[i][0], vl[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(o[ot0 + i], pl, vh[i][0], vh[i][1]);
        }
      }
    }
    split_sync();                         // stage buf is free for a later tile
    if (!two && j + splits < ntiles) load_tile(stages, j + splits);
  }
  __syncthreads();                        // every split is done with its stages

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  float mr0 = m0, mr1 = m1;               // the rows' max over all keys
  if (splits > 1) {
    // splits 1.. of each row group leave (O, m, l) in the ring's bytes; split 0
    // merges them in split order, so the result is the same bits every launch
    float* part = ring;
    constexpr int PF = partial_floats<DP>();
    if (split > 0) {
      float* mine = part + (group * (splits - 1) + split - 1) * PF;
#pragma unroll
      for (int i = 0; i < KS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(i * 4 + e) * 32 + lane] = o[i][e];
      mine[KS * 128 + lane] = m0;
      mine[KS * 128 + 32 + lane] = m1;
      mine[KS * 128 + 64 + lane] = l0;
      mine[KS * 128 + 96 + lane] = l1;
    }
    __syncthreads();
    if (split > 0) return;
    const float* first = part + group * (splits - 1) * PF;
    float mm0 = m0, mm1 = m1;
    for (int sp = 1; sp < splits; ++sp) {
      mm0 = fmaxf(mm0, first[(sp - 1) * PF + KS * 128 + lane]);
      mm1 = fmaxf(mm1, first[(sp - 1) * PF + KS * 128 + 32 + lane]);
    }
    const float c0 = exp2f(m0 - mm0);
    const float c1 = exp2f(m1 - mm1);
    mr0 = mm0;
    mr1 = mm1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }
    for (int sp = 1; sp < splits; ++sp) {
      const float* other = first + (sp - 1) * PF;
      const float d0 = exp2f(other[KS * 128 + lane] - mm0);
      const float d1 = exp2f(other[KS * 128 + 32 + lane] - mm1);
      l0 += other[KS * 128 + 64 + lane] * d0;
      l1 += other[KS * 128 + 96 + lane] * d1;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        o[i][0] += other[(i * 4 + 0) * 32 + lane] * d0;
        o[i][1] += other[(i * 4 + 1) * 32 + lane] * d0;
        o[i][2] += other[(i * 4 + 2) * 32 + lane] * d1;
        o[i][3] += other[(i * 4 + 3) * 32 + lane] * d1;
      }
    }
  }

  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const int row0 = q0 + group * 16 + g;
  if (lse != nullptr && t4 == 0) {        // lse2 = m + log2(l) of the whole row, for the backward
    const long long lbase = static_cast<long long>(blockIdx.y) * Tn;
    if (row0 < Tn) lse[lbase + row0] = mr0 + log2f(l0);
    if (row0 + 8 < Tn) lse[lbase + row0 + 8] = mr1 + log2f(l1);
  }
#pragma unroll
  for (int ot = 0; ot < KS; ++ot) {
    const int col = ot * 8 + 2 * t4;
    if (col >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= Tn) continue;
      const float inv = h ? inv1 : inv0;
      float* dst = out + base + static_cast<long long>(row) * D + col;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[ot][2 * h] * inv, o[ot][2 * h + 1] * inv);
      } else {
        dst[0] = o[ot][2 * h] * inv;
        if (col + 1 < D) dst[1] = o[ot][2 * h + 1] * inv;
      }
    }
  }
}

template <int DP>
cudaError_t launch_tf32x3(const float* q, const float* k, const float* v, float* out, float* lse,
                          int BH, int Tn, int D, float scale_log2, int splits, int two_stages,
                          int vec, int pairs, cudaStream_t stream) {
  // dynamic shared memory above 48 KB, allowed once per device (not again
  // while a CUDA graph captures the launches)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((allowed.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(attention_tf32x3_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed.fetch_or(1ULL << dev);
  }
  const int groups = WARPS / splits;
  const int ntiles = (Tn + BK - 1) / BK;
  const int stages = splits * (two_stages && ntiles > splits ? 2 : 1);
  const int rows = 16 * groups;
  const dim3 grid(static_cast<unsigned>((Tn + rows - 1) / rows), static_cast<unsigned>(BH));
  attention_tf32x3_kernel<DP><<<grid, 32 * WARPS, smem_bytes<DP>(groups, splits, stages), stream>>>(
      q, k, v, out, lse, Tn, D, scale_log2, splits, two_stages, vec, pairs);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (BH, T, D) fp32, contiguous on the device; D <= 128; of the
// 4 warps of a block, `splits` (1, 2 or 4, at most 2 for D > 64, at most the
// number of 32-key tiles) split the keys of one row group, each through
// `stages` (1 or 2) shared-memory stages (ops/attention.py::plan);
// `scale_log2` = D^-1/2 * log2(e).  `lse`, when
// not null, receives BH * T floats: each row's log-sum-exp of its scaled
// logits in the kernel's log2 domain, lse2 = m + log2(l), for the backward
// (csrc/attention_bwd_tf32x3.cu); `out` is the same with and without it.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int attention_tf32x3_forward(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int BH, int Tn, int D, float scale_log2,
                                        int splits, int stages, void* stream) {
  const int ntiles = (Tn + BK - 1) / BK;
  const bool ok = D >= 1 && D <= 128 && Tn >= 1 && BH >= 1 && BH <= 65535 &&
                  (splits == 1 || splits == 2 || splits == 4) && splits <= ntiles &&
                  (D <= 64 || splits <= 2) && (stages == 1 || stages == 2);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int vec = (D % 4 == 0 && aligned) ? 1 : 0;
  const int pairs = (D % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0) ? 1 : 0;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  float* lp = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int two = stages == 2 ? 1 : 0;
  const cudaError_t err =
      D <= 64
          ? launch_tf32x3<64>(qp, kp, vp, op, lp, BH, Tn, D, scale_log2, splits, two, vec, pairs, s)
          : launch_tf32x3<128>(qp, kp, vp, op, lp, BH, Tn, D, scale_log2, splits, two, vec, pairs,
                               s);
  return static_cast<int>(err);
}
