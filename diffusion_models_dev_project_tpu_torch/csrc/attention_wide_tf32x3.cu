// Flash self-attention and its backward in fp32 on Hopper's tensor cores
// for heads wider than 128, each product taken as three TF32 products of
// split operands, with the ADM legacy scaling: out = softmax((q * d^-1/4)
// (k * d^-1/4)^T) v, the softmax and every accumulation in fp32.  The
// `tf32x3` variant of ops/attention.py::plan and `backward_plan` for fp32
// with d > 128 (attention_tf32x3.cu and attention_bwd_tf32x3.cu take
// d <= 128).
//
// Replaces, for fp32 and d > 128, the Pallas TPU kernel `_flash_kernel` /
// `flash_attention` of diffusion_models_dev_project_tpu/ops/attention.py,
// which takes any d (zero-padded to a multiple of 8); its backward is what
// XLA derives from the JAX einsum attention at Precision.HIGHEST.  No
// shipped config reaches d > 128; a UNet config with `num_head_channels`
// -1 (guided-diffusion's default) or without it does (d = 256 or 512 at the
// flagship's 512-channel 16² map).
//
// What bounds it on the H100: at (4, 256, 512) the forward is 0.5 GFLOP,
// 1.6 GFLOP of TF32 products, over 8 MB: a few microseconds at either
// peak.  It is bound by latency, as attention_wide_mma.cu, whose design it
// keeps with attention_tf32x3.cu's arithmetic:
//
// - Each block computes one chunk of CW = 128 (or, on large grids, 256)
//   output columns (a third grid axis) and recomputes S over the full
//   padded d, streaming Q and K through shared memory in slices of DS = 64
//   columns; only the block's own columns of V are staged, DC = 128 at a
//   time.  A warp's copies are one sequence of items through a ring of one
//   or two stages.
// - Each operand is split in registers as it is read, hi = v with its low
//   13 bits cleared and lo = v - hi the same, and each 8-wide slice of a
//   product issues hi*hi, hi*lo, lo*hi (`mma.sync.m16n8k8` tf32 -> fp32).
//   The tensor cores' sum truncates, and its error grows with the chain of
//   products in one accumulator (csrc/conv3x3_tf32x3.cu): so each 64-column
//   slice of S and dP adds up in accumulators of its own (24 products, as
//   at d = 64), and the slices' partial sums go into an fp32 total in
//   registers.
// - Every chunk computes S, m and l in the same order, so all chunks hold
//   bitwise the same row statistics; chunk 0 writes lse2 = m + log2(l).
// - The C fragment of S (and of dS) is the A fragment of the next product
//   as it stands: the product takes each slice's 8 keys in the order 0, 2,
//   4, 6, 1, 3, 5, 7 in both operands (mma_common.cuh `b_pairs_split`).
// - The backward keeps attention_bwd_tf32x3.cu's pair: a query pass (dq)
//   and a key pass (dk, dv), fed by lse2, no atomics, 4 warps splitting the
//   walked dimension in chunks of W rows, partial sums added in warp order.
//   Each pass recomputes S and dP over the full d from slices, and writes
//   its chunk of the output columns.  D = rowsum(dO * O) over the full d is
//   computed once per row in the query pass's prologue; chunk 0 writes it.
// - No atomics and fixed orders everywhere: two launches give the same
//   bits.  The kernels run on the caller's stream and allocate nothing.
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"

namespace {

constexpr int WARPS = 4;        // warps per block
constexpr int BK = 32;          // keys per tile of the forward
constexpr int DS = 64;          // columns of q and k (dout, v) per slice
constexpr int DC = 128;         // output columns of a backward block; columns of a staged part of V
constexpr int LDS = DS + FPAD;  // row stride of a slice
constexpr int LDC = DC + FPAD;  // row stride of a column chunk
constexpr int ROWS = 16;        // query (key) rows of a backward block
constexpr int PS = DC + 8;      // floats per row of a backward warp's partial sum

__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }

// forward: floats of one ring stage, the larger of a slice item (Q slice of
// 16 rows per row group, then K slice of BK keys) and a V item (BK x DC: a
// chunk of CW = 256 output columns takes its V in two items)
__host__ __device__ constexpr int fwd_stage(int groups) {
  return max_int((16 * groups + BK) * LDS, BK * LDC);
}
// floats of one warp's partial result for the merge: O, then m and l of two rows, per lane
template <int CW>
__host__ __device__ constexpr int fwd_partial() { return (CW / 8) * 4 * 32 + 4 * 32; }
template <int CW>
__host__ __device__ constexpr int fwd_smem(int groups, int splits, int stages) {
  return 4 * max_int(splits * stages * fwd_stage(groups),
                     groups * (splits - 1) * fwd_partial<CW>());
}
// the most dynamic shared memory a block may take on the card
constexpr int MAX_SMEM = 232448;
constexpr int MAX_STAGES = 2;   // a third stage never paid (PERF.md section 6, PR 19)

// c (16 x W) += the A rows (a shared 16-row slice) times the W rows of a
// shared slice, transposed: S = Q K^T and the like, over the slice's `nks`
// 8-wide column tiles.  The slice's sum runs in accumulators of its own,
// then goes into c in fp32.
template <int W>
__device__ __forceinline__ void slice_product(float (&c)[W / 8][4], const float* a_rows,
                                              const float* b_rows, int nks, int lane) {
  float part[W / 8][4];
#pragma unroll
  for (int i = 0; i < W / 8; ++i) part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DS / 8; ++kc) {
    if (kc < nks) {
      uint32_t ah[4], al[4];
      a_frag_split<LDS>(a_rows, kc, lane, ah, al);
      uint32_t bh[W / 8][2], bl[W / 8][2];
#pragma unroll
      for (int nt = 0; nt < W / 8; ++nt) b_rows_split<LDS>(b_rows, nt * 8, kc, lane, bh[nt], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < W / 8; ++nt) mma_tf32(part[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < W / 8; ++nt) mma_tf32(part[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < W / 8; ++nt) mma_tf32(part[nt], al, bh[nt][0], bh[nt][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    c[i][0] += part[i][0];
    c[i][1] += part[i][1];
    c[i][2] += part[i][2];
    c[i][3] += part[i][3];
  }
}

// The backward's two products of a slice at once: s (16 x W) += A_s rows
// times the W rows of B_s, transposed, and dp the same for (A_dp, B_dp): S =
// Q K^T with dP = dO V^T, or S^T = K Q^T with dP^T = V dO^T.  Per 8-wide
// slice of d and 8-row tile the two products' hi*hi, hi*lo, lo*hi
// alternate, in accumulators of the slice's own (`slice_product`); a full
// slice (`FULL`) runs without a per-tile test
template <int W, bool FULL>
__device__ __forceinline__ void slice_products(float (&s)[W / 8][4], float (&dp)[W / 8][4],
                                               const float* a_s, const float* a_dp,
                                               const float* b_s, const float* b_dp, int nks,
                                               int lane) {
  float ps[W / 8][4], pd[W / 8][4];
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    ps[i][0] = ps[i][1] = ps[i][2] = ps[i][3] = 0.f;
    pd[i][0] = pd[i][1] = pd[i][2] = pd[i][3] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < DS / 8; ++kc) {
    if (FULL || kc < nks) {
      uint32_t xh[4], xl[4], yh[4], yl[4];
      a_frag_split<LDS>(a_s, kc, lane, xh, xl);
      a_frag_split<LDS>(a_dp, kc, lane, yh, yl);
#pragma unroll
      for (int nt = 0; nt < W / 8; ++nt) {
        uint32_t bh[2], bl[2], ch[2], cl[2];
        b_rows_split<LDS>(b_s, nt * 8, kc, lane, bh, bl);
        b_rows_split<LDS>(b_dp, nt * 8, kc, lane, ch, cl);
        mma_tf32(ps[nt], xh, bh[0], bh[1]);
        mma_tf32(pd[nt], yh, ch[0], ch[1]);
        mma_tf32(ps[nt], xh, bl[0], bl[1]);
        mma_tf32(pd[nt], yh, cl[0], cl[1]);
        mma_tf32(ps[nt], xl, bh[0], bh[1]);
        mma_tf32(pd[nt], yl, ch[0], ch[1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[i][e] += ps[i][e];
      dp[i][e] += pd[i][e];
    }
  }
}

// acc (16 x CW) += a (16 x 8 walked rows k0 .., split) * rows k0 .. k0 + 7
// of a shared DC-wide tile, for the DC output columns of part `part` of the
// chunk, in `b_pairs_split`'s order; per group of 4 column tiles, hi*hi over
// the 4, then hi*lo, then lo*hi; tiles past `ncol` skipped
template <int CW = DC>
__device__ __forceinline__ void pairs_product(float (&acc)[CW / 8][4], const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], const float* rows, int k0,
                                              int ncol, int lane, int part = 0) {
#pragma unroll
  for (int ot0 = 0; ot0 < CW / 8; ot0 += 4) {
    if (ot0 / (DC / 8) == part && ot0 * 8 < ncol) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b_pairs_split<LDC>(rows, k0, (ot0 + i) * 8 - part * DC, lane, bh[i], bl[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[ot0 + i], ah, bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[ot0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[ot0 + i], al, bh[i][0], bh[i][1]);
    }
  }
}

// Forward.  Block (x, y, z): query rows of row groups x, head y, output
// columns CW z ..  The warps of split s take key tiles s, s + splits, ...
// with their own online softmax, stream their items through their own
// stages and sync on their own named barrier.
template <int CW>
__global__ void __launch_bounds__(32 * WARPS)
attention_tf32x3_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out,
                             float* __restrict__ lse, int Tn, int D, float scale_log2, int splits,
                             int nstages, int vec, int pairs) {
  constexpr int ST = BK / 8;        // 8-key column tiles of S
  constexpr int OT = CW / 8;        // 8-wide column tiles of the chunk
  constexpr int PF = fwd_partial<CW>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int groups = WARPS / splits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = warp / groups;
  const int group = warp - split * groups;
  const int gthreads = 32 * groups;
  const int gtid = threadIdx.x - split * gthreads;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int dpad = (D + 7) & ~7;
  const int nsl = (dpad + DS - 1) / DS;
  const int c0 = blockIdx.z * CW;
  const int ncol = min(CW, dpad - c0);
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const int q0 = blockIdx.x * 16 * groups;
  const int ntiles = (Tn + BK - 1) / BK;
  const int per = nsl + CW / DC;                      // the slices, then V's parts
  const int items = (ntiles - split + splits - 1) / splits * per;
  const int stage_elems = fwd_stage(groups);
  float* stages = ring + split * nstages * stage_elems;    // this split's ring
  const bool vec_ok = vec != 0;
  const auto split_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(split + 1), "r"(gthreads) : "memory");
  };
  const auto load_item = [&](float* stage, int n) {
    const int j = split + n / per * splits;
    const int r = n % per;
    if (r < nsl) {
      load_cols<DS, LDS>(stage, q + base, q0, 16 * groups, r * DS, Tn, D, vec_ok, gtid, gthreads);
      load_cols<DS, LDS>(stage + 16 * groups * LDS, k + base, j * BK, BK, r * DS, Tn, D, vec_ok,
                         gtid, gthreads);
    } else {
      load_cols<DC, LDC>(stage, v + base, j * BK, BK, c0 + (r - nsl) * DC, Tn, D, vec_ok, gtid,
                         gthreads);
    }
  };

  float o[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  float s[ST][4];

  // items 0 .. nstages - 2 ahead; then each round issues item n + nstages - 1
  // into the stage that item n - 1 left (one copy group a round, empty past
  // the end)
  for (int i = 0; i + 1 < nstages; ++i) {
    if (i < items) load_item(stages + i * stage_elems, i);
    cp_async_commit();
  }
  for (int n = 0; n < items; ++n) {
    const int ahead = n + nstages - 1;
    if (ahead < items) load_item(stages + ahead % nstages * stage_elems, ahead);
    cp_async_commit();
    if (nstages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    split_sync();                         // item n has landed
    const float* st = stages + n % nstages * stage_elems;
    const int r = n % per;
    if (r < nsl) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < ST; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      }
      slice_product<BK>(s, st + group * 16 * LDS, st + 16 * groups * LDS,
                        min(DS, dpad - r * DS) / 8, lane);
      if (r == nsl - 1) {                 // S is whole: scale, mask, online softmax
        const int k0 = (split + n / per * splits) * BK;
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
        const float a0 = exp2f(m0 - mn0);
        const float a1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int i = 0; i < OT; ++i) {
          o[i][0] *= a0;
          o[i][1] *= a0;
          o[i][2] *= a1;
          o[i][3] *= a1;
        }
        // P = exp2(S - m) in fp32, kept in s; the row sums from it
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) {
          s[nt][0] = exp2f(s[nt][0] - mn0);
          s[nt][1] = exp2f(s[nt][1] - mn0);
          s[nt][2] = exp2f(s[nt][2] - mn1);
          s[nt][3] = exp2f(s[nt][3] - mn1);
          l0 += s[nt][0] + s[nt][1];
          l1 += s[nt][2] + s[nt][3];
        }
      }
    } else {
      // O += P V_chunk, 8 keys at a time in `b_pairs_split`'s order
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        uint32_t ph[4], pl[4];
        a_from_c(s[nt][0], s[nt][1], s[nt][2], s[nt][3], ph, pl);
        pairs_product<CW>(o, ph, pl, st, nt * 8, ncol, lane, r - nsl);
      }
    }
    split_sync();                         // the stage may be refilled
  }
  __syncthreads();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  float mr0 = m0, mr1 = m1;
  if (splits > 1) {
    float* part = ring;
    if (split > 0) {
      float* mine = part + (group * (splits - 1) + split - 1) * PF;
#pragma unroll
      for (int i = 0; i < OT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(i * 4 + e) * 32 + lane] = o[i][e];
      mine[OT * 128 + lane] = m0;
      mine[OT * 128 + 32 + lane] = m1;
      mine[OT * 128 + 64 + lane] = l0;
      mine[OT * 128 + 96 + lane] = l1;
    }
    __syncthreads();
    if (split > 0) return;
    const float* first = part + group * (splits - 1) * PF;
    float mm0 = m0, mm1 = m1;
    for (int sp = 1; sp < splits; ++sp) {
      mm0 = fmaxf(mm0, first[(sp - 1) * PF + OT * 128 + lane]);
      mm1 = fmaxf(mm1, first[(sp - 1) * PF + OT * 128 + 32 + lane]);
    }
    const float c0f = exp2f(m0 - mm0);
    const float c1f = exp2f(m1 - mm1);
    mr0 = mm0;
    mr1 = mm1;
    l0 *= c0f;
    l1 *= c1f;
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      o[i][0] *= c0f;
      o[i][1] *= c0f;
      o[i][2] *= c1f;
      o[i][3] *= c1f;
    }
    for (int sp = 1; sp < splits; ++sp) {
      const float* other = first + (sp - 1) * PF;
      const float d0 = exp2f(other[OT * 128 + lane] - mm0);
      const float d1 = exp2f(other[OT * 128 + 32 + lane] - mm1);
      l0 += other[OT * 128 + 64 + lane] * d0;
      l1 += other[OT * 128 + 96 + lane] * d1;
#pragma unroll
      for (int i = 0; i < OT; ++i) {
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
  if (lse != nullptr && blockIdx.z == 0 && t4 == 0) {
    const long long lbase = static_cast<long long>(blockIdx.y) * Tn;
    if (row0 < Tn) lse[lbase + row0] = mr0 + log2f(l0);
    if (row0 + 8 < Tn) lse[lbase + row0 + 8] = mr1 + log2f(l1);
  }
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    const int col = c0 + ot * 8 + 2 * t4;
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

// ---- backward

// floats of one stage of a backward warp: the larger of a slice item (the
// block's 16 rows of two operands, then the walked chunk's W rows of two,
// DS columns each) and a column-chunk item (W rows x DC)
template <int W>
__host__ __device__ constexpr int bwd_stage() { return max_int((2 * ROWS + 2 * W) * LDS, W * LDC); }
// bytes: the block's D (16 floats), then the ring, whose bytes later hold
// the warps' partial sums of `outputs` chunks
template <int W>
__host__ __device__ constexpr int bwd_smem(int stages, int outputs) {
  return ROWS * 4 + 4 * max_int(WARPS * stages * bwd_stage<W>(), outputs * WARPS * ROWS * PS);
}

__device__ __forceinline__ void store_partial(float* slot, const float (&acc)[DC / 8][4], int lane) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int ot = 0; ot < DC / 8; ++ot) {
    const int col = ot * 8 + 2 * t4;
    *reinterpret_cast<float2*>(slot + g * PS + col) = make_float2(acc[ot][0], acc[ot][1]);
    *reinterpret_cast<float2*>(slot + (g + 8) * PS + col) = make_float2(acc[ot][2], acc[ot][3]);
  }
}

// out rows r0 .. r0 + 15 (those < T), columns c0 .. c0 + width - 1 = mul *
// the warps' partial sums, added in warp order; by the whole block
__device__ __forceinline__ void combine_store(float* out, const float* parts, int r0, int Tn, int D,
                                              int c0, int width, float mul) {
  for (int e = threadIdx.x; e < ROWS * width; e += 32 * WARPS) {
    const int r = e / width;
    const int c = e - r * width;
    if (r0 + r >= Tn) break;
    const float* p = parts + r * PS + c;
    float sum = p[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += p[w * ROWS * PS];
    out[static_cast<long long>(r0 + r) * D + c0 + c] = sum * mul;
  }
}

// Query pass: block (x, y, z) takes query rows 16x .. 16x + 15 of head y and
// output columns 128 z ..: D of its rows over the full d (chunk 0 writes it
// to `delta`) and dq_chunk = scale * sum over keys of dS k_chunk.  Warp w
// walks key chunks w, w + 4, ... of W keys; per chunk its items are the
// slices (q, dout, k, v), then k's column chunk.
template <int W>
__global__ void __launch_bounds__(32 * WARPS)
attention_bwd_tf32x3_wide_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ o,
                                    const float* __restrict__ dout, const float* __restrict__ lse2,
                                    float* __restrict__ dq, float* __restrict__ delta, int Tn,
                                    int D, float scale_log2, float scale, int nstages,
                                    int vec) {
  constexpr int NT = W / 8;
  constexpr int STAGE = bwd_stage<W>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ds = reinterpret_cast<float*>(smem_raw);
  float* ring = Ds + ROWS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int dpad = (D + 7) & ~7;
  const int nsl = (dpad + DS - 1) / DS;
  const int c0 = blockIdx.z * DC;
  const int ncol = min(DC, dpad - c0);
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * Tn;
  const int q0 = blockIdx.x * ROWS;
  const int nchunks = (Tn + W - 1) / W;
  const int per = nsl + 1;
  const int items = (nchunks - warp + WARPS - 1) / WARPS * per;
  float* stages = ring + warp * nstages * STAGE;      // this warp's ring
  const bool vec_ok = vec != 0;
  const auto load_item = [&](float* stage, int n) {
    const int j = warp + n / per * WARPS;
    const int r = n % per;
    if (r < nsl) {
      load_cols<DS, LDS>(stage, q + base, q0, ROWS, r * DS, Tn, D, vec_ok, lane, 32);
      load_cols<DS, LDS>(stage + ROWS * LDS, dout + base, q0, ROWS, r * DS, Tn, D, vec_ok, lane, 32);
      load_cols<DS, LDS>(stage + 2 * ROWS * LDS, k + base, j * W, W, r * DS, Tn, D, vec_ok, lane,
                         32);
      load_cols<DS, LDS>(stage + (2 * ROWS + W) * LDS, v + base, j * W, W, r * DS, Tn, D, vec_ok,
                         lane, 32);
    } else {
      load_cols<DC, LDC>(stage, k + base, j * W, W, c0, Tn, D, vec_ok, lane, 32);
    }
  };
  for (int i = 0; i + 1 < nstages; ++i) {   // items 0 .. nstages - 2 ahead
    if (i < items) load_item(stages + i * STAGE, i);
    cp_async_commit();
  }

  {  // D = rowsum(dout * o) over the full d: 8 threads a row, in a fixed order
    const int r = threadIdx.x >> 3;
    const int part = threadIdx.x & 7;
    float acc = 0.f;
    if (q0 + r < Tn) {
      const float* gr = dout + base + static_cast<long long>(q0 + r) * D;
      const float* orow = o + base + static_cast<long long>(q0 + r) * D;
      if (vec_ok) {                         // 16-byte loads, 4 columns each
#pragma unroll 8
        for (int c = part * 4; c < D; c += 32) {
          const float4 a = *reinterpret_cast<const float4*>(gr + c);
          const float4 b = *reinterpret_cast<const float4*>(orow + c);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      } else {
#pragma unroll 4
        for (int c = part; c < D; c += 8) acc = fmaf(gr[c], orow[c], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (part == 0) {
      Ds[r] = acc;
      if (blockIdx.z == 0 && q0 + r < Tn) delta[rbase + q0 + r] = acc;
    }
  }
  __syncthreads();

  const float lse_a = q0 + g < Tn ? lse2[rbase + q0 + g] : 0.f;
  const float lse_b = q0 + g + 8 < Tn ? lse2[rbase + q0 + g + 8] : 0.f;
  const float d_a = Ds[g];
  const float d_b = Ds[g + 8];
  float acc[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float s[NT][4], dp[NT][4];

  for (int n = 0; n < items; ++n) {
    const int ahead = n + nstages - 1;      // into the stage that item n - 1 left
    if (ahead < items) load_item(stages + ahead % nstages * STAGE, ahead);
    cp_async_commit();
    if (nstages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();                           // item n has landed for the whole warp
    const float* st = stages + n % nstages * STAGE;
    const int r = n % per;
    if (r < nsl) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
          dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
        }
      }
      const int nks = min(DS, dpad - r * DS) / 8;
      // S += Q K^T and dP += dO V^T
      if (nks == DS / 8) {
        slice_products<W, true>(s, dp, st, st + ROWS * LDS, st + 2 * ROWS * LDS,
                                st + (2 * ROWS + W) * LDS, nks, lane);
      } else {
        slice_products<W, false>(s, dp, st, st + ROWS * LDS, st + 2 * ROWS * LDS,
                                 st + (2 * ROWS + W) * LDS, nks, lane);
      }
      if (r == nsl - 1) {
        // P = exp2(S * scale_log2 - lse2) (0 past T), dS = P (dP - D), kept in s
        const int j = warp + n / per * WARPS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int key = j * W + nt * 8 + 2 * t4;
          const bool in0 = key < Tn;
          const bool in1 = key + 1 < Tn;
          const float p0 = in0 ? exp2f(s[nt][0] * scale_log2 - lse_a) : 0.f;
          const float p1 = in1 ? exp2f(s[nt][1] * scale_log2 - lse_a) : 0.f;
          const float p2 = in0 ? exp2f(s[nt][2] * scale_log2 - lse_b) : 0.f;
          const float p3 = in1 ? exp2f(s[nt][3] * scale_log2 - lse_b) : 0.f;
          s[nt][0] = p0 * (dp[nt][0] - d_a);
          s[nt][1] = p1 * (dp[nt][1] - d_a);
          s[nt][2] = p2 * (dp[nt][2] - d_b);
          s[nt][3] = p3 * (dp[nt][3] - d_b);
        }
      }
    } else {
      // dq_chunk += dS K_chunk, 8 keys at a time
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t dh[4], dl[4];
        a_from_c(s[nt][0], s[nt][1], s[nt][2], s[nt][3], dh, dl);
        pairs_product(acc, dh, dl, st, nt * 8, ncol, lane);
      }
    }
    __syncwarp();                           // the stage may be refilled
  }
  __syncthreads();
  store_partial(ring + warp * ROWS * PS, acc, lane);
  __syncthreads();
  combine_store(dq + base, ring, q0, Tn, D, c0, min(DC, D - c0), scale);
}

// Key pass: block (x, y, z) takes key rows 16x .. 16x + 15 of head y and
// output columns 128 z ..: dv_chunk = sum over queries of P^T dout_chunk,
// dk_chunk = scale * sum of dS^T q_chunk.  Warp w walks query chunks w, w +
// 4, ... of W queries with their lse2 and D; per chunk its items are the
// slices (k, v, q, dout), then dout's column chunk, then q's.
template <int W>
__global__ void __launch_bounds__(32 * WARPS)
attention_bwd_tf32x3_wide_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v, const float* __restrict__ dout,
                                      const float* __restrict__ lse2,
                                      const float* __restrict__ delta, float* __restrict__ dk,
                                      float* __restrict__ dv, int Tn, int D, float scale_log2,
                                      float scale, int nstages, int vec) {
  constexpr int NT = W / 8;
  constexpr int STAGE = bwd_stage<W>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw) + ROWS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int dpad = (D + 7) & ~7;
  const int nsl = (dpad + DS - 1) / DS;
  const int c0 = blockIdx.z * DC;
  const int ncol = min(DC, dpad - c0);
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * Tn;
  const int k0 = blockIdx.x * ROWS;
  const int nchunks = (Tn + W - 1) / W;
  // dout's and q's column chunks in one stage when they fit (W = 16)
  constexpr bool MERGED = 2 * W * LDC <= STAGE;
  const int per = nsl + (MERGED ? 1 : 2);
  const int items = (nchunks - warp + WARPS - 1) / WARPS * per;
  float* stages = ring + warp * nstages * STAGE;      // this warp's ring
  const bool vec_ok = vec != 0;
  const auto load_item = [&](float* stage, int n) {
    const int i = warp + n / per * WARPS;
    const int r = n % per;
    if (r < nsl) {
      load_cols<DS, LDS>(stage, k + base, k0, ROWS, r * DS, Tn, D, vec_ok, lane, 32);
      load_cols<DS, LDS>(stage + ROWS * LDS, v + base, k0, ROWS, r * DS, Tn, D, vec_ok, lane, 32);
      load_cols<DS, LDS>(stage + 2 * ROWS * LDS, q + base, i * W, W, r * DS, Tn, D, vec_ok, lane,
                         32);
      load_cols<DS, LDS>(stage + (2 * ROWS + W) * LDS, dout + base, i * W, W, r * DS, Tn, D,
                         vec_ok, lane, 32);
    } else if (MERGED) {
      load_cols<DC, LDC>(stage, dout + base, i * W, W, c0, Tn, D, vec_ok, lane, 32);
      load_cols<DC, LDC>(stage + W * LDC, q + base, i * W, W, c0, Tn, D, vec_ok, lane, 32);
    } else {
      load_cols<DC, LDC>(stage, (r == nsl ? dout : q) + base, i * W, W, c0, Tn, D, vec_ok, lane,
                         32);
    }
  };
  for (int i = 0; i + 1 < nstages; ++i) {   // items 0 .. nstages - 2 ahead
    if (i < items) load_item(stages + i * STAGE, i);
    cp_async_commit();
  }

  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }
  float s[NT][4], dp[NT][4];

  for (int n = 0; n < items; ++n) {
    const int ahead = n + nstages - 1;      // into the stage that item n - 1 left
    if (ahead < items) load_item(stages + ahead % nstages * STAGE, ahead);
    cp_async_commit();
    if (nstages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();                           // item n has landed for the whole warp
    const float* st = stages + n % nstages * STAGE;
    const int r = n % per;
    if (r < nsl) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
          dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
        }
      }
      const int nks = min(DS, dpad - r * DS) / 8;
      // S^T += K Q^T and dP^T += V dO^T
      if (nks == DS / 8) {
        slice_products<W, true>(s, dp, st, st + ROWS * LDS, st + 2 * ROWS * LDS,
                                st + (2 * ROWS + W) * LDS, nks, lane);
      } else {
        slice_products<W, false>(s, dp, st, st + ROWS * LDS, st + 2 * ROWS * LDS,
                                 st + (2 * ROWS + W) * LDS, nks, lane);
      }
      if (r == nsl - 1) {
        // P^T in s (0 for queries past T), dS^T = P^T (dP^T - D) in dp
        const int i = warp + n / per * WARPS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int qc = i * W + nt * 8 + 2 * t4;
          const bool in0 = qc < Tn;
          const bool in1 = qc + 1 < Tn;
          const float l0 = in0 ? lse2[rbase + qc] : 0.f;
          const float l1 = in1 ? lse2[rbase + qc + 1] : 0.f;
          const float e0 = in0 ? delta[rbase + qc] : 0.f;
          const float e1 = in1 ? delta[rbase + qc + 1] : 0.f;
          s[nt][0] = in0 ? exp2f(s[nt][0] * scale_log2 - l0) : 0.f;
          s[nt][1] = in1 ? exp2f(s[nt][1] * scale_log2 - l1) : 0.f;
          s[nt][2] = in0 ? exp2f(s[nt][2] * scale_log2 - l0) : 0.f;
          s[nt][3] = in1 ? exp2f(s[nt][3] * scale_log2 - l1) : 0.f;
          dp[nt][0] = s[nt][0] * (dp[nt][0] - e0);
          dp[nt][1] = s[nt][1] * (dp[nt][1] - e1);
          dp[nt][2] = s[nt][2] * (dp[nt][2] - e0);
          dp[nt][3] = s[nt][3] * (dp[nt][3] - e1);
        }
      }
    } else {
      // r == nsl: dv_chunk += P^T dO_chunk (and, merged, dk_chunk += dS^T
      // Q_chunk from the stage's second half); r == nsl + 1: dk_chunk alone
      const bool dv_item = r == nsl;
      const bool dk_item = MERGED || !dv_item;
      const float* qc = MERGED ? st + W * LDC : st;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t ah[4], al[4];
        if (dv_item) {
          a_from_c(s[nt][0], s[nt][1], s[nt][2], s[nt][3], ah, al);
          pairs_product(dva, ah, al, st, nt * 8, ncol, lane);
        }
        if (dk_item) {
          a_from_c(dp[nt][0], dp[nt][1], dp[nt][2], dp[nt][3], ah, al);
          pairs_product(dka, ah, al, qc, nt * 8, ncol, lane);
        }
      }
    }
    __syncwarp();                           // the stage may be refilled
  }
  __syncthreads();
  constexpr int OUT = WARPS * ROWS * PS;
  store_partial(ring + warp * ROWS * PS, dka, lane);
  store_partial(ring + OUT + warp * ROWS * PS, dva, lane);
  __syncthreads();
  const int width = min(DC, D - c0);
  combine_store(dk + base, ring, k0, Tn, D, c0, width, scale);
  combine_store(dv + base, ring + OUT, k0, Tn, D, c0, width, 1.f);
}

template <typename K>
cudaError_t allow_smem(std::atomic<unsigned long long>& allowed, K kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((allowed.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed.fetch_or(1ULL << dev);
  }
  return cudaSuccess;
}

template <int W>
cudaError_t launch_backward(const float* q, const float* k, const float* v, const float* o,
                            const float* dout, const float* lse2, float* dq, float* dk, float* dv,
                            float* delta, int BH, int Tn, int D, float scale_log2, float scale,
                            int nstages, int vec, cudaStream_t stream) {
  static std::atomic<unsigned long long> allowed_dq{0}, allowed_kv{0};
  cudaError_t err =
      allow_smem(allowed_dq, attention_bwd_tf32x3_wide_dq_kernel<W>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  err = allow_smem(allowed_kv, attention_bwd_tf32x3_wide_dkdv_kernel<W>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  const int chunks = (((D + 7) & ~7) + DC - 1) / DC;
  const dim3 grid(static_cast<unsigned>((Tn + ROWS - 1) / ROWS), static_cast<unsigned>(BH),
                  static_cast<unsigned>(chunks));
  attention_bwd_tf32x3_wide_dq_kernel<W><<<grid, 32 * WARPS, bwd_smem<W>(nstages, 1), stream>>>(
      q, k, v, o, dout, lse2, dq, delta, Tn, D, scale_log2, scale, nstages, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_tf32x3_wide_dkdv_kernel<W><<<grid, 32 * WARPS, bwd_smem<W>(nstages, 2), stream>>>(
      q, k, v, dout, lse2, delta, dk, dv, Tn, D, scale_log2, scale, nstages, vec);
  return cudaGetLastError();
}

template <int CW>
cudaError_t launch_forward(const float* q, const float* k, const float* v, float* out, float* lse, int BH,
                           int Tn, int D, float scale_log2, int splits, int stages, int vec, int pairs,
                           cudaStream_t stream) {
  const int groups = WARPS / splits;
  if (fwd_smem<CW>(groups, splits, stages) > MAX_SMEM) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> allowed{0};
  const cudaError_t err = allow_smem(allowed, attention_tf32x3_wide_kernel<CW>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  const int rows = 16 * groups;
  const int chunks = (((D + 7) & ~7) + CW - 1) / CW;
  const dim3 grid(static_cast<unsigned>((Tn + rows - 1) / rows), static_cast<unsigned>(BH),
                  static_cast<unsigned>(chunks));
  attention_tf32x3_wide_kernel<CW><<<grid, 32 * WARPS, fwd_smem<CW>(groups, splits, stages), stream>>>(
      q, k, v, out, lse, Tn, D, scale_log2, splits, stages, vec, pairs);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (BH, T, D) fp32, contiguous on the device, D > 128; of the 4
// warps of a block, `splits` (1, 2 or 4, at most the number of 32-key
// tiles) split the keys of one row group, each through `stages` (1 or 2)
// ring stages; each block computes `chunk` (128 or 256) output columns
// (ops/attention.py::plan); `scale_log2` = D^-1/2 * log2(e).  `lse`, when
// not null, receives BH * T floats, each row's lse2 = m + log2(l) in the
// kernel's log2 domain, for the backward; `out` is the same with and
// without it.  Grid: (row blocks, BH, ceil(D_pad / chunk)).  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int attention_tf32x3_wide_forward(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int BH, int Tn, int D, float scale_log2,
                                          int splits, int stages, int chunk, void* stream) {
  const int ntiles = (Tn + BK - 1) / BK;
  const bool ok = D > 128 && Tn >= 1 && BH >= 1 && BH <= 65535 &&
                  (splits == 1 || splits == 2 || splits == 4) && splits <= ntiles &&
                  stages >= 1 && stages <= MAX_STAGES;
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
  cudaError_t err = cudaErrorInvalidValue;
  if (chunk == 128) {
    err = launch_forward<128>(qp, kp, vp, op, lp, BH, Tn, D, scale_log2, splits, stages, vec, pairs, s);
  } else if (chunk == 256) {
    err = launch_forward<256>(qp, kp, vp, op, lp, BH, Tn, D, scale_log2, splits, stages, vec, pairs, s);
  }
  return static_cast<int>(err);
}

// q, k, v, o (the forward's output), dout and dq, dk, dv: (BH, T, D) fp32,
// contiguous on the device, D > 128; `lse2` the forward's BH * T row
// statistics (attention_tf32x3_wide_forward); `delta` a workspace of BH * T
// floats (it receives D = rowsum(dout * o)).  `tile` is W, the rows of a
// warp's chunk of the walked dimension: 16 or 32; `stages` (1 or 2) a warp's
// ring stages (ops/attention.py::backward_plan).  `scale_log2` = D^-1/2 *
// log2(e), `scale` = D^-1/2.  Launches two kernels on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int attention_tf32x3_wide_backward(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const void* lse2,
                                              void* dq, void* dk, void* dv, void* delta, int BH,
                                              int Tn, int D, float scale_log2, float scale,
                                              int tile, int stages, void* stream) {
  if (D <= 128 || Tn < 1 || BH < 1 || BH > 65535 || stages < 1 || stages > MAX_STAGES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  const int vec = (D % 4 == 0 && aligned) ? 1 : 0;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* op = static_cast<const float*>(o);
  const float* gp = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse2);
  float* dqp = static_cast<float*>(dq);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  float* ws = static_cast<float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tile == 16) {
    err = launch_backward<16>(qp, kp, vp, op, gp, lp, dqp, dkp, dvp, ws, BH, Tn, D, scale_log2,
                              scale, stages, vec, s);
  } else if (tile == 32) {
    err = launch_backward<32>(qp, kp, vp, op, gp, lp, dqp, dkp, dvp, ws, BH, Tn, D, scale_log2,
                              scale, stages, vec, s);
  }
  return static_cast<int>(err);
}
