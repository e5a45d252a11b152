// Flash self-attention and its backward on Hopper's tensor cores for heads
// wider than 128, bf16 in and out, with the ADM legacy scaling:
// out = softmax((q * d^-1/4) (k * d^-1/4)^T) v, the softmax and every
// accumulation in fp32.  The `mma` variant of ops/attention.py::plan and
// `backward_plan` for bf16 with d > 128 (attention_mma.cu and
// attention_bwd_mma.cu take d <= 128).
//
// Replaces, for bf16 and d > 128, the Pallas TPU kernel `_flash_kernel` /
// `flash_attention` of diffusion_models_dev_project_tpu/ops/attention.py,
// which takes any d (zero-padded to a multiple of 8); its backward is what
// XLA derives from the JAX einsum attention.  No shipped config reaches
// d > 128 (both set 64 channels a head); a UNet config without
// `num_head_channels`, or with -1 (guided-diffusion's default), runs one
// head per `num_heads` over all channels: d = 256 or 512 at the flagship's
// 512-channel 16² map.
//
// What bounds it on the H100: at (4, 256, 512) the forward is 0.5 GFLOP
// over 4 MB, a microsecond at either peak.  Like the narrow kernels it is
// bound by latency: the launch, the chain of tiles each warp walks, and how
// many SMs the grid reaches.  What the design does about it:
//
// - Registers limit the width: a warp keeps its 16 rows' output in
//   registers, 64 fp32 a thread for 128 columns.  So each block computes
//   one chunk of CW = 128 (or, on large grids, 256) output columns, a third
//   grid axis over ceil(d_pad / CW) chunks, and recomputes S = Q K^T over
//   the full padded d: ceil(d / CW) times the Q K^T work of one pass
//   (PERF.md, section 6, says how much time it costs).
// - Q and K stream through shared memory in slices of DS = 64 columns; S
//   adds up in the m16n8 accumulators across the slices.  Only the block's
//   own columns of V are staged, DC = 128 at a time.  A warp's copies are
//   items in one sequence (per key tile: the slices of Q and K, then V's
//   parts), through a ring of one or two stages: with two, item n + 1
//   lands while item n is computed.
// - Every chunk computes S, the running max m and the sum l in the same
//   order, so all chunks hold bitwise the same row statistics; chunk 0
//   writes lse2 = m + log2(l) for the backward.
// - The rest is attention_mma.cu's: `mma.sync.m16n8k16` bf16 x bf16 ->
//   fp32, 16 query rows a warp, the keys of a row group split over the
//   block's 4 warps (each split its own online softmax in the exp2 domain,
//   merged in split order), keys past T at -1e30, P rounded to bf16 in
//   registers for P V, rows padded by 16 bytes against bank conflicts.
// - The backward keeps attention_bwd_mma.cu's pair: a query pass (dq) and
//   a key pass (dk, dv), fed by lse2, no atomics, the 4 warps of a block
//   splitting the walked dimension in chunks of W rows and their partial
//   sums added in warp order.  Each pass recomputes S and dP = dO V^T over
//   the full d from slices, and writes its chunk of the output columns:
//   dq_chunk = dS K_chunk; dk_chunk = dS^T Q_chunk and dv_chunk =
//   P^T dO_chunk.  D = rowsum(dO * O) over the full d is computed once per
//   row in the query pass's prologue (chunk 0 writes it for the key pass).
// - No atomics and fixed orders everywhere: two launches give the same
//   bits.  The kernels run on the caller's stream and allocate nothing.
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"

namespace {

constexpr int WARPS = 4;        // warps per block
constexpr int BK = 64;          // keys per tile of the forward
constexpr int DS = 64;          // columns of q and k (dout, v) per slice
constexpr int DC = 128;         // output columns of a backward block; columns of a staged part of V
constexpr int LDS = DS + PAD;   // row stride of a slice
constexpr int LDC = DC + PAD;   // row stride of a column chunk
constexpr int ROWS = 16;        // query (key) rows of a backward block
constexpr int PS = DC + 8;      // floats per row of a backward warp's partial sum

__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }

// forward: bf16 of one ring stage, the larger of a slice item (Q slice of 16
// rows per row group, then K slice of BK keys) and a V item (BK x DC: a
// chunk of CW = 256 output columns takes its V in two items)
__host__ __device__ constexpr int fwd_stage(int groups) {
  return max_int((16 * groups + BK) * LDS, BK * LDC);
}
// floats of one warp's partial result for the merge: O, then m and l of two rows, per lane
template <int CW>
__host__ __device__ constexpr int fwd_partial() { return (CW / 8) * 4 * 32 + 4 * 32; }
template <int CW>
__host__ __device__ constexpr int fwd_smem(int groups, int splits, int stages) {
  return max_int(splits * stages * fwd_stage(groups) * 2,
                 groups * (splits - 1) * fwd_partial<CW>() * 4);
}
// the most dynamic shared memory a block may take on the card
constexpr int MAX_SMEM = 232448;
constexpr int MAX_STAGES = 2;   // a third stage never paid (PERF.md section 6, PR 19)

// DS / 16 16-wide column chunks of the A rows (a shared 16-row slice) times
// the W rows of a shared slice, transposed, into c: S = Q K^T and the like
template <int W>
__device__ __forceinline__ void slice_product(float (&c)[W / 8][4], const bf16* a_rows,
                                              const bf16* b_rows, int nkc, int lane) {
#pragma unroll
  for (int kc = 0; kc < DS / 16; ++kc) {
    if (kc < nkc) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(a_rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + kc * 16 +
                              (lane >> 4) * 8));
#pragma unroll
      for (int nt = 0; nt < W / 8; nt += 2) {
        uint32_t b[4];
        const int r = nt * 8 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(b, smem_u32(b_rows + r * LDS + kc * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(c[nt], a, b[0], b[1]);
        mma_bf16(c[nt + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc (16 x CW) += a (16 x W, bf16 A fragments) * rows for the DC output
// columns of part `part` of the chunk: the W rows of a shared DC-wide tile
// read transposed; column tiles past `ncol` skipped
template <int W, int CW = DC>
__device__ __forceinline__ void chunk_product(float (&acc)[CW / 8][4],
                                              const uint32_t (&a)[W / 16][4], const bf16* rows,
                                              int ncol, int lane, int part = 0) {
#pragma unroll
  for (int c = 0; c < W / 16; ++c) {
#pragma unroll
    for (int ot = 0; ot < CW / 8; ot += 2) {
      if (ot / (DC / 8) == part && ot * 8 < ncol) {
        uint32_t b[4];
        const int r = c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, smem_u32(rows + r * LDC + ot * 8 - part * DC + (lane >> 4) * 8));
        mma_bf16(acc[ot], a[c], b[0], b[1]);
        mma_bf16(acc[ot + 1], a[c], b[2], b[3]);
      }
    }
  }
}

// Forward.  Block (x, y, z): query rows of row groups x, head y, output
// columns CW z ..  The warps of split s (warps s*groups ..) take key tiles
// s, s + splits, ... with their own online softmax, stream their items
// through their own stages and sync on their own named barrier.
template <int CW>
__global__ void __launch_bounds__(32 * WARPS)
attention_mma_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          float* __restrict__ lse, int Tn, int D, float scale_log2, int splits,
                          int nstages, int vec) {
  constexpr int ST = BK / 8;        // 8-key column tiles of S
  constexpr int OT = CW / 8;        // 8-wide column tiles of the chunk
  constexpr int PF = fwd_partial<CW>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int groups = WARPS / splits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = warp / groups;
  const int group = warp - split * groups;
  const int gthreads = 32 * groups;                  // threads of this split
  const int gtid = threadIdx.x - split * gthreads;
  const int g = lane >> 2;          // C-fragment rows g and g + 8
  const int t4 = lane & 3;          // C-fragment columns 2*t4 and 2*t4 + 1
  const int dpad = (D + 15) & ~15;
  const int nsl = (dpad + DS - 1) / DS;              // slices of q and k
  const int c0 = blockIdx.z * CW;                    // this block's output columns
  const int ncol = min(CW, dpad - c0);
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const int q0 = blockIdx.x * 16 * groups;
  const int ntiles = (Tn + BK - 1) / BK;
  const int per = nsl + CW / DC;                   // items per tile: the slices, then V's parts
  const int items = (ntiles - split + splits - 1) / splits * per;
  const int stage_elems = fwd_stage(groups);
  bf16* stages = ring + split * nstages * stage_elems;    // this split's ring
  const bool vec_ok = vec != 0;
  const auto split_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(split + 1), "r"(gthreads) : "memory");
  };
  const auto load_item = [&](bf16* stage, int n) {
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
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g + 8 (log2 domain)
  float l0 = 0.f, l1 = 0.f;               // this lane's part of the running sums
  float s[ST][4];
  uint32_t pf[BK / 16][4];

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
    const bf16* st = stages + n % nstages * stage_elems;
    const int r = n % per;
    if (r < nsl) {
      // S += Q_slice K_slice^T for this warp's 16 rows and the tile's keys
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < ST; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      }
      slice_product<BK>(s, st + group * 16 * LDS, st + 16 * groups * LDS,
                        min(DS, dpad - r * DS) / 16, lane);
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
        const float a0 = exp2f(m0 - mn0);   // 0 on the split's first tile
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
        // P = exp2(S - m), rounded to bf16 as the A fragments of P V: key
        // chunk c takes the C fragments of S tiles 2c (a0, a1) and 2c + 1 (a2, a3)
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) {
          const float p0 = exp2f(s[nt][0] - mn0);
          const float p1 = exp2f(s[nt][1] - mn0);
          const float p2 = exp2f(s[nt][2] - mn1);
          const float p3 = exp2f(s[nt][3] - mn1);
          l0 += p0 + p1;
          l1 += p2 + p3;
          pf[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
          pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
      }
    } else {
      chunk_product<BK, CW>(o, pf, st, ncol, lane, r - nsl);    // O += P V_chunk, a part
    }
    split_sync();                         // the stage may be refilled
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
    float* part = reinterpret_cast<float*>(ring);
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
  if (lse != nullptr && blockIdx.z == 0 && t4 == 0) {   // lse2 of the whole row, for the backward
    const long long lbase = static_cast<long long>(blockIdx.y) * Tn;
    if (row0 < Tn) lse[lbase + row0] = mr0 + log2f(l0);
    if (row0 + 8 < Tn) lse[lbase + row0 + 8] = mr1 + log2f(l1);
  }
  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    const int col = c0 + ot * 8 + 2 * t4;
    if (col >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= Tn) continue;
      const float inv = h ? inv1 : inv0;
      bf16* p = out + base + static_cast<long long>(row) * D + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(o[ot][2 * h] * inv, o[ot][2 * h + 1] * inv);
      } else {
        p[0] = __float2bfloat16(o[ot][2 * h] * inv);
        if (col + 1 < D) p[1] = __float2bfloat16(o[ot][2 * h + 1] * inv);
      }
    }
  }
}

// ---- backward

// bf16 of one stage of a backward warp: the larger of a slice item (the
// block's 16 rows of two operands, then the walked chunk's W rows of two,
// DS columns each) and a column-chunk item (W rows x DC)
template <int W>
__host__ __device__ constexpr int bwd_stage() { return max_int((2 * ROWS + 2 * W) * LDS, W * LDC); }
// bytes: the block's D (16 floats), then the ring, whose bytes later hold
// the warps' fp32 partial sums of `outputs` chunks
template <int W>
__host__ __device__ constexpr int bwd_smem(int stages, int outputs) {
  return ROWS * 4 + max_int(WARPS * stages * bwd_stage<W>() * 2, outputs * WARPS * ROWS * PS * 4);
}

// a warp's (16, DC) C fragments into its slot of the partial sums
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
// the warps' partial sums, added in warp order, rounded to bf16; by the
// whole block
__device__ __forceinline__ void combine_store(bf16* out, const float* parts, int r0, int Tn, int D,
                                              int c0, int width, float mul) {
  for (int e = threadIdx.x; e < ROWS * width; e += 32 * WARPS) {
    const int r = e / width;
    const int c = e - r * width;
    if (r0 + r >= Tn) break;
    const float* p = parts + r * PS + c;
    float sum = p[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += p[w * ROWS * PS];
    out[static_cast<long long>(r0 + r) * D + c0 + c] = __float2bfloat16(sum * mul);
  }
}

// Query pass: block (x, y, z) takes query rows 16x .. 16x + 15 of head y and
// output columns 128 z ..  It computes D of its rows over the full d (chunk
// 0 writes it to `delta` for the key pass) and dq_chunk = scale * sum over
// keys of dS k_chunk.  Warp w walks key chunks w, w + 4, ... of W keys; per
// chunk its items are the slices (q, dout, k, v), then k's column chunk.
template <int W>
__global__ void __launch_bounds__(32 * WARPS)
attention_bwd_mma_wide_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                                 const bf16* __restrict__ dout, const float* __restrict__ lse2,
                                 bf16* __restrict__ dq, float* __restrict__ delta, int Tn, int D,
                                 float scale_log2, float scale, int nstages, int vec) {
  constexpr int NT = W / 8;         // 8-key column tiles of S per chunk
  constexpr int STAGE = bwd_stage<W>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ds = reinterpret_cast<float*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ROWS * 4);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int dpad = (D + 15) & ~15;
  const int nsl = (dpad + DS - 1) / DS;
  const int c0 = blockIdx.z * DC;
  const int ncol = min(DC, dpad - c0);
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * Tn;
  const int q0 = blockIdx.x * ROWS;
  const int nchunks = (Tn + W - 1) / W;
  const int per = nsl + 1;
  const int items = (nchunks - warp + WARPS - 1) / WARPS * per;   // 0 for a warp without a chunk
  bf16* stages = ring + warp * nstages * STAGE;      // this warp's ring
  const bool vec_ok = vec != 0;
  const auto load_item = [&](bf16* stage, int n) {
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
      const bf16* gr = dout + base + static_cast<long long>(q0 + r) * D;
      const bf16* orow = o + base + static_cast<long long>(q0 + r) * D;
      if (vec_ok) {                         // 16-byte loads, 8 columns each
#pragma unroll 8
        for (int c = part * 8; c < D; c += 64) {
          const uint4 a = *reinterpret_cast<const uint4*>(gr + c);
          const uint4 b = *reinterpret_cast<const uint4*>(orow + c);
          const bf16* ap = reinterpret_cast<const bf16*>(&a);
          const bf16* bp = reinterpret_cast<const bf16*>(&b);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc = fmaf(__bfloat162float(ap[e]), __bfloat162float(bp[e]), acc);
        }
      } else {
#pragma unroll 4
        for (int c = part; c < D; c += 8) {
          acc = fmaf(__bfloat162float(gr[c]), __bfloat162float(orow[c]), acc);
        }
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
  uint32_t af[W / 16][4];

  for (int n = 0; n < items; ++n) {
    const int ahead = n + nstages - 1;      // into the stage that item n - 1 left
    if (ahead < items) load_item(stages + ahead % nstages * STAGE, ahead);
    cp_async_commit();
    if (nstages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();                           // item n has landed for the whole warp
    const bf16* st = stages + n % nstages * STAGE;
    const int r = n % per;
    if (r < nsl) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
          dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
        }
      }
      const int nkc = min(DS, dpad - r * DS) / 16;
      slice_product<W>(s, st, st + 2 * ROWS * LDS, nkc, lane);                 // S += Q K^T
      slice_product<W>(dp, st + ROWS * LDS, st + (2 * ROWS + W) * LDS, nkc, lane);   // dP += dO V^T
      if (r == nsl - 1) {
        // P = exp2(S * scale_log2 - lse2) (0 past T), dS = P (dP - D), rounded
        // to bf16 as the A fragments of dS K
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
          af[nt / 2][(nt & 1) * 2] = pack_bf16(p0 * (dp[nt][0] - d_a), p1 * (dp[nt][1] - d_a));
          af[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2 * (dp[nt][2] - d_b), p3 * (dp[nt][3] - d_b));
        }
      }
    } else {
      chunk_product<W>(acc, af, st, ncol, lane);   // dq_chunk += dS K_chunk
    }
    __syncwarp();                           // the stage may be refilled
  }
  __syncthreads();                          // every warp is done with its stages
  float* parts = reinterpret_cast<float*>(ring);
  store_partial(parts + warp * ROWS * PS, acc, lane);
  __syncthreads();
  combine_store(dq + base, parts, q0, Tn, D, c0, min(DC, D - c0), scale);
}

// Key pass: block (x, y, z) takes key rows 16x .. 16x + 15 of head y and
// output columns 128 z ..: dv_chunk = sum over queries of P^T dout_chunk,
// dk_chunk = scale * sum of dS^T q_chunk.  Warp w walks query chunks w, w +
// 4, ... of W queries with their lse2 and D; per chunk its items are the
// slices (k, v, q, dout), then dout's column chunk, then q's.
template <int W>
__global__ void __launch_bounds__(32 * WARPS)
attention_bwd_mma_wide_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse2, const float* __restrict__ delta,
                                   bf16* __restrict__ dk, bf16* __restrict__ dv, int Tn, int D,
                                   float scale_log2, float scale, int nstages, int vec) {
  constexpr int NT = W / 8;         // 8-query column tiles of S^T per chunk
  constexpr int STAGE = bwd_stage<W>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ROWS * 4);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int dpad = (D + 15) & ~15;
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
  bf16* stages = ring + warp * nstages * STAGE;      // this warp's ring
  const bool vec_ok = vec != 0;
  const auto load_item = [&](bf16* stage, int n) {
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
  uint32_t pf[W / 16][4], sf[W / 16][4];

  for (int n = 0; n < items; ++n) {
    const int ahead = n + nstages - 1;      // into the stage that item n - 1 left
    if (ahead < items) load_item(stages + ahead % nstages * STAGE, ahead);
    cp_async_commit();
    if (nstages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();                           // item n has landed for the whole warp
    const bf16* st = stages + n % nstages * STAGE;
    const int r = n % per;
    if (r < nsl) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
          dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
        }
      }
      const int nkc = min(DS, dpad - r * DS) / 16;
      slice_product<W>(s, st, st + 2 * ROWS * LDS, nkc, lane);                 // S^T += K Q^T
      slice_product<W>(dp, st + ROWS * LDS, st + (2 * ROWS + W) * LDS, nkc, lane);   // dP^T += V dO^T
      if (r == nsl - 1) {
        // P^T (0 for queries past T) and dS^T = P^T (dP^T - D), each rounded
        // to bf16 as A fragments
        const int i = warp + n / per * WARPS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int qc = i * W + nt * 8 + 2 * t4;   // the chunk's query columns qc, qc + 1
          const bool in0 = qc < Tn;
          const bool in1 = qc + 1 < Tn;
          const float l0 = in0 ? lse2[rbase + qc] : 0.f;
          const float l1 = in1 ? lse2[rbase + qc + 1] : 0.f;
          const float e0 = in0 ? delta[rbase + qc] : 0.f;
          const float e1 = in1 ? delta[rbase + qc + 1] : 0.f;
          const float p0 = in0 ? exp2f(s[nt][0] * scale_log2 - l0) : 0.f;
          const float p1 = in1 ? exp2f(s[nt][1] * scale_log2 - l1) : 0.f;
          const float p2 = in0 ? exp2f(s[nt][2] * scale_log2 - l0) : 0.f;
          const float p3 = in1 ? exp2f(s[nt][3] * scale_log2 - l1) : 0.f;
          pf[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
          pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
          sf[nt / 2][(nt & 1) * 2] = pack_bf16(p0 * (dp[nt][0] - e0), p1 * (dp[nt][1] - e1));
          sf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2 * (dp[nt][2] - e0), p3 * (dp[nt][3] - e1));
        }
      }
    } else if (r == nsl) {
      chunk_product<W>(dva, pf, st, ncol, lane);   // dv_chunk += P^T dO_chunk
      if (MERGED) chunk_product<W>(dka, sf, st + W * LDC, ncol, lane);   // dk_chunk += dS^T Q_chunk
    } else {
      chunk_product<W>(dka, sf, st, ncol, lane);   // dk_chunk += dS^T Q_chunk
    }
    __syncwarp();                           // the stage may be refilled
  }
  __syncthreads();
  float* parts = reinterpret_cast<float*>(ring);
  constexpr int OUT = WARPS * ROWS * PS;    // floats of one output's partials
  store_partial(parts + warp * ROWS * PS, dka, lane);
  store_partial(parts + OUT + warp * ROWS * PS, dva, lane);
  __syncthreads();
  const int width = min(DC, D - c0);
  combine_store(dk + base, parts, k0, Tn, D, c0, width, scale);
  combine_store(dv + base, parts + OUT, k0, Tn, D, c0, width, 1.f);
}

// dynamic shared memory above 48 KB, allowed once per device and kernel (not
// again while a CUDA graph captures the launches)
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
cudaError_t launch_backward(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                            const bf16* dout, const float* lse2, bf16* dq, bf16* dk, bf16* dv,
                            float* delta, int BH, int Tn, int D, float scale_log2, float scale,
                            int nstages, int vec, cudaStream_t stream) {
  static std::atomic<unsigned long long> allowed_dq{0}, allowed_kv{0};
  cudaError_t err = allow_smem(allowed_dq, attention_bwd_mma_wide_dq_kernel<W>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  err = allow_smem(allowed_kv, attention_bwd_mma_wide_dkdv_kernel<W>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  const int chunks = (((D + 15) & ~15) + DC - 1) / DC;
  const dim3 grid(static_cast<unsigned>((Tn + ROWS - 1) / ROWS), static_cast<unsigned>(BH),
                  static_cast<unsigned>(chunks));
  attention_bwd_mma_wide_dq_kernel<W><<<grid, 32 * WARPS, bwd_smem<W>(nstages, 1), stream>>>(
      q, k, v, o, dout, lse2, dq, delta, Tn, D, scale_log2, scale, nstages, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_mma_wide_dkdv_kernel<W><<<grid, 32 * WARPS, bwd_smem<W>(nstages, 2), stream>>>(
      q, k, v, dout, lse2, delta, dk, dv, Tn, D, scale_log2, scale, nstages, vec);
  return cudaGetLastError();
}

template <int CW>
cudaError_t launch_forward(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int BH,
                           int Tn, int D, float scale_log2, int splits, int stages, int vec,
                           cudaStream_t stream) {
  const int groups = WARPS / splits;
  if (fwd_smem<CW>(groups, splits, stages) > MAX_SMEM) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> allowed{0};
  const cudaError_t err = allow_smem(allowed, attention_mma_wide_kernel<CW>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  const int rows = 16 * groups;
  const int chunks = (((D + 15) & ~15) + CW - 1) / CW;
  const dim3 grid(static_cast<unsigned>((Tn + rows - 1) / rows), static_cast<unsigned>(BH),
                  static_cast<unsigned>(chunks));
  attention_mma_wide_kernel<CW><<<grid, 32 * WARPS, fwd_smem<CW>(groups, splits, stages), stream>>>(
      q, k, v, out, lse, Tn, D, scale_log2, splits, stages, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (BH, T, D) bf16, contiguous on the device, D > 128; of the 4
// warps of a block, `splits` (1, 2 or 4, at most the number of 64-key
// tiles) split the keys of one row group, each through `stages` (1 or 2)
// ring stages; each block computes `chunk` (128 or 256) output columns
// (ops/attention.py::plan); `scale_log2` = D^-1/2 * log2(e).  `lse`, when
// not null, receives BH * T floats, each row's lse2 = m + log2(l) in the
// kernel's log2 domain, for the backward; `out` is the same with and
// without it.  Grid: (row blocks, BH, ceil(D_pad / chunk)).  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int attention_mma_wide_forward(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int BH, int Tn, int D, float scale_log2,
                                          int splits, int stages, int chunk, void* stream) {
  const int ntiles = (Tn + BK - 1) / BK;
  const bool ok = D > 128 && Tn >= 1 && BH >= 1 && BH <= 65535 &&
                  (splits == 1 || splits == 2 || splits == 4) && splits <= ntiles &&
                  stages >= 1 && stages <= MAX_STAGES;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int vec = (D % 8 == 0 && aligned) ? 1 : 0;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  float* lp = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (chunk == 128) {
    err = launch_forward<128>(qp, kp, vp, op, lp, BH, Tn, D, scale_log2, splits, stages, vec, s);
  } else if (chunk == 256) {
    err = launch_forward<256>(qp, kp, vp, op, lp, BH, Tn, D, scale_log2, splits, stages, vec, s);
  }
  return static_cast<int>(err);
}

// q, k, v, o (the forward's output), dout and dq, dk, dv: (BH, T, D) bf16,
// contiguous on the device, D > 128; `lse2` the forward's BH * T row
// statistics (attention_mma_wide_forward); `delta` a workspace of BH * T
// floats (it receives D = rowsum(dout * o)).  `tile` is W, the rows of a
// warp's chunk of the walked dimension: 16 or 32; `stages` (1 or 2) a warp's
// ring stages (ops/attention.py::backward_plan).  `scale_log2` = D^-1/2 *
// log2(e), `scale` = D^-1/2.  Launches two kernels on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int attention_mma_wide_backward(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse2,
                                           void* dq, void* dk, void* dv, void* delta, int BH,
                                           int Tn, int D, float scale_log2, float scale, int tile,
                                           int stages, void* stream) {
  if (D <= 128 || Tn < 1 || BH < 1 || BH > 65535 || stages < 1 || stages > MAX_STAGES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  const int vec = (D % 8 == 0 && aligned) ? 1 : 0;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(o);
  const bf16* gp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse2);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
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
