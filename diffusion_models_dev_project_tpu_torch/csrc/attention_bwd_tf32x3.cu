// Backward of the fp32 flash attention of attention_tf32x3.cu on Hopper's
// tensor cores, each product taken as three TF32 products of split
// operands: dq, dk and dv of out = softmax(S) v, S = (q * s)(k * s)^T,
// s = d^-1/4, from q, k, v, the forward's output o, dout and the forward's
// saved row statistics lse2 = m + log2(l) (attention_tf32x3_forward's
// `lse`).  fp32 in and out, head widths d <= 128.
//
// With P = softmax(S), dP = dout v^T, D = rowsum(dout * o) and
// dS = P * (dP - D):  dq = s^2 dS k,  dk = s^2 dS^T q,  dv = P^T dout.
// The JAX package differentiates its einsum attention with XLA, at
// Precision.HIGHEST in fp32; its Pallas kernel `_flash_kernel` /
// `flash_attention` (diffusion_models_dev_project_tpu/ops/attention.py) has
// no backward.  This is the `tf32x3` variant of
// ops/attention.py::attention_backward (picked by `backward_plan` for fp32
// with d <= 128); the CUDA-core kernels of attention_bwd.cu stay as `simt`
// for d > 128.
//
// What bounds it on the H100: at the UNet's shapes, (8, 256, 64) and
// (8, 64, 64) per image, about 0.35 GFLOP over about 4 MB per call, a few
// microseconds at the TF32 rate for three products.  It is bound by
// latency, as the bf16 `mma` backward (attention_bwd_mma.cu), whose
// skeleton it keeps:
//
// - The forward saves lse2, so P = exp2(S * d^-1/2 * log2(e) - lse2) comes
//   from one product: no pass recomputes the rows' max and sum.
// - All five products per chunk on the tensor cores, `mma.sync.m16n8k8`
//   tf32 -> fp32, each as hi*hi + hi*lo + lo*hi of operands split in
//   registers as they are read from shared memory (mma_common.cuh): S = Q
//   K^T and dP = dO V^T (recomputed), then dq += dS K in the query pass, and
//   dv += P^T dO, dk += dS^T Q in the key pass.  D and the factors
//   P * (dP - D) in fp32; P and dS are split into hi and lo in registers
//   where they feed a product.
// - The C fragment of a product becomes the A fragment of the next as it
//   stands: dS K, P^T dO and dS^T Q take each slice's 8 keys (queries) in
//   the order 0, 2, 4, 6, 1, 3, 5, 7 in both operands, reading the B
//   fragment from rows 2t and 2t + 1 (mma_common.cuh `b_pairs_split`).
// - No atomics, and the same bits on every launch: two kernels.  The query
//   pass (one block per 16 query rows) computes D for its rows, writes it to
//   a workspace, and accumulates dq; the key pass (one block per 16 key
//   rows) walks the queries with their lse2 and D and accumulates dk and dv.
//   In each pass the block's 4 warps share the 16 rows and split the walked
//   dimension in chunks of W (16, 32 or 64; warp w takes chunks w, w + 4,
//   ...); their fp32 partial sums are then added through shared memory in
//   warp order.  Each warp streams its own chunks through shared memory by
//   `cp.async` (16-byte copies, scalar loads when d % 4 != 0 or a pointer
//   is not 16-byte aligned) and syncs with `__syncwarp` alone.  With more
//   than one chunk a warp, the plan picks two stages (the next chunk lands
//   during this one; then W is at most 32 at d <= 64 and 16 above: fp32
//   chunks are twice bf16's bytes) or one, refilled after each chunk, which
//   leaves room for more blocks on an SM when the grid exceeds the card.
//   The block's own 16 rows stay in shared memory and their A fragments are
//   split per chunk: held in registers, hi and lo of two operands would
//   leave no room.
// - Keys and queries past T get P = 0 (never inf - inf); d is zero-padded to
//   a multiple of 8 in the products, which is exact.
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"

namespace {

constexpr int WARPS = 4;        // warps per block; they split the walked dimension
constexpr int ROWS = 16;        // query (key) rows per block: one m16n8k8 row block

// the widest chunk a warp takes: 64 rows at DP = 64, 32 at DP = 128, and
// then in one stage only; narrower chunks take two
template <int DP>
__host__ __device__ constexpr int widest() { return DP <= 64 ? 64 : 32; }
template <int DP, int W>
__host__ __device__ constexpr int max_stages() { return W == widest<DP>() ? 1 : 2; }

// floats per row of a warp's partial sum
template <int DP>
__host__ __device__ constexpr int part_stride() { return DP + 8; }
// fp32 partial sums of `outputs` (16, DP) results per warp, for the ordered combine
template <int DP>
__host__ __device__ constexpr int part_bytes(int outputs) {
  return outputs * WARPS * ROWS * part_stride<DP>() * 4;
}
// query pass: Q, dO and O rows of the block and their D, then per warp and
// stage a chunk of K and V
template <int DP>
__host__ __device__ constexpr int dq_head_bytes() { return 3 * ROWS * (DP + FPAD) * 4 + ROWS * 4; }
template <int DP, int W>
__host__ __device__ constexpr int dq_stage_bytes() { return 2 * W * (DP + FPAD) * 4; }
// key pass: K and V rows of the block, then per warp and stage a chunk of Q
// and dO with the chunk's lse2 and D
template <int DP>
__host__ __device__ constexpr int kv_head_bytes() { return 2 * ROWS * (DP + FPAD) * 4; }
template <int DP, int W>
__host__ __device__ constexpr int kv_stage_bytes() { return 2 * W * (DP + FPAD) * 4 + 2 * W * 4; }

__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }
template <int DP, int W>
__host__ __device__ constexpr int dq_smem_bytes(int stages) {
  return dq_head_bytes<DP>() +
         max_int(WARPS * stages * dq_stage_bytes<DP, W>(), part_bytes<DP>(1));
}
template <int DP, int W>
__host__ __device__ constexpr int kv_smem_bytes(int stages) {
  return kv_head_bytes<DP>() +
         max_int(WARPS * stages * kv_stage_bytes<DP, W>(), part_bytes<DP>(2));
}

// a warp's (16, DP) C fragments into its slot of the partial sums
template <int DP>
__device__ __forceinline__ void store_partial(float* slot, const float (&acc)[DP / 8][4],
                                              int lane) {
  constexpr int PS = part_stride<DP>();
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int ot = 0; ot < DP / 8; ++ot) {
    const int col = ot * 8 + 2 * t4;
    *reinterpret_cast<float2*>(slot + g * PS + col) = make_float2(acc[ot][0], acc[ot][1]);
    *reinterpret_cast<float2*>(slot + (g + 8) * PS + col) = make_float2(acc[ot][2], acc[ot][3]);
  }
}

// out rows r0 .. r0 + 15 (those < T) = mul * the warps' partial sums, added
// in warp order; by the whole block, coalesced
template <int DP>
__device__ __forceinline__ void combine_store(float* out, const float* parts, int r0, int Tn,
                                              int D, float mul) {
  constexpr int PS = part_stride<DP>();
  constexpr int WS = ROWS * PS;              // floats per warp
  for (int e = threadIdx.x; e < ROWS * D; e += 32 * WARPS) {
    const int r = e / D;
    const int c = e - r * D;
    if (r0 + r >= Tn) break;
    const float* p = parts + r * PS + c;
    float sum = p[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += p[w * WS];
    out[static_cast<long long>(r0 + r) * D + c] = sum * mul;
  }
}

// acc (16 x DP) += a (16 x 8 of the walked rows k0 .., split) * rows k0 ..
// k0 + 7 of a shared chunk, in `b_pairs_split`'s order: per group of 4
// column tiles, hi*hi over the 4, then hi*lo, then lo*hi
template <int DP, int LD>
__device__ __forceinline__ void pairs_product(float (&acc)[DP / 8][4], const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], const float* rows, int k0,
                                              int nks, int lane) {
#pragma unroll
  for (int ot0 = 0; ot0 < DP / 8; ot0 += 4) {
    if (ot0 < nks) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) b_pairs_split<LD>(rows, k0, (ot0 + i) * 8, lane, bh[i], bl[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[ot0 + i], ah, bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[ot0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[ot0 + i], al, bh[i][0], bh[i][1]);
    }
  }
}

// s (16 x W) += A rows (a shared 16-row tile) times the W rows of a shared
// chunk, transposed, and dp the same for a second pair: S = Q K^T with dP =
// dO V^T, or S^T = K Q^T with dP^T = V dO^T.  Per slice of d and 8-row tile,
// the two products' hi*hi, hi*lo, lo*hi alternate
template <int DP, int W, int LD>
__device__ __forceinline__ void rows_products(float (&s)[W / 8][4], float (&dp)[W / 8][4],
                                              const float* a_s, const float* a_dp,
                                              const float* b_s, const float* b_dp, int nks,
                                              int lane) {
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < DP / 8; ++kc) {
    if (kc < nks) {
      uint32_t xh[4], xl[4], yh[4], yl[4];
      a_frag_split<LD>(a_s, kc, lane, xh, xl);
      a_frag_split<LD>(a_dp, kc, lane, yh, yl);
#pragma unroll
      for (int nt = 0; nt < W / 8; ++nt) {
        uint32_t bh[2], bl[2], ch[2], cl[2];
        b_rows_split<LD>(b_s, nt * 8, kc, lane, bh, bl);
        b_rows_split<LD>(b_dp, nt * 8, kc, lane, ch, cl);
        mma_tf32(s[nt], xh, bh[0], bh[1]);
        mma_tf32(dp[nt], yh, ch[0], ch[1]);
        mma_tf32(s[nt], xh, bl[0], bl[1]);
        mma_tf32(dp[nt], yh, cl[0], cl[1]);
        mma_tf32(s[nt], xl, bh[0], bh[1]);
        mma_tf32(dp[nt], yl, ch[0], ch[1]);
      }
    }
  }
}

// Query pass: block (x, y) takes query rows 16x .. 16x + 15 of head y.  It
// writes D of those rows to `delta` and dq = scale * sum over keys of dS k.
// Warp w walks key chunks w, w + 4, ... of W keys.
template <int DP, int W>
__global__ void __launch_bounds__(32 * WARPS)
attention_bwd_tf32x3_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ o,
                               const float* __restrict__ dout, const float* __restrict__ lse2,
                               float* __restrict__ dq, float* __restrict__ delta, int Tn, int D,
                               float scale_log2, float scale, int two_stages, int vec) {
  constexpr int LD = DP + FPAD;
  constexpr int NT = W / 8;         // 8-key column tiles of S per chunk
  constexpr int STAGE = 2 * W * LD; // floats of a stage: K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Qs + ROWS * LD;
  float* Os = Gs + ROWS * LD;
  float* Ds = Os + ROWS * LD;
  float* ring = reinterpret_cast<float*>(smem_raw + dq_head_bytes<DP>());

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;          // C-fragment rows g and g + 8
  const int t4 = lane & 3;          // C-fragment columns 2*t4 and 2*t4 + 1
  const int nks = (D + 7) / 8;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * Tn;
  const int q0 = blockIdx.x * ROWS;
  const int nchunks = (Tn + W - 1) / W;
  const bool vec_ok = vec != 0;
  const bool two = two_stages != 0 && nchunks > WARPS;
  float* stages = ring + warp * (two ? 2 : 1) * STAGE;
  const auto load_chunk = [&](float* stage, int j) {
    load_cols<DP, DP + FPAD>(stage, k + base, j * W, W, 0, Tn, D, vec_ok, lane, 32);
    load_cols<DP, DP + FPAD>(stage + W * LD, v + base, j * W, W, 0, Tn, D, vec_ok, lane, 32);
  };

  // the block's rows of q, dout and o; then this warp's first chunk (a
  // warp without one commits an empty group)
  load_cols<DP, DP + FPAD>(Qs, q + base, q0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  load_cols<DP, DP + FPAD>(Gs, dout + base, q0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  load_cols<DP, DP + FPAD>(Os, o + base, q0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  cp_async_commit();
  if (warp < nchunks) load_chunk(stages, warp);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  {  // D = rowsum(dout * o): 8 threads a row, in a fixed order
    const int r = threadIdx.x >> 3;
    const int part = threadIdx.x & 7;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = part + 8 * i;
      acc = fmaf(Gs[r * LD + c], Os[r * LD + c], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (part == 0) {
      Ds[r] = acc;
      if (q0 + r < Tn) delta[rbase + q0 + r] = acc;
    }
  }
  __syncthreads();

  const float lse_a = q0 + g < Tn ? lse2[rbase + q0 + g] : 0.f;
  const float lse_b = q0 + g + 8 < Tn ? lse2[rbase + q0 + g + 8] : 0.f;
  const float d_a = Ds[g];
  const float d_b = Ds[g + 8];
  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = warp, buf = 0; j < nchunks; j += WARPS, buf ^= two ? 1 : 0) {
    const float* Kc = stages + buf * STAGE;
    const float* Vc = Kc + W * LD;
    if (two && j + WARPS < nchunks) {       // the next chunk streams in during this one
      load_chunk(stages + (buf ^ 1) * STAGE, j + WARPS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();                           // chunk j has landed for the whole warp
    float s[NT][4], dp[NT][4];
    rows_products<DP, W, LD>(s, dp, Qs, Gs, Kc, Vc, nks, lane);
    // P = exp2(S * scale_log2 - lse2) (0 past T), dS = P (dP - D), split as
    // the A fragment of dS K, 8 keys at a time
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = j * W + nt * 8 + 2 * t4;
      const bool in0 = key < Tn;
      const bool in1 = key + 1 < Tn;
      const float p0 = in0 ? exp2f(s[nt][0] * scale_log2 - lse_a) : 0.f;
      const float p1 = in1 ? exp2f(s[nt][1] * scale_log2 - lse_a) : 0.f;
      const float p2 = in0 ? exp2f(s[nt][2] * scale_log2 - lse_b) : 0.f;
      const float p3 = in1 ? exp2f(s[nt][3] * scale_log2 - lse_b) : 0.f;
      uint32_t dh[4], dl[4];
      a_from_c(p0 * (dp[nt][0] - d_a), p1 * (dp[nt][1] - d_a), p2 * (dp[nt][2] - d_b),
               p3 * (dp[nt][3] - d_b), dh, dl);
      pairs_product<DP, LD>(acc, dh, dl, Kc, nt * 8, nks, lane);
    }
    __syncwarp();                           // the stage may be refilled
    if (!two && j + WARPS < nchunks) {
      load_chunk(stages, j + WARPS);
      cp_async_commit();
    }
  }
  __syncthreads();                          // every warp is done with its stages
  float* parts = ring;
  store_partial<DP>(parts + warp * ROWS * part_stride<DP>(), acc, lane);
  __syncthreads();
  combine_store<DP>(dq + base, parts, q0, Tn, D, scale);
}

// Key pass: block (x, y) takes key rows 16x .. 16x + 15 of head y:
// dv = sum over queries of P^T dout, dk = scale * sum of dS^T q.  Warp w
// walks query chunks w, w + 4, ... of W queries with their lse2 and D.
template <int DP, int W>
__global__ void __launch_bounds__(32 * WARPS)
attention_bwd_tf32x3_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ dout,
                                 const float* __restrict__ lse2, const float* __restrict__ delta,
                                 float* __restrict__ dk, float* __restrict__ dv, int Tn, int D,
                                 float scale_log2, float scale, int two_stages, int vec) {
  constexpr int LD = DP + FPAD;
  constexpr int NT = W / 8;         // 8-query column tiles of S^T per chunk
  constexpr int STAGE = kv_stage_bytes<DP, W>() / 4;    // floats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + ROWS * LD;
  float* ring = reinterpret_cast<float*>(smem_raw + kv_head_bytes<DP>());

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int nks = (D + 7) / 8;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * Tn;
  const int k0 = blockIdx.x * ROWS;
  const int nchunks = (Tn + W - 1) / W;
  const bool vec_ok = vec != 0;
  const bool two = two_stages != 0 && nchunks > WARPS;
  float* stages = ring + warp * (two ? 2 : 1) * STAGE;
  // a stage: W rows of q, then of dout, then W floats of lse2 and of D
  const auto load_chunk = [&](float* stage, int i) {
    load_cols<DP, DP + FPAD>(stage, q + base, i * W, W, 0, Tn, D, vec_ok, lane, 32);
    load_cols<DP, DP + FPAD>(stage + W * LD, dout + base, i * W, W, 0, Tn, D, vec_ok, lane, 32);
    float* Lc = stage + 2 * W * LD;
    for (int e = lane; e < W; e += 32) {
      const int r = i * W + e;
      const bool in = r < Tn;
      cp_async4(smem_u32(Lc + e), lse2 + (in ? rbase + r : 0), in ? 4 : 0);
      cp_async4(smem_u32(Lc + W + e), delta + (in ? rbase + r : 0), in ? 4 : 0);
    }
  };

  load_cols<DP, DP + FPAD>(Ks, k + base, k0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  load_cols<DP, DP + FPAD>(Vs, v + base, k0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  cp_async_commit();
  if (warp < nchunks) load_chunk(stages, warp);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int i = warp, buf = 0; i < nchunks; i += WARPS, buf ^= two ? 1 : 0) {
    const float* Qc = stages + buf * STAGE;
    const float* Gc = Qc + W * LD;
    const float* Lc = Gc + W * LD;
    const float* Dc = Lc + W;
    if (two && i + WARPS < nchunks) {
      load_chunk(stages + (buf ^ 1) * STAGE, i + WARPS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    // S^T = K Q^T and dP^T = V dO^T for the block's 16 keys and W queries
    float s[NT][4], dp[NT][4];
    rows_products<DP, W, LD>(s, dp, Ks, Vs, Qc, Gc, nks, lane);
    // P^T (0 for queries past T) and dS^T = P^T (dP^T - D), each split as
    // an A fragment, 8 queries at a time
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t4;         // the chunk's query columns c, c + 1
      const bool in0 = i * W + c < Tn;
      const bool in1 = i * W + c + 1 < Tn;
      const float l0 = Lc[c], l1 = Lc[c + 1];
      const float e0 = Dc[c], e1 = Dc[c + 1];
      const float p0 = in0 ? exp2f(s[n][0] * scale_log2 - l0) : 0.f;
      const float p1 = in1 ? exp2f(s[n][1] * scale_log2 - l1) : 0.f;
      const float p2 = in0 ? exp2f(s[n][2] * scale_log2 - l0) : 0.f;
      const float p3 = in1 ? exp2f(s[n][3] * scale_log2 - l1) : 0.f;
      uint32_t ph[4], pl[4], sh[4], sl[4];
      a_from_c(p0, p1, p2, p3, ph, pl);
      a_from_c(p0 * (dp[n][0] - e0), p1 * (dp[n][1] - e1), p2 * (dp[n][2] - e0),
               p3 * (dp[n][3] - e1), sh, sl);
      pairs_product<DP, LD>(dva, ph, pl, Gc, n * 8, nks, lane);
      pairs_product<DP, LD>(dka, sh, sl, Qc, n * 8, nks, lane);
    }
    __syncwarp();
    if (!two && i + WARPS < nchunks) {
      load_chunk(stages, i + WARPS);
      cp_async_commit();
    }
  }
  __syncthreads();
  float* parts = ring;
  constexpr int OUT = WARPS * ROWS * part_stride<DP>();    // floats of one output's partials
  store_partial<DP>(parts + warp * ROWS * part_stride<DP>(), dka, lane);
  store_partial<DP>(parts + OUT + warp * ROWS * part_stride<DP>(), dva, lane);
  __syncthreads();
  combine_store<DP>(dk + base, parts, k0, Tn, D, scale);
  combine_store<DP>(dv + base, parts + OUT, k0, Tn, D, 1.f);
}

template <int DP, int W>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, const float* lse2, float* dq, float* dk, float* dv,
                   float* delta, int BH, int Tn, int D, float scale_log2, float scale,
                   int two_stages, int vec, cudaStream_t stream) {
  const int stages = two_stages && (Tn + W - 1) / W > WARPS ? 2 : 1;
  if (stages > max_stages<DP, W>()) return cudaErrorInvalidValue;
  // dynamic shared memory above 48 KB, allowed once per device (not again
  // while a CUDA graph captures the launches)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((allowed.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(attention_bwd_tf32x3_dq_kernel<DP, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem_bytes<DP, W>(max_stages<DP, W>()));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_tf32x3_dkdv_kernel<DP, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_smem_bytes<DP, W>(max_stages<DP, W>()));
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed.fetch_or(1ULL << dev);
  }
  const dim3 grid(static_cast<unsigned>((Tn + ROWS - 1) / ROWS), static_cast<unsigned>(BH));
  attention_bwd_tf32x3_dq_kernel<DP, W>
      <<<grid, 32 * WARPS, dq_smem_bytes<DP, W>(stages), stream>>>(
          q, k, v, o, dout, lse2, dq, delta, Tn, D, scale_log2, scale, two_stages, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_tf32x3_dkdv_kernel<DP, W>
      <<<grid, 32 * WARPS, kv_smem_bytes<DP, W>(stages), stream>>>(
          q, k, v, dout, lse2, delta, dk, dv, Tn, D, scale_log2, scale, two_stages, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o (the forward's output), dout and dq, dk, dv: (BH, T, D) fp32,
// contiguous on the device, D <= 128; `lse2` the forward's BH * T row
// statistics (attention_tf32x3_forward); `delta` a workspace of BH * T
// floats (it receives D = rowsum(dout * o)).  `tile` is W, the rows of a
// warp's chunk of the walked dimension: 16, 32 or 64 for D <= 64, 16 or 32
// above; `stages` (1 or 2) the shared-memory stages of a warp that walks
// more than one chunk, 2 only below the widest chunk
// (ops/attention.py::backward_plan).  `scale_log2` = D^-1/2 * log2(e),
// `scale` = D^-1/2.  Launches two kernels on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int attention_tf32x3_backward(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse2,
                                         void* dq, void* dk, void* dv, void* delta, int BH,
                                         int Tn, int D, float scale_log2, float scale, int tile,
                                         int stages, void* stream) {
  if (D < 1 || D > 128 || Tn < 1 || BH < 1 || BH > 65535 || (stages != 1 && stages != 2)) {
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
#define ATTN_BWD_LAUNCH(DP, W)                                                                 \
  err = launch<DP, W>(qp, kp, vp, op, gp, lp, dqp, dkp, dvp, ws, BH, Tn, D, scale_log2, scale, \
                      stages == 2 ? 1 : 0, vec, s)
  if (D <= 64) {
    if (tile == 16) ATTN_BWD_LAUNCH(64, 16);
    else if (tile == 32) ATTN_BWD_LAUNCH(64, 32);
    else if (tile == 64) ATTN_BWD_LAUNCH(64, 64);
  } else {
    if (tile == 16) ATTN_BWD_LAUNCH(128, 16);
    else if (tile == 32) ATTN_BWD_LAUNCH(128, 32);
  }
#undef ATTN_BWD_LAUNCH
  return static_cast<int>(err);
}
