// Backward of the bf16 flash attention of attention_mma.cu on Hopper's
// tensor cores: dq, dk and dv of out = softmax(S) v, S = (q * s)(k * s)^T,
// s = d^-1/4, from q, k, v, the forward's output o, dout and the forward's
// saved row statistics lse2 = m + log2(l) (attention_mma_forward's `lse`).
// bf16 in and out, head widths d <= 128, the softmax and every accumulation
// in fp32.
//
// With P = softmax(S), dP = dout v^T, D = rowsum(dout * o) and
// dS = P * (dP - D):  dq = s^2 dS k,  dk = s^2 dS^T q,  dv = P^T dout.
// The JAX package differentiates its einsum attention with XLA; its Pallas
// kernel `_flash_kernel` / `flash_attention`
// (diffusion_models_dev_project_tpu/ops/attention.py) has no backward.  This
// is the `mma` variant of ops/attention.py::attention_backward (picked by
// `backward_plan` for bf16 with d <= 128); the fp32 CUDA-core kernels of
// attention_bwd.cu stay as `simt`, for fp32 and for d > 128.
//
// What bounds it on the H100: at the UNet's shapes, (8, 256, 64) and
// (8, 64, 64) per image, about 0.35 GFLOP over about 2 MB per call, a
// microsecond at either peak.  It is bound by latency: two launches, the
// chain of tiles each warp walks, and how many SMs the grid reaches.  What
// the design does about it:
//
// - The forward saves lse2, so P = exp2(S * d^-1/2 * log2(e) - lse2) comes
//   from one product: no pass recomputes the rows' max and sum.
// - All five products per tile on the tensor cores, `mma.sync.m16n8k16`
//   bf16 x bf16 -> fp32: S = Q K^T and dP = dO V^T (recomputed), then
//   dq += dS K in the query pass, and dv += P^T dO, dk += dS^T Q in the key
//   pass.  `mma.sync` and not `wgmma`, for the forward's reason: a 64-row
//   warpgroup tile leaves most of the 132 SMs idle at B*heads = 8, T = 256.
//   B operands come from shared memory by `ldmatrix` (`.trans` where the
//   tile's rows are the product's depth), rows padded by 16 bytes against
//   bank conflicts.
// - P and dS stay in registers: the C fragment of a product maps onto the A
//   fragment of the next, so each is rounded to bf16 in place where it feeds
//   a product (dS for dq and dk, P for dv).  These roundings are the only
//   numerical difference from the plain version
//   (ops/attention.py::attention_backward_reference); the row sums D and
//   the factors P * (dP - D) use fp32.
// - No atomics, and the same bits on every launch: two kernels.  The query
//   pass (one block per 16 query rows) computes D for its rows, writes it to
//   a workspace, and accumulates dq; the key pass (one block per 16 key
//   rows) walks the queries with their lse2 and D and accumulates dk and dv.
//   In each pass the block's 4 warps share the 16 rows and split the walked
//   dimension in chunks of W (16, 32 or 64; warp w takes chunks w, w + 4,
//   ...): a warp's chain of chunks, not the card's rate, sets the time.  The
//   warps' fp32 partial sums are then added through shared memory in warp
//   order.  Each warp streams its own chunks through shared memory by
//   `cp.async` (16-byte copies, scalar loads when d % 8 != 0 or a pointer
//   is not 16-byte aligned), in two stages when it has more than one chunk,
//   and syncs with `__syncwarp` alone.
// - Both passes recompute S and dP: 14 T^2 d operations per head where a
//   backward with atomics on dq needs 10.  That is the price of
//   determinism; the bound in chip_smoke.py keeps the function's 10.
// - Keys and queries past T get P = 0 (never inf - inf); d is zero-padded to
//   a multiple of 16 in shared memory, which is exact.
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"

namespace {

constexpr int WARPS = 4;        // warps per block; they split the walked dimension
constexpr int ROWS = 16;        // query (key) rows per block: one m16n8k16 row block

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
__host__ __device__ constexpr int dq_head_bytes() { return 3 * ROWS * (DP + PAD) * 2 + ROWS * 4; }
template <int DP, int W>
__host__ __device__ constexpr int dq_stage_bytes() { return 2 * W * (DP + PAD) * 2; }
// key pass: K and V rows of the block, then per warp and stage a chunk of Q
// and dO with the chunk's lse2 and D
template <int DP>
__host__ __device__ constexpr int kv_head_bytes() { return 2 * ROWS * (DP + PAD) * 2; }
template <int DP, int W>
__host__ __device__ constexpr int kv_stage_bytes() { return 2 * W * (DP + PAD) * 2 + 2 * W * 4; }

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

// A fragment (16 rows x 16 columns kc*16 ..) of a shared (16, DP) tile
template <int DP>
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], const bf16* tile, int kc, int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = kc * 16 + (lane >> 4) * 8;
  ldmatrix_x4(r, smem_u32(tile + row * (DP + PAD) + col));
}

// c[nt] += a (16 x 16, columns kc*16 ..) * rows^T for the W rows of a shared
// chunk: S = Q K^T when `rows` is a chunk of K, and the like
template <int DP, int W>
__device__ __forceinline__ void rows_product(float (&c)[W / 8][4], const uint32_t (&a)[4],
                                             const bf16* rows, int kc, int lane) {
#pragma unroll
  for (int nt = 0; nt < W / 8; nt += 2) {
    uint32_t b[4];
    const int r = nt * 8 + (lane & 7) + (lane >> 4) * 8;
    const int col = kc * 16 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(b, smem_u32(rows + r * (DP + PAD) + col));
    mma_bf16(c[nt], a, b[0], b[1]);
    mma_bf16(c[nt + 1], a, b[2], b[3]);
  }
}

// acc (16 x DP) += a (16 x W, bf16 A fragments) * rows, the W rows of a
// shared chunk read transposed: dq += dS K, dv += P^T dO, dk += dS^T Q
template <int DP, int W>
__device__ __forceinline__ void chunk_product(float (&acc)[DP / 8][4],
                                              const uint32_t (&a)[W / 16][4], const bf16* rows,
                                              int dpad, int lane) {
#pragma unroll
  for (int c = 0; c < W / 16; ++c) {
#pragma unroll
    for (int ot = 0; ot < DP / 8; ot += 2) {
      if (ot * 8 < dpad) {
        uint32_t b[4];
        const int r = c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = ot * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, smem_u32(rows + r * (DP + PAD) + col));
        mma_bf16(acc[ot], a[c], b[0], b[1]);
        mma_bf16(acc[ot + 1], a[c], b[2], b[3]);
      }
    }
  }
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
// in warp order, rounded to bf16; by the whole block, coalesced
template <int DP>
__device__ __forceinline__ void combine_store(bf16* out, const float* parts, int r0, int Tn,
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
    out[static_cast<long long>(r0 + r) * D + c] = __float2bfloat16(sum * mul);
  }
}

// Query pass: block (x, y) takes query rows 16x .. 16x + 15 of head y.  It
// writes D of those rows to `delta` and dq = scale * sum over keys of dS k.
// Warp w walks key chunks w, w + 4, ... of W keys.
template <int DP, int W>
__global__ void __launch_bounds__(32 * WARPS)
attention_bwd_mma_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ o,
                            const bf16* __restrict__ dout, const float* __restrict__ lse2,
                            bf16* __restrict__ dq, float* __restrict__ delta, int Tn, int D,
                            float scale_log2, float scale, int vec) {
  constexpr int LD = DP + PAD;
  constexpr int KC = DP / 16;
  constexpr int NT = W / 8;         // 8-key column tiles of S per chunk
  constexpr int STAGE = 2 * W * LD; // bf16 of a stage: K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + ROWS * LD;
  bf16* Os = Gs + ROWS * LD;
  float* Ds = reinterpret_cast<float*>(Os + ROWS * LD);
  unsigned char* ring = smem_raw + dq_head_bytes<DP>();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;          // C-fragment rows g and g + 8
  const int t4 = lane & 3;          // C-fragment columns 2*t4 and 2*t4 + 1
  const int dpad = (D + 15) & ~15;
  const int nkc = dpad / 16;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * Tn;
  const int q0 = blockIdx.x * ROWS;
  const int nchunks = (Tn + W - 1) / W;
  const bool vec_ok = vec != 0;
  bf16* stages = reinterpret_cast<bf16*>(ring) + warp * (nchunks > WARPS ? 2 : 1) * STAGE;
  const auto load_chunk = [&](bf16* stage, int j) {
    load_cols<DP, DP + PAD>(stage, k + base, j * W, W, 0, Tn, D, vec_ok, lane, 32);
    load_cols<DP, DP + PAD>(stage + W * LD, v + base, j * W, W, 0, Tn, D, vec_ok, lane, 32);
  };

  // the block's rows of q, dout and o; then this warp's first chunk (a
  // warp without one commits an empty group)
  load_cols<DP, DP + PAD>(Qs, q + base, q0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  load_cols<DP, DP + PAD>(Gs, dout + base, q0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  load_cols<DP, DP + PAD>(Os, o + base, q0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
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
      acc = fmaf(__bfloat162float(Gs[r * LD + c]), __bfloat162float(Os[r * LD + c]), acc);
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

  uint32_t qf[KC][4], gf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    if (kc < nkc) {
      a_frag<DP>(qf[kc], Qs, kc, lane);
      a_frag<DP>(gf[kc], Gs, kc, lane);
    }
  }
  const float lse_a = q0 + g < Tn ? lse2[rbase + q0 + g] : 0.f;
  const float lse_b = q0 + g + 8 < Tn ? lse2[rbase + q0 + g + 8] : 0.f;
  const float d_a = Ds[g];
  const float d_b = Ds[g + 8];
  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = warp, buf = 0; j < nchunks; j += WARPS, buf ^= 1) {
    const bf16* Kc = stages + buf * STAGE;
    const bf16* Vc = Kc + W * LD;
    if (j + WARPS < nchunks) {              // the next chunk streams in during this one
      load_chunk(stages + (buf ^ 1) * STAGE, j + WARPS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();                           // chunk j has landed for the whole warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
        rows_product<DP, W>(s, qf[kc], Kc, kc, lane);
        rows_product<DP, W>(dp, gf[kc], Vc, kc, lane);
      }
    }
    // P = exp2(S * scale_log2 - lse2) (0 past T), dS = P (dP - D), rounded
    // to bf16 as the A fragments of dS K: key chunk c takes the C fragments
    // of S tiles 2c (a0, a1) and 2c + 1 (a2, a3)
    uint32_t af[W / 16][4];
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
    chunk_product<DP, W>(acc, af, Kc, dpad, lane);
    __syncwarp();                           // the stage may be refilled next round
  }
  __syncthreads();                          // every warp is done with its stages
  float* parts = reinterpret_cast<float*>(ring);
  store_partial<DP>(parts + warp * ROWS * part_stride<DP>(), acc, lane);
  __syncthreads();
  combine_store<DP>(dq + base, parts, q0, Tn, D, scale);
}

// Key pass: block (x, y) takes key rows 16x .. 16x + 15 of head y:
// dv = sum over queries of P^T dout, dk = scale * sum of dS^T q.  Warp w
// walks query chunks w, w + 4, ... of W queries with their lse2 and D.
template <int DP, int W>
__global__ void __launch_bounds__(32 * WARPS)
attention_bwd_mma_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse2, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int Tn, int D,
                              float scale_log2, float scale, int vec) {
  constexpr int LD = DP + PAD;
  constexpr int KC = DP / 16;
  constexpr int NT = W / 8;         // 8-query column tiles of S^T per chunk
  constexpr int STAGE = kv_stage_bytes<DP, W>();
  // d = 128 keeps the K and V fragments in shared memory, not registers:
  // with dk and dv they would not fit
  constexpr bool HOLD = DP <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + ROWS * LD;
  unsigned char* ring = smem_raw + kv_head_bytes<DP>();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int dpad = (D + 15) & ~15;
  const int nkc = dpad / 16;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * Tn;
  const int k0 = blockIdx.x * ROWS;
  const int nchunks = (Tn + W - 1) / W;
  const bool vec_ok = vec != 0;
  unsigned char* stages = ring + warp * (nchunks > WARPS ? 2 : 1) * STAGE;
  // a stage: W rows of q, then of dout, then W floats of lse2 and of D
  const auto load_chunk = [&](unsigned char* stage, int i) {
    bf16* Qc = reinterpret_cast<bf16*>(stage);
    load_cols<DP, DP + PAD>(Qc, q + base, i * W, W, 0, Tn, D, vec_ok, lane, 32);
    load_cols<DP, DP + PAD>(Qc + W * LD, dout + base, i * W, W, 0, Tn, D, vec_ok, lane, 32);
    float* Lc = reinterpret_cast<float*>(Qc + 2 * W * LD);
    for (int e = lane; e < W; e += 32) {
      const int r = i * W + e;
      const bool in = r < Tn;
      cp_async4(smem_u32(Lc + e), lse2 + (in ? rbase + r : 0), in ? 4 : 0);
      cp_async4(smem_u32(Lc + W + e), delta + (in ? rbase + r : 0), in ? 4 : 0);
    }
  };

  load_cols<DP, DP + PAD>(Ks, k + base, k0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  load_cols<DP, DP + PAD>(Vs, v + base, k0, ROWS, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  cp_async_commit();
  if (warp < nchunks) load_chunk(stages, warp);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t kf[HOLD ? KC : 1][4], vf[HOLD ? KC : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
        a_frag<DP>(kf[kc], Ks, kc, lane);
        a_frag<DP>(vf[kc], Vs, kc, lane);
      }
    }
  }
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int i = warp, buf = 0; i < nchunks; i += WARPS, buf ^= 1) {
    const bf16* Qc = reinterpret_cast<const bf16*>(stages + buf * STAGE);
    const bf16* Gc = Qc + W * LD;
    const float* Lc = reinterpret_cast<const float*>(Gc + W * LD);
    const float* Dc = Lc + W;
    if (i + WARPS < nchunks) {
      load_chunk(stages + (buf ^ 1) * STAGE, i + WARPS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and W queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
        if constexpr (HOLD) {
          rows_product<DP, W>(s, kf[kc], Qc, kc, lane);
          rows_product<DP, W>(dp, vf[kc], Gc, kc, lane);
        } else {
          uint32_t a[4];
          a_frag<DP>(a, Ks, kc, lane);
          rows_product<DP, W>(s, a, Qc, kc, lane);
          a_frag<DP>(a, Vs, kc, lane);
          rows_product<DP, W>(dp, a, Gc, kc, lane);
        }
      }
    }
    // P^T (0 for queries past T) and dS^T = P^T (dP^T - D), each rounded to
    // bf16 as A fragments
    uint32_t pf[W / 16][4], sf[W / 16][4];
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
      pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      sf[n / 2][(n & 1) * 2] = pack_bf16(p0 * (dp[n][0] - e0), p1 * (dp[n][1] - e1));
      sf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2 * (dp[n][2] - e0), p3 * (dp[n][3] - e1));
    }
    chunk_product<DP, W>(dva, pf, Gc, dpad, lane);
    chunk_product<DP, W>(dka, sf, Qc, dpad, lane);
    __syncwarp();
  }
  __syncthreads();
  float* parts = reinterpret_cast<float*>(ring);
  constexpr int OUT = WARPS * ROWS * part_stride<DP>();    // floats of one output's partials
  store_partial<DP>(parts + warp * ROWS * part_stride<DP>(), dka, lane);
  store_partial<DP>(parts + OUT + warp * ROWS * part_stride<DP>(), dva, lane);
  __syncthreads();
  combine_store<DP>(dk + base, parts, k0, Tn, D, scale);
  combine_store<DP>(dv + base, parts + OUT, k0, Tn, D, 1.f);
}

template <int DP, int W>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                   const float* lse2, bf16* dq, bf16* dk, bf16* dv, float* delta, int BH,
                   int Tn, int D, float scale_log2, float scale, int vec, cudaStream_t stream) {
  // dynamic shared memory above 48 KB, allowed once per device (not again
  // while a CUDA graph captures the launches)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((allowed.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(attention_bwd_mma_dq_kernel<DP, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem_bytes<DP, W>(2));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_mma_dkdv_kernel<DP, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_smem_bytes<DP, W>(2));
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed.fetch_or(1ULL << dev);
  }
  const int stages = (Tn + W - 1) / W > WARPS ? 2 : 1;
  const dim3 grid(static_cast<unsigned>((Tn + ROWS - 1) / ROWS), static_cast<unsigned>(BH));
  attention_bwd_mma_dq_kernel<DP, W><<<grid, 32 * WARPS, dq_smem_bytes<DP, W>(stages), stream>>>(
      q, k, v, o, dout, lse2, dq, delta, Tn, D, scale_log2, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_mma_dkdv_kernel<DP, W>
      <<<grid, 32 * WARPS, kv_smem_bytes<DP, W>(stages), stream>>>(
          q, k, v, dout, lse2, delta, dk, dv, Tn, D, scale_log2, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o (the forward's output), dout and dq, dk, dv: (BH, T, D) bf16,
// contiguous on the device, D <= 128; `lse2` the forward's BH * T row
// statistics (attention_mma_forward); `delta` a workspace of BH * T floats
// (it receives D = rowsum(dout * o)).  `tile` is W, the rows of a warp's
// chunk of the walked dimension: 16, 32 or 64 for D <= 64, 16 or 32 above
// (ops/attention.py::backward_plan).  `scale_log2` = D^-1/2 * log2(e),
// `scale` = D^-1/2.  Launches two kernels on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int attention_mma_backward(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse2, void* dq, void* dk,
                                      void* dv, void* delta, int BH, int Tn, int D,
                                      float scale_log2, float scale, int tile, void* stream) {
  if (D < 1 || D > 128 || Tn < 1 || BH < 1 || BH > 65535) {
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
#define ATTN_BWD_LAUNCH(DP, W)                                                                 \
  err = launch<DP, W>(qp, kp, vp, op, gp, lp, dqp, dkp, dvp, ws, BH, Tn, D, scale_log2, scale, \
                      vec, s)
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
