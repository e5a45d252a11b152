// Flash self-attention on Hopper's tensor cores, bf16 in and out, with the
// ADM legacy scaling: out = softmax((q * d^-1/4) (k * d^-1/4)^T) v, the
// softmax in fp32, for head widths d <= 128.
//
// Replaces, for bf16, the Pallas TPU kernel `_flash_kernel` /
// `flash_attention` of diffusion_models_dev_project_tpu/ops/attention.py
// (online softmax over key blocks, padded keys masked to -1e30, any T, d
// zero-padded).  The `attention` wrapper in ops/attention.py picks this
// kernel and its key splits (`plan`); fp32 and d > 128 go to the CUDA-core
// kernel of csrc/attention.cu.
//
// What bounds it on the H100: on the UNet's path q, k, v are (8, 256, 64)
// and (8, 64, 64) per image, about 0.07 GFLOP over 1 MB per call: a
// microsecond at either peak.  The kernel is bound by latency: the launch,
// the chain of key tiles each warp walks, and how many SMs the grid reaches.
// What the design does about it:
//
// - Both products on the tensor cores, `mma.sync.m16n8k16` bf16 x bf16 ->
//   fp32.  One warp owns 16 query rows and keeps their Q fragments in
//   registers for its whole key loop.  `mma.sync` and not `wgmma`: a
//   `wgmma` tile is 64 rows per warpgroup, which gives 32 blocks at T = 256
//   and leaves 100 SMs idle.
// - A block of 4 warps is `groups` row groups of 16 rows times
//   `splits` key splits.  At T = 256 (4 key tiles) the 4 warps share 16
//   rows and each takes one key tile, so a warp's chain is one tile, not
//   four, and the grid has 128 blocks; at T = 64 (one tile) they are 4 row
//   groups over 64 rows.  Each split runs its own online softmax; at the
//   end the splits of a row group merge (O, m, l) through shared memory in
//   split order.  The blockings that were timed against this one are in
//   PERF.md, section 6 (Findings).
// - S = Q K^T from the unscaled bf16 q and k, then S * d^-1/2 * log2(e) in
//   fp32 and exp2: the legacy product (q d^-1/4)(k d^-1/4) without rounding
//   q d^-1/4 to bf16.
// - Online softmax per key tile of 64: the running max and sum per row in
//   fp32, the max reduced over the 4 lanes that share a row of the mma C
//   fragment, the sum kept per lane and reduced once at the end, O rescaled
//   once per tile.  Keys past T score -1e30 (no inf - inf).
// - P stays in registers: the C fragment of S maps onto the A fragment of
//   P V, so P is rounded to bf16 in place and fed to the second mma.  That
//   rounding of P (the row sums use the fp32 P) is the one numerical
//   difference from the plain version.
// - Each split streams its K and V tiles through two shared-memory stages
//   of its own by `cp.async` 16-byte copies (scalar loads when d is not a
//   multiple of 8), and syncs on its own named barrier: the next tile lands
//   while this one is computed, and Q K^T with the softmax runs while V
//   lands.  Rows are padded by 16 bytes so that `ldmatrix` (and
//   `ldmatrix.trans` for V) meets no bank conflict.  d is zero-padded to a
//   multiple of 16 in shared memory, which is exact.
// - No atomics, no split across blocks and a fixed merge order: two
//   launches give the same bits.  The kernel runs on the caller's stream
//   and allocates nothing, so a CUDA graph can capture it.
// - Given an `lse` buffer, split 0 of each row group also writes the row's
//   lse2 = m + log2(l) after the merge (fp32, the log2 domain of S above),
//   so that the backward (attention_bwd_mma.cu) need not recompute it.
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"

namespace {

constexpr int BK = 64;          // keys per shared-memory tile
constexpr int WARPS = 4;        // warps per block: row groups x key splits

// shared memory of a block: Q (16 rows per row group), then `stages` K and V
// tiles; after the key loop the same bytes hold the partial results of the
// warps of key splits 1.. for the combine
template <int DP>
constexpr int q_bytes(int groups) { return 16 * groups * (DP + PAD) * 2; }
template <int DP>
constexpr int ring_bytes(int stages) { return stages * 2 * BK * (DP + PAD) * 2; }
template <int DP>   // floats of one warp's partial result: O, then m and l of two rows, per lane
__host__ __device__ constexpr int partial_floats() { return (DP / 8) * 4 * 32 + 4 * 32; }
template <int DP>
constexpr int smem_bytes(int groups, int splits, int stages) {
  return q_bytes<DP>(groups) +
         (ring_bytes<DP>(stages) > groups * (splits - 1) * partial_floats<DP>() * 4
              ? ring_bytes<DP>(stages)
              : groups * (splits - 1) * partial_floats<DP>() * 4);
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

// DP: the widest head this instantiation takes (64 or 128).  The block's
// warps are `splits` key splits times `groups` row groups of 16 query rows.
// The warps of split s (warps s*groups ..) take key tiles s, s + splits, ...
// with their own online softmax; they load those tiles themselves, through
// two stages of their own, and sync on their own named barrier, so a split
// never waits for another's copies.  K and V of a tile are separate copy
// groups: Q K^T and the softmax run while V lands.  At the end the splits of
// a row group are merged in split order.
template <int DP>
__global__ void __launch_bounds__(32 * WARPS)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int Tn, int D, float scale_log2, int splits,
                     int vec) {
  constexpr int LD = DP + PAD;
  constexpr int TILE = BK * LD;
  constexpr int KC = DP / 16;       // 16-wide chunks of d
  constexpr int OT = DP / 8;        // 8-wide column tiles of O
  constexpr int ST = BK / 8;        // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = WARPS / splits;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + 16 * groups * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = warp / groups;
  const int group = warp - split * groups;
  const int gthreads = 32 * groups;                  // threads of this split
  const int gtid = threadIdx.x - split * gthreads;
  const int g = lane >> 2;          // C-fragment rows g and g + 8
  const int t4 = lane & 3;          // C-fragment columns 2*t4 and 2*t4 + 1
  const int dpad = (D + 15) & ~15;
  const int nkc = dpad / 16;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const int q0 = blockIdx.x * 16 * groups;
  const int ntiles = (Tn + BK - 1) / BK;
  const bool vec_ok = vec != 0;
  // this split's stages: two when some split has a second tile, else one
  const bool two = ntiles > splits;
  bf16* stages = ring + split * (two ? 2 : 1) * 2 * TILE;
  const auto split_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(split + 1), "r"(gthreads) : "memory");
  };
  const auto load_tile = [&](bf16* stage, int j) {    // K then V: two copy groups
    load_cols<DP, DP + PAD>(stage, k + base, j * BK, BK, 0, Tn, D, vec_ok, gtid, gthreads);
    cp_async_commit();
    load_cols<DP, DP + PAD>(stage + TILE, v + base, j * BK, BK, 0, Tn, D, vec_ok, gtid, gthreads);
    cp_async_commit();
  };

  // Q of all row groups, by the whole block; then this split's first tile
  load_cols<DP, DP + PAD>(Qs, q + base, q0, 16 * groups, 0, Tn, D, vec_ok, threadIdx.x, 32 * WARPS);
  cp_async_commit();
  load_tile(stages, split);
  cp_async_wait<2>();
  __syncthreads();

  uint32_t qf[KC][4];
  float o[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g + 8 (log2 domain)
  float l0 = 0.f, l1 = 0.f;               // this lane's part of the running sums

#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    if (kc < nkc) {
      const int row = group * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = kc * 16 + (lane >> 4) * 8;
      ldmatrix_x4(qf[kc], smem_u32(Qs + row * LD + col));
    }
  }

  for (int j = split, buf = 0; j < ntiles; j += splits, buf ^= 1) {
    const bf16* Kb = stages + buf * 2 * TILE;
    const bf16* Vb = Kb + TILE;
    const bool next = j + splits < ntiles;
    if (next) {                           // the next tile streams in during this one
      load_tile(stages + (buf ^ 1) * 2 * TILE, j + splits);
      cp_async_wait<3>();
    } else {
      cp_async_wait<1>();
    }
    split_sync();                         // K of tile j has landed
    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[ST][4];
#pragma unroll
    for (int i = 0; i < ST; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
#pragma unroll
        for (int nt = 0; nt < ST; nt += 2) {
          uint32_t b[4];
          const int key = nt * 8 + (lane & 7) + (lane >> 4) * 8;
          const int col = kc * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(b, smem_u32(Kb + key * LD + col));
          mma_bf16(s[nt], qf[kc], b[0], b[1]);
          mma_bf16(s[nt + 1], qf[kc], b[2], b[3]);
        }
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
    for (int i = 0; i < OT; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }
    // P = exp2(S - m), rounded to bf16 as the A fragments of P V: key
    // chunk c takes the C fragments of S tiles 2c (a0, a1) and 2c + 1 (a2, a3)
    uint32_t pf[BK / 16][4];
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

    if (next) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    split_sync();                         // V of tile j has landed
    // O += P V; V read transposed by ldmatrix
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
#pragma unroll
      for (int ot = 0; ot < OT; ot += 2) {
        if (ot * 8 < dpad) {
          uint32_t b[4];
          const int key = c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = ot * 8 + (lane >> 4) * 8;
          ldmatrix_x4_trans(b, smem_u32(Vb + key * LD + col));
          mma_bf16(o[ot], pf[c], b[0], b[1]);
          mma_bf16(o[ot + 1], pf[c], b[2], b[3]);
        }
      }
    }
    split_sync();                         // stage buf is refilled with tile j + 2 * splits
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
    constexpr int PF = partial_floats<DP>();
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
    const float c0 = exp2f(m0 - mm0);
    const float c1 = exp2f(m1 - mm1);
    mr0 = mm0;
    mr1 = mm1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
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
  if (lse != nullptr && t4 == 0) {        // lse2 = m + log2(l) of the whole row, for the backward
    const long long lbase = static_cast<long long>(blockIdx.y) * Tn;
    if (row0 < Tn) lse[lbase + row0] = mr0 + log2f(l0);
    if (row0 + 8 < Tn) lse[lbase + row0 + 8] = mr1 + log2f(l1);
  }
  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    const int col = ot * 8 + 2 * t4;
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

template <int DP>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                       int BH, int Tn, int D, float scale_log2, int splits, int vec,
                       cudaStream_t stream) {
  // dynamic shared memory above 48 KB, allowed once per device (not again
  // while a CUDA graph captures the launches)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((allowed.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(attention_mma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed.fetch_or(1ULL << dev);
  }
  const int groups = WARPS / splits;
  const int ntiles = (Tn + BK - 1) / BK;
  const int stages = splits * (ntiles > splits ? 2 : 1);
  const int rows = 16 * groups;
  const dim3 grid(static_cast<unsigned>((Tn + rows - 1) / rows), static_cast<unsigned>(BH));
  attention_mma_kernel<DP><<<grid, 32 * WARPS, smem_bytes<DP>(groups, splits, stages), stream>>>(
      q, k, v, out, lse, Tn, D, scale_log2, splits, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (BH, T, D) bf16, contiguous on the device; D <= 128; of the
// 4 warps of a block, `splits` (1, 2 or 4, at most 2 for D > 64, at most the
// number of 64-key tiles) split the keys of one row group
// (ops/attention.py::plan); `scale_log2` = D^-1/2 * log2(e).  `lse`, when
// not null, receives BH * T floats: each row's log-sum-exp of its scaled
// logits in the kernel's log2 domain, lse2 = m + log2(l), for the backward
// (csrc/attention_bwd_mma.cu); `out` is the same with and without it.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int attention_mma_forward(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int BH, int Tn, int D, float scale_log2,
                                     int splits, void* stream) {
  const int ntiles = (Tn + BK - 1) / BK;
  const bool ok = D >= 1 && D <= 128 && Tn >= 1 && BH >= 1 && BH <= 65535 &&
                  (splits == 1 || splits == 2 || splits == 4) && splits <= ntiles && (D <= 64 || splits <= 2);
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
  const cudaError_t err =
      D <= 64 ? launch_mma<64>(qp, kp, vp, op, lp, BH, Tn, D, scale_log2, splits, vec, s)
              : launch_mma<128>(qp, kp, vp, op, lp, BH, Tn, D, scale_log2, splits, vec, s);
  return static_cast<int>(err);
}
