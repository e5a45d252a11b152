// 3x3 stride-1 convolution with zero padding 1 on Hopper's tensor cores:
// bf16 NHWC x HWIO + fp32 bias -> bf16 NHWC, fp32 accumulation, one rounding.
//
// Replaces, for bf16 with Cin and Cout multiples of 64, the Pallas TPU kernel
// `_kernel` / `conv3x3_same` of diffusion_models_dev_project_tpu/ops/conv3x3.py
// (nine shifted matmuls over a haloed row tile).  The `conv3x3` wrapper in
// ops/conv3x3.py picks this kernel, its tiling and its split of K (`plan`).
//
// What bounds it on the H100: the UNet's convs are GEMMs of M = B*H*W
// pixels, N = Cout and K = 9*Cin, far above the ~295 FLOP/byte ridge, so
// the bound is the bf16 tensor-core rate (989 TFLOP/s).  What the design
// does about it:
//
// - Implicit GEMM, walked as K steps of one tap (di, dj) x 64 input channels.
//   The A operand of a step is a TMA box of x, (64 channels, Wt, Ht, 1) over
//   the 4-D tensor (Cin, W, H, B), at (c0, w0 + dj - 1, h0 + di - 1, b): the
//   hardware zero-fills what falls off the image, which is the conv's
//   padding, with no padded copy and no per-element predicate.  The box lands
//   as Ht*Wt rows of 128 bytes with the 128-byte swizzle, which is the
//   K-major layout `wgmma` reads.  (The Pallas kernel instead re-read the
//   neighbour row blocks for its halo, because Mosaic cannot slice unaligned.)
// - B is the HWIO weight read as the row-major [9*Cin][Cout] matrix, in two
//   64 x 64 TMA boxes per step, and fed to `wgmma` MN-major (its transpose-B
//   bit), so the weights keep their public layout.
// - `wgmma.mma_async` m64n128k16, bf16 x bf16 -> fp32, both operands from
//   shared memory, out of a ring of 4 stages.  One producer thread issues the
//   TMA loads; `mbarrier`s carry "stage full" (TMA bytes landed) and "stage
//   empty" (the consumers' wgmma are done with it).  A block owns a 128 x 128
//   output tile with two consumer warpgroups (one block per SM), or a 64 x 128
//   tile with one (two blocks per SM) when 128-pixel tiles are too few.
// - Split-K for small maps: blockIdx.z runs one range of the K steps and
//   writes its fp32 partial tile to a workspace; a second kernel adds the
//   partials in order, adds the bias and rounds, so the result is the same
//   bits run to run (no atomics).  With one split the epilogue adds the bias
//   and rounds in place.
// - A wait on a barrier that does not complete within about two seconds
//   traps, so a pipeline fault ends the launch with an error instead of
//   hanging the card.
//
// Left for later: persistent warp-specialised blocks that overlap one tile's
// epilogue with the next one's loads, a TMA-store epilogue, and a fused
// GroupNorm + SiLU prologue.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tma_wgmma.cuh"

namespace {

constexpr int STAGES = 4;
constexpr int BK = 64;                      // input channels per K step (128 bytes)
constexpr int BN = 128;                     // output channels per tile
constexpr int B_BYTES = BK * BN * 2;        // weight slice of a step, two 64x64 boxes
constexpr int B_HALF = B_BYTES / 2;

template <int CONSUMERS>                    // consumer warpgroups; 64 output pixels each
struct Tile {
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  // the ring, room to align it to 1024 bytes (the 128-byte swizzle's period),
  // and the full and empty barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// A: K-major, rows of 128 bytes, 8-row swizzle atoms 1024 bytes apart (the
// leading offset is unused for a K extent of one atom).  Step k16 of a stage
// starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) { return smem_desc(addr, 16, 1024); }
// B: MN-major; 8 K-rows of 64 channels (128 bytes) form a 1024-byte atom.
// Stride offset: from one 8-row K group to the next (1024 bytes); leading
// offset: from channels 0-63 to channels 64-127 (the second TMA box).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) { return smem_desc(addr, B_HALF, 1024); }

// Grid: (pixel tiles, channel tiles, splits).  A pixel tile is a box of
// box_h x box_w output pixels of one image.  `partial` is null when there is
// one split; otherwise split z writes its fp32 sums to partial[z][pixel][Cout].
template <int CONSUMERS>
__global__ void __launch_bounds__(Tile<CONSUMERS>::THREADS, 3 - CONSUMERS)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int H, int W,
                  int Cin, int Cout, int box_h, int box_w, int steps_per_split, int k_steps,
                  long long M) {
  using T = Tile<CONSUMERS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_w = (W + box_w - 1) / box_w;
  const int tiles_img = ((H + box_h - 1) / box_h) * tiles_w;
  const int b = blockIdx.x / tiles_img;
  const int t = blockIdx.x - b * tiles_img;
  const int h0 = (t / tiles_w) * box_h;
  const int w0 = (t % tiles_w) * box_w;
  const int n0 = blockIdx.y * BN;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(s_begin + steps_per_split, k_steps);
  const int chunks = Cin / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);                    // the producer's expect_tx
      mbar_init(&empty[i], 4 * CONSUMERS);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps up to STAGES steps of TMA in flight
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int s = s_begin; s < s_end; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);    // the first pass finds every stage free
        mbar_expect_tx(&full[stage], T::STAGE_BYTES);
        const int tap = s / chunks;
        const int c0 = (s - tap * chunks) * BK;
        const int di = tap / 3, dj = tap - 3 * (tap / 3);
        const uint32_t a = smem_u32(smem + stage * T::STAGE_BYTES);
        const int krow = tap * Cin + c0;
        tma_load_4d(a, &x_map, &full[stage], c0, w0 + dj - 1, h0 + di - 1, b);
        tma_load_2d(a + T::A_BYTES, &w_map, &full[stage], n0, krow);
        tma_load_2d(a + T::A_BYTES + B_HALF, &w_map, &full[stage], n0 + 64, krow);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g owns output rows 64g .. 64g+63 of the tile
  const int g = wg - 1;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_operands(d);

  int stage = 0, phase = 0, prev = -1;
  for (int s = s_begin; s < s_end; ++s) {
    mbar_wait(&full[stage], phase);
    const uint32_t a = smem_u32(smem + stage * T::STAGE_BYTES) + g * 64 * BK * 2;
    const uint32_t bw = smem_u32(smem + stage * T::STAGE_BYTES + T::A_BYTES);
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16<0>(d, desc_a(a + 32 * kk), desc_b(bw + 16 * 128 * kk));
    wgmma_commit();
    // the previous step's wgmma are done: hand its stage back to the producer
    wgmma_wait<1>();
    fence_operands(d);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_operands(d);

  // ---- epilogue.  Accumulator layout of m64nNk16: register 4j + 2i + e
  // holds row 16*warp + lane/4 + 8i, column 8j + 2*(lane%4) + e.
  const int col = n0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * g + 16 * warp + lane / 4 + 8 * i;
    const int hh = h0 + r / box_w;
    const int ww = w0 + r % box_w;
    if (hh >= H || ww >= W) continue;
    const long long m = (static_cast<long long>(b) * H + hh) * W + ww;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = col + 8 * j;
      if (n >= Cout) continue;
      const float v0 = d[4 * j + 2 * i], v1 = d[4 * j + 2 * i + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(partial + (blockIdx.z * M + m) * Cout + n) =
            make_float2(v0, v1);
      } else {
        const float2 bb = *reinterpret_cast<const float2*>(bias + n);
        *reinterpret_cast<__nv_bfloat162*>(out + m * Cout + n) =
            __floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);
      }
    }
  }
}

// out[m][n] = bf16(sum over splits, in order, of partial[s][m][n] + bias[n]);
// four channels per thread (Cout is a multiple of 64).
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float4* __restrict__ partial, const float* __restrict__ bias,
                     __nv_bfloat162* __restrict__ out, long long n4, int Cout, int splits) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += gridDim.x * 256LL) {
    float4 acc = partial[i];
    for (int s = 1; s < splits; ++s) {
      const float4 p = partial[s * n4 + i];
      acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
    }
    const float4 bb = *reinterpret_cast<const float4*>(bias + (4 * i) % Cout);
    out[2 * i] = __floats2bfloat162_rn(acc.x + bb.x, acc.y + bb.y);
    out[2 * i + 1] = __floats2bfloat162_rn(acc.z + bb.z, acc.w + bb.w);
  }
}

template <int CONSUMERS>
cudaError_t launch_tc(const CUtensorMap& xm, const CUtensorMap& wm, const float* bias,
                      __nv_bfloat16* out, float* partial, int B, int H, int W, int Cin, int Cout,
                      int box_h, int box_w, int splits, int steps_per_split, cudaStream_t stream) {
  using T = Tile<CONSUMERS>;
  static std::atomic<unsigned long long> allowed{0};
  cudaError_t err = allow_smem(conv3x3_tc_kernel<CONSUMERS>, T::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>(B * ((H + box_h - 1) / box_h) * ((W + box_w - 1) / box_w)),
                  static_cast<unsigned>((Cout + BN - 1) / BN), static_cast<unsigned>(splits));
  conv3x3_tc_kernel<CONSUMERS><<<grid, T::THREADS, T::SMEM, stream>>>(
      xm, wm, bias, out, splits > 1 ? partial : nullptr, H, W, Cin, Cout, box_h, box_w,
      steps_per_split, 9 * Cin / BK, M);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W,Cin) and w (3,3,Cin,Cout) bf16, bias (Cout) fp32, out (B,H,W,Cout)
// bf16, all contiguous on the device; workspace of splits*B*H*W*Cout fp32
// when splits > 1 (else unused).  Tiling and split from ops/conv3x3.py::plan.
// Launches on `stream`, allocates nothing.  Returns a cudaError_t, or minus
// the CUresult when a tensor map cannot be encoded.
extern "C" int conv3x3_tc_forward(const void* x, const void* w, const void* bias, void* out,
                                  void* workspace, int B, int H, int W, int Cin, int Cout,
                                  int box_h, int box_w, int bm, int splits, int steps_per_split,
                                  void* stream) {
  const int k_steps = 9 * Cin / BK;
  const bool ok = Cin % BK == 0 && Cout % 64 == 0 && Cin > 0 && Cout > 0 && B > 0 && H > 0 &&
                  W > 0 && (bm == 64 || bm == 128) && box_h * box_w == bm && box_w <= 256 &&
                  box_h <= 256 && splits >= 1 && steps_per_split >= 1 &&
                  (splits - 1) * steps_per_split < k_steps && splits * steps_per_split >= k_steps &&
                  (splits == 1 || workspace != nullptr) &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap xm, wm;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t xstrides[3] = {2ULL * Cin, 2ULL * Cin * W, 2ULL * Cin * W * H};
  const cuuint32_t xbox[4] = {BK, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1};
  CUresult r = encode(&xm, x, 4, xdims, xstrides, xbox);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(Cout), 9ULL * Cin};
  const cuuint64_t wstrides[1] = {2ULL * Cout};
  const cuuint32_t wbox[2] = {64, BK};
  r = encode(&wm, w, 2, wdims, wstrides, wbox);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b32 = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* ws = static_cast<float*>(workspace);
  cudaError_t err =
      bm == 128 ? launch_tc<2>(xm, wm, b32, o, ws, B, H, W, Cin, Cout, box_h, box_w, splits,
                               steps_per_split, s)
                : launch_tc<1>(xm, wm, b32, o, ws, B, H, W, Cin, Cout, box_h, box_w, splits,
                               steps_per_split, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(B) * H * W * Cout / 4;
  const long long blocks = (n4 + 255) / 256;
  splitk_reduce_kernel<<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(
      reinterpret_cast<const float4*>(ws), b32, reinterpret_cast<__nv_bfloat162*>(o), n4, Cout,
      splits);
  return static_cast<int>(cudaGetLastError());
}
