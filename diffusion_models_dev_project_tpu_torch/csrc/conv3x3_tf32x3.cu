// 3x3 stride-1 convolution with zero padding 1 in fp32 on Hopper's tensor
// cores: fp32 NHWC x HWIO + fp32 bias -> fp32 NHWC, each product taken as
// three TF32 products of split operands, fp32 accumulation.  The `tf32x3`
// variant of ops/conv3x3.py: the forward and, on the swapped operands, the
// input gradient.
//
// Replaces, for fp32 with Cin and Cout multiples of 64, the Pallas TPU kernel
// `_kernel` / `conv3x3_same` of diffusion_models_dev_project_tpu/ops/conv3x3.py
// at fp32, which the JAX package computes at Precision.HIGHEST (several bf16
// passes on the MXU, models/unet.py).  Splitting each fp32 value v into two
// TF32 values, hi = v with its low 13 bits cleared and lo = v - hi with
// its low 13 bits cleared, and summing hi*hi + hi*lo + lo*hi is the card's
// counterpart: it keeps about 21 bits of each operand (the dropped lo*lo
// and the bits cut from lo are below 2^-20 relative).  Clearing bits costs
// one logic op; `cvt.rna.tf32.f32` compiles to a compare, a select and
// integer ops.
//
// What bounds it on the H100: the UNet's convs are GEMMs of M = B*H*W
// pixels, N = Cout and K = 9*Cin, far above the ridge, so the bound is the
// TF32 tensor-core rate (495 TFLOP/s) for three products: 3 x FLOPs / 495 T,
// 2.24 ms per UNet forward, against 5.52 ms for any kernel on the fp32 CUDA
// cores (67 TFLOP/s), which is also where cuDNN without TF32 runs.  What the
// design does about it:
//
// - Implicit GEMM on `wgmma` m64n128k8 tf32, walked as K steps of one tap
//   (di, dj) x 32 input channels (128 bytes of fp32: one 128-byte swizzle
//   row).  `wgmma` takes 32-bit operands only K-major from shared memory.
// - A is a TMA box of x, (32 channels, Wt, Ht, 1) over the 4-D tensor (Cin,
//   W, H, B) at (c0, w0 + dj - 1, h0 + di - 1, b): the hardware zero-fills
//   what falls off the image (the conv's padding), and the box lands as
//   Ht*Wt rows of 128 bytes, K-major as it is.
// - A is split in shared memory, not in a pre-pass: each consumer warpgroup
//   cuts its 64 rows of the landed box in place to hi and writes lo beside
//   them (elementwise, so the swizzle needs no thought), fences the writes
//   for the async proxy and syncs its 128 threads, while the previous step's
//   wgmma still run.  No split copy of x reaches device memory.
// - B is the split kernel, (2, 9, N, K) fp32 with K contiguous: [0] the hi
//   parts, [1] the lo parts, made once per weight version by
//   `conv3x3_tf32x3_split_weight` (ops/conv3x3.py caches it on the weight).
//   For the forward B[t][n][k] = w[t][k][n]; for the input gradient (the
//   conv with the kernel flipped in space and Cin, Cout swapped) B[t][n][k] =
//   w[8 - t][n][k]: the HWIO weight flipped, no transpose.  Two 3-D TMA boxes
//   (32 channels, 128 outputs, 1) a step, at tap t and at 9 + t.
// - Per 8-channel slice of a step three wgmma: hi*hi, hi*lo, lo*hi, in that
//   order (12 a step).  The tensor cores do not round their fp32 sums to
//   nearest: the error of a chain of products into one accumulator grows
//   with its length, about linearly, where rounding to nearest would grow
//   as its square root.  So the accumulator restarts every PROMOTE steps,
//   and when their wgmma are done its sum is added to a separate fp32 total
//   in registers; a total every step would drain the pipeline every step.
// - A ring of 3 stages (64 KB each) for 128 x 128 output tiles (two consumer
//   warpgroups, one block per SM), or of 2 stages for 64 x 128 tiles (one
//   consumer warpgroup, two blocks per SM) when 128-pixel tiles are too few.
//   One thread of a producer warp after the consumers issues the TMA loads
//   (a warp, not a warpgroup, leaves registers for both the accumulator and
//   the total); `mbarrier`s carry "stage full" and "stage empty".  A wait on a barrier longer than about two seconds
//   traps instead of hanging the card.
// - Split-K for small maps as in conv3x3_tc.cu: blockIdx.z runs one range of
//   the K steps and writes its fp32 partial tile to a workspace; a second
//   kernel adds the partials in order, then the bias (no atomics: the same
//   bits run to run).  With one split the epilogue adds the bias and stores.
// - The bias is shared (`bias_stride` 0) or one row of Cout per image
//   (`bias_stride` Cout); the epilogue reads the row of the pixel's image.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tma_wgmma.cuh"

namespace {

constexpr int BK = 32;                     // input channels per K step
constexpr int ROW = BK * 4;                // bytes of an operand row: one 128-byte swizzle row
constexpr int BN = 128;                    // output channels per tile
constexpr int B_BYTES = BN * ROW;          // one B tile (hi or lo): 16 KB
constexpr int PROMOTE = 4;                 // K steps summed in the accumulator before the total

template <int CONSUMERS>                   // consumer warpgroups; 64 output pixels each
struct Tile {
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int STAGES = CONSUMERS == 2 ? 3 : 2;
  static constexpr int A_BYTES = BM * ROW;                    // one A tile (hi or lo)
  // a stage: A hi (x as it lands), A lo, B hi, B lo; TMA brings all but A lo
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  static constexpr int TMA_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int THREADS = 128 * CONSUMERS + 32;      // the consumers, then the producer warp
  // the ring, room to align it to 1024 bytes, the full and empty barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// K-major operand, rows of 128 bytes, 8-row swizzle atoms 1024 bytes apart;
// the k8 slice kk of a step starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return smem_desc(addr, 16, 1024); }

// v truncated to TF32: its low 13 bits cleared
__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
}

// v = hi + lo (to about 2^-20 relative), both TF32 values
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = tf32_trunc(v);
  lo = tf32_trunc(v - hi);
}

__device__ __forceinline__ void split4(float4& v, float4& lo) {
  split_tf32(v.x, v.x, lo.x);
  split_tf32(v.y, v.y, lo.y);
  split_tf32(v.z, v.z, lo.z);
  split_tf32(v.w, v.w, lo.w);
}

// Grid: (pixel tiles, channel tiles, splits), as in conv3x3_tc.cu.  `partial`
// is null with one split; otherwise split z writes partial[z][pixel][Cout].
template <int CONSUMERS>
__global__ void __launch_bounds__(Tile<CONSUMERS>::THREADS, 3 - CONSUMERS)
conv3x3_tf32x3_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                      int bias_stride, float* __restrict__ out, float* __restrict__ partial, int H,
                      int W, int Cin, int Cout, int box_h, int box_w, int steps_per_split,
                      int k_steps, long long M) {
  using T = Tile<CONSUMERS>;
  constexpr int STAGES = T::STAGES;
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
  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps up to STAGES steps of TMA in flight
    if (threadIdx.x == 128 * CONSUMERS) {
      int stage = 0, phase = 0;
      for (int s = s_begin; s < s_end; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);    // the first pass finds every stage free
        mbar_expect_tx(&full[stage], T::TMA_BYTES);
        const int tap = s / chunks;
        const int c0 = (s - tap * chunks) * BK;
        const int di = tap / 3, dj = tap - 3 * (tap / 3);
        const uint32_t a = smem_u32(smem + stage * T::STAGE_BYTES);
        const uint32_t bw = a + 2 * T::A_BYTES;
        tma_load_4d(a, &x_map, &full[stage], c0, w0 + dj - 1, h0 + di - 1, b);
        tma_load_3d(bw, &w_map, &full[stage], c0, n0, tap);                 // hi
        tma_load_3d(bw + B_BYTES, &w_map, &full[stage], c0, n0, 9 + tap);   // lo
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g owns output rows 64g .. 64g+63 of the tile
  const int g = wg;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  float d[64], total[64];     // the step's sum (tensor cores), the fp32 total
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = total[i] = 0.f;
  fence_operands(d);

  int stage = 0, phase = 0, prev = -1;
  for (int s = s_begin; s < s_end; ++s) {
    const int in_run = (s - s_begin) % PROMOTE;       // the step's place in its run
    const bool promote = in_run == PROMOTE - 1 || s + 1 == s_end;
    mbar_wait(&full[stage], phase);
    uint8_t* st = smem + stage * T::STAGE_BYTES;
    // split this warpgroup's 64 rows of x (8 KB) into hi (in place) and lo
    float4* hi4 = reinterpret_cast<float4*>(st + g * 64 * ROW);
    float4* lo4 = reinterpret_cast<float4*>(st + T::A_BYTES + g * 64 * ROW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v = hi4[tid + 128 * i], lo;
      split4(v, lo);
      hi4[tid + 128 * i] = v;
      lo4[tid + 128 * i] = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
    const uint32_t a_hi = smem_u32(st) + g * 64 * ROW;
    const uint32_t a_lo = a_hi + T::A_BYTES;
    const uint32_t b_hi = smem_u32(st) + 2 * T::A_BYTES;
    const uint32_t b_lo = b_hi + B_BYTES;
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma_m64n128k8_tf32(d, desc_k(a_hi + 32 * kk), desc_k(b_hi + 32 * kk), in_run | kk);
      wgmma_m64n128k8_tf32(d, desc_k(a_hi + 32 * kk), desc_k(b_lo + 32 * kk));
      wgmma_m64n128k8_tf32(d, desc_k(a_lo + 32 * kk), desc_k(b_hi + 32 * kk));
    }
    wgmma_commit();
    // the previous step's wgmma are done, or at the end of a run all of them:
    // hand the stages they read back to the producer
    if (promote) {
      wgmma_wait<0>();
      fence_operands(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += d[i];
    } else {
      wgmma_wait<1>();      // d stays untouched while the step's wgmma run
    }
    __syncwarp();
    if (lane == 0) {
      if (prev >= 0) mbar_arrive(&empty[prev]);
      if (promote) mbar_arrive(&empty[stage]);
    }
    prev = promote ? -1 : stage;
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();            // (the last step ran its run's end: nothing is in flight)
  fence_operands(d);

  // ---- epilogue.  Accumulator layout of m64nNk8: register 4j + 2i + e
  // holds row 16*warp + lane/4 + 8i, column 8j + 2*(lane%4) + e.
  const int col = n0 + 2 * (lane % 4);
  const float* bias_b = bias + static_cast<long long>(b) * bias_stride;   // the tile's image
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
      const float v0 = total[4 * j + 2 * i], v1 = total[4 * j + 2 * i + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(partial + (blockIdx.z * M + m) * Cout + n) =
            make_float2(v0, v1);
      } else {
        const float2 bb = *reinterpret_cast<const float2*>(bias_b + n);
        *reinterpret_cast<float2*>(out + m * Cout + n) = make_float2(v0 + bb.x, v1 + bb.y);
      }
    }
  }
}

// out[m][n] = the sum over splits, in order, of partial[s][m][n], plus the
// bias of m's image [n]; four channels per thread (Cout is a multiple of 64).
// `image_elems` = H*W*Cout, the output values of one image.
__global__ void __launch_bounds__(256)
splitk_reduce_f32_kernel(const float4* __restrict__ partial, const float* __restrict__ bias,
                         int bias_stride, float4* __restrict__ out, long long n4, int Cout,
                         long long image_elems, int splits) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += gridDim.x * 256LL) {
    float4 acc = partial[i];
    for (int s = 1; s < splits; ++s) {
      const float4 p = partial[s * n4 + i];
      acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
    }
    const long long e = 4 * i;
    const float4 bb = *reinterpret_cast<const float4*>(bias + (e / image_elems) * bias_stride +
                                                        e % Cout);
    out[i] = make_float4(acc.x + bb.x, acc.y + bb.y, acc.z + bb.z, acc.w + bb.w);
  }
}

// out (2, 9, N, K): the hi parts, then the lo parts, of the K-major kernel.
// flip 0 (forward): N = Cout, K = Cin, B[t][n][k] = w[t][k][n];
// flip 1 (input gradient): N = Cin, K = Cout, B[t][n][k] = w[8 - t][n][k].
__global__ void __launch_bounds__(256)
split_weight_kernel(const float* __restrict__ w, float* __restrict__ out, int Cin, int Cout,
                    int flip) {
  const long long per_tap = static_cast<long long>(Cin) * Cout;
  const long long total = 9 * per_tap;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += gridDim.x * 256LL) {
    const long long t = i / per_tap;
    const long long r = i - t * per_tap;
    float v;
    if (flip) {
      v = w[(8 - t) * per_tap + r];
    } else {
      const long long n = r / Cin, k = r - (r / Cin) * Cin;
      v = w[(t * Cin + k) * Cout + n];
    }
    float hi, lo;
    split_tf32(v, hi, lo);
    out[i] = hi;
    out[total + i] = lo;
  }
}

template <int CONSUMERS>
cudaError_t launch_tf32x3(const CUtensorMap& xm, const CUtensorMap& wm, const float* bias,
                          int bias_stride, float* out, float* partial, int B, int H, int W,
                          int Cin, int Cout, int box_h, int box_w, int splits,
                          int steps_per_split, cudaStream_t stream) {
  using T = Tile<CONSUMERS>;
  static std::atomic<unsigned long long> allowed{0};
  cudaError_t err = allow_smem(conv3x3_tf32x3_kernel<CONSUMERS>, T::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>(B * ((H + box_h - 1) / box_h) * ((W + box_w - 1) / box_w)),
                  static_cast<unsigned>((Cout + BN - 1) / BN), static_cast<unsigned>(splits));
  conv3x3_tf32x3_kernel<CONSUMERS><<<grid, T::THREADS, T::SMEM, stream>>>(
      xm, wm, bias, bias_stride, out, splits > 1 ? partial : nullptr, H, W, Cin, Cout, box_h,
      box_w, steps_per_split, 9 * Cin / BK, M);
  return cudaGetLastError();
}

}  // namespace

// The split kernel of the tf32x3 variant: w (3,3,Cin,Cout) fp32 HWIO, out
// (2,3,3,N,K) fp32 as split_weight_kernel lays it out (flip 0: the forward's,
// flip 1: the input gradient's), both contiguous on the device.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int conv3x3_tf32x3_split_weight(const void* w, void* out, int Cin, int Cout, int flip,
                                           void* stream) {
  if (Cin < 1 || Cout < 1 || w == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = 9LL * Cin * Cout;
  const long long blocks = (total + 255) / 256;
  split_weight_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(out), Cin, Cout, flip != 0);
  return static_cast<int>(cudaGetLastError());
}

// x (B,H,W,Cin) fp32, wsplit (2,3,3,Cout,Cin) fp32 from
// conv3x3_tf32x3_split_weight, bias fp32 (Cout) with bias_stride 0 or (B,Cout)
// with bias_stride Cout, out (B,H,W,Cout) fp32, all contiguous on the device;
// workspace of splits*B*H*W*Cout fp32 when splits > 1 (else unused).  Tiling
// and split from ops/conv3x3.py::plan.  Launches on `stream`, allocates
// nothing.  Returns a cudaError_t, or minus the CUresult when a tensor map
// cannot be encoded.
extern "C" int conv3x3_tf32x3_forward(const void* x, const void* wsplit, const void* bias,
                                      void* out, void* workspace, int B, int H, int W, int Cin,
                                      int Cout, int bias_stride, int box_h, int box_w, int bm,
                                      int splits, int steps_per_split, void* stream) {
  const int k_steps = 9 * Cin / BK;
  const bool ok = Cin % BK == 0 && Cout % 64 == 0 && Cin > 0 && Cout > 0 && B > 0 && H > 0 &&
                  W > 0 && (bias_stride == 0 || bias_stride == Cout) &&
                  (bm == 64 || bm == 128) && box_h * box_w == bm && box_w <= 256 &&
                  box_h <= 256 && splits >= 1 && steps_per_split >= 1 &&
                  (splits - 1) * steps_per_split < k_steps && splits * steps_per_split >= k_steps &&
                  (splits == 1 || workspace != nullptr) &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(wsplit) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap xm, wm;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t xstrides[3] = {4ULL * Cin, 4ULL * Cin * W, 4ULL * Cin * W * H};
  const cuuint32_t xbox[4] = {BK, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1};
  CUresult r = encode(&xm, x, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  // (K = Cin, N = Cout, 18 = hi taps then lo taps); rows past Cout fill with zeros
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(Cout), 18};
  const cuuint64_t wstrides[2] = {4ULL * Cin, 4ULL * Cin * Cout};
  const cuuint32_t wbox[3] = {BK, BN, 1};
  r = encode(&wm, wsplit, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b32 = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  cudaError_t err =
      bm == 128 ? launch_tf32x3<2>(xm, wm, b32, bias_stride, o, ws, B, H, W, Cin, Cout, box_h,
                                   box_w, splits, steps_per_split, s)
                : launch_tf32x3<1>(xm, wm, b32, bias_stride, o, ws, B, H, W, Cin, Cout, box_h,
                                   box_w, splits, steps_per_split, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(B) * H * W * Cout / 4;
  const long long blocks = (n4 + 255) / 256;
  splitk_reduce_f32_kernel<<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(
      reinterpret_cast<const float4*>(ws), b32, bias_stride, reinterpret_cast<float4*>(o), n4,
      Cout, static_cast<long long>(H) * W * Cout, splits);
  return static_cast<int>(cudaGetLastError());
}
