// Weight gradient of the 3x3 stride-1 zero-pad-1 convolution in fp32 on the
// tensor cores, each product taken as three TF32 products of split operands:
// the `tf32x3` variant of ops/conv3x3.py::wgrad_plan (fp32 with Cin and Cout
// multiples of 64: the UNet's 60 hot convs when it trains or adapts in fp32).
//
//   dW[di, dj, ci, co] = sum over (b, h, w) of x[b, h+di-1, w+dj-1, ci] * dy[b, h, w, co]
//
// Replaces no TPU kernel: the JAX package differentiates its XLA conv (the
// Pallas kernel `_kernel` / `conv3x3_same` of
// diffusion_models_dev_project_tpu/ops/conv3x3.py has no backward), at
// Precision.HIGHEST in fp32.  It is the third GEMM of the conv: M = 9 Cin
// rows (tap, input channel), N = Cout, K = B H W pixels.
//
// What bounds it on the H100: at the UNet's shapes a GEMM far above the
// ridge, so the TF32 tensor-core rate for three products (3 x FLOPs / 495
// TFLOP/s), against FLOPs / 67 TFLOP/s on the fp32 CUDA cores (`simt`,
// conv3x3_wgrad.cu).  What the design does about it:
//
// - In NHWC neither operand is K-major (K is the pixel axis), and `wgmma`
//   takes 32-bit operands only K-major, so this kernel runs `mma.sync`
//   m16n8k8 tf32, whose fragments are loaded one word per register from
//   pixel-major shared tiles: A = x^T (a fragment word is x[pixel k][channel
//   m]) and B = dy (dy[pixel k][channel n]).  Rows padded to 136 floats (8
//   mod 32 banks) keep those reads free of bank conflicts.
// - Each fragment word v is split in registers, hi = v with its low 13 bits
//   cleared and lo = v - hi the same: three instructions, where
//   `cvt.rna.tf32.f32` compiles to a compare, a select and integer ops (the
//   kernel issues several other instructions per product; tf32x3_probe.py
//   prints its SASS opcode mix).  Each 8-pixel slice issues hi*hi, hi*lo,
//   lo*hi into one fp32 accumulator, in that order.  Splitting each staged
//   value once per block into (hi, lo) pairs instead was slower: forming
//   the fragments' register groups from the pairs took more moves than the
//   splits it saved.
// - The skeleton of the bf16 `mma` variant (conv3x3_wgrad.cu): a block owns
//   128 input channels of one tap by 128 output channels and a range of K;
//   its 8 warps each hold a 64 x 32 fp32 accumulator.  Stages of 32 pixels of
//   the tap-shifted x and of dy land by `cp.async` (16-byte copies; the halo
//   and the ragged ends are zero-filled copies that read nothing), three
//   stages in flight, two blocks per SM.
// - Deterministic: no atomics.  Each split of K writes its fp32 partial tile
//   to a workspace, and `conv3x3_wgrad_reduce` (conv3x3_wgrad.cu) adds the
//   splits in a fixed order; with one split the block writes dW itself.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"

extern "C" int conv3x3_wgrad_reduce(const void* workspace, void* dw, long long n, int splits,
                                    void* stream);

namespace {

constexpr int TBM = 128;                  // input channels (of one tap) per block
constexpr int TBN = 128;                  // output channels per block
constexpr int TBK = 32;                   // pixels per stage
constexpr int TNT = 256;                  // 8 warps, 2 x 4, each 64 x 32
constexpr int TLD = TBM + 8;              // shared row stride in floats (TBN == TBM)
constexpr int TSTAGES = 3;                // stages in flight: two loads ahead of the products
constexpr int TSTAGE = TBK * TLD;         // floats of one tile of one stage
constexpr int SMEM_BYTES = 2 * TSTAGES * TSTAGE * 4;    // x and dL/dy tiles: 104,448

// pixel p of the flattened (B, H, W) grid: the offset of its tap-shifted
// source pixel in x (in pixels), or -1 outside the image or past p_end
__device__ __forceinline__ long long shifted_src(int p, int p_end, int H, int W, int di, int dj) {
  if (p >= p_end) return -1;
  const int hw = H * W;
  const int b = p / hw;
  const int r = p - b * hw;
  const int h = r / W + di - 1;
  const int w = r - (r / W) * W + dj - 1;
  if (h < 0 || h >= H || w < 0 || w >= W) return -1;
  return (static_cast<long long>(b) * H + h) * W + w;
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

// grid: x = tile (co block fastest, then ci block, then tap), y = split
__global__ void __launch_bounds__(TNT, 2)
wgrad_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
                    int steps_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;                             // [TSTAGES][TBK][TLD]
  float* const ds = smem + TSTAGES * TSTAGE;          // [TSTAGES][TBK][TLD]

  const int n_co = (Cout + TBN - 1) / TBN;
  const int n_ci = (Cin + TBM - 1) / TBM;
  const int co0 = (blockIdx.x % n_co) * TBN;
  const int ci0 = ((blockIdx.x / n_co) % n_ci) * TBM;
  const int tap = blockIdx.x / (n_co * n_ci);
  const int di = tap / 3, dj = tap % 3;
  const int P = B * H * W;
  const int k_begin = blockIdx.y * steps_per_split * TBK;
  const int k_end = min(P, k_begin + steps_per_split * TBK);
  const int n_steps = (k_end - k_begin + TBK - 1) / TBK;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;

  // loader roles: rows r, r + 8, r + 16, r + 24 of a stage, 16-byte chunk c (4 channels)
  const int lr = tid >> 5, lc = (tid & 31) * 4;
  const bool x_col = ci0 + lc < Cin;
  const bool d_col = co0 + lc < Cout;

  auto load_stage = [&](int s) {
    if (s >= n_steps) return;
    const int k0 = k_begin + s * TBK;
    float* const xb = xs + (s % TSTAGES) * TSTAGE;
    float* const db = ds + (s % TSTAGES) * TSTAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 8 * i;
      const int p = k0 + r;
      const long long src = shifted_src(p, k_end, H, W, di, dj);
      const bool xin = x_col && src >= 0;
      cp_async16(smem_u32(xb + r * TLD + lc), xin ? x + src * Cin + ci0 + lc : x, xin ? 16 : 0);
      const bool din = d_col && p < k_end;
      cp_async16(smem_u32(db + r * TLD + lc),
                 din ? dy + static_cast<long long>(p) * Cout + co0 + lc : dy, din ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one commit group per stage, empty past the last step, so that
  // wait<TSTAGES - 2> always leaves stage s landed
#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();             // stage s landed for all; stage s - 1's buffer is free
    load_stage(s + TSTAGES - 1);
    cp_async_commit();
    const float* const xb = xs + (s % TSTAGES) * TSTAGE;
    const float* const db = ds + (s % TSTAGES) * TSTAGE;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 8) {
      // B = dy (8 pixels x 8 channels, col): b0 = (k t, n g), b1 = (k t + 4, n g)
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = wn + nj * 8 + g;
        split_tf32(db[(kk + t) * TLD + n], bh[nj][0], bl[nj][0]);
        split_tf32(db[(kk + t + 4) * TLD + n], bh[nj][1], bl[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // A = x^T (16 channels x 8 pixels, row): (m g, k t), (m g + 8, k t),
        // (m g, k t + 4), (m g + 8, k t + 4)
        const int m = wm + mi * 16 + g;
        uint32_t ah[4], al[4];
        split_tf32(xb[(kk + t) * TLD + m], ah[0], al[0]);
        split_tf32(xb[(kk + t) * TLD + m + 8], ah[1], al[1]);
        split_tf32(xb[(kk + t + 4) * TLD + m], ah[2], al[2]);
        split_tf32(xb[(kk + t + 4) * TLD + m + 8], ah[3], al[3]);
        // each product over the four accumulators before the next: a
        // product never waits on the one just issued into its accumulator
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mi][nj], ah, bh[nj][0], bh[nj][1]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mi][nj], ah, bl[nj][0], bl[nj][1]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mi][nj], al, bh[nj][0], bh[nj][1]);
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: (row g, cols 2t, 2t+1) and (row g+8, the same cols)
  float* dst = out + static_cast<long long>(blockIdx.y) * 9 * Cin * Cout;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + wm + mi * 16 + g + half * 8;
      if (ci >= Cin) continue;
      float* row = dst + (static_cast<long long>(tap) * Cin + ci) * Cout;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int co = co0 + wn + nj * 8 + 2 * t;
        if (co < Cout)          // Cout % 64 == 0: co + 1 < Cout too
          *reinterpret_cast<float2*>(row + co) =
              make_float2(acc[mi][nj][half * 2], acc[mi][nj][half * 2 + 1]);
      }
    }
}

}  // namespace

// x (B,H,W,Cin) and dy (B,H,W,Cout) fp32, 16-byte aligned, Cin and Cout
// multiples of 64; dw (3,3,Cin,Cout) fp32; workspace (splits, 9 Cin Cout)
// fp32 when splits > 1 (else unused, may be null).  All contiguous on the
// device.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int conv3x3_wgrad_tf32x3(const void* x, const void* dy, void* dw, void* workspace,
                                    int B, int H, int W, int Cin, int Cout, int splits,
                                    int steps_per_split, void* stream) {
  const long long P = static_cast<long long>(B) * H * W;
  const long long per = static_cast<long long>(steps_per_split) * TBK;
  if (Cin < 64 || Cin % 64 || Cout < 64 || Cout % 64 || P < 1 || P > 0x7fffffffLL ||
      splits < 1 || splits > 65535 || steps_per_split < 1 || (splits - 1) * per >= P ||
      splits * per < P || (splits > 1 && workspace == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? workspace : dw);
  static std::atomic<unsigned long long> allowed{0};    // devices whose limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !((allowed.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(wgrad_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed.fetch_or(1ULL << dev);
  }
  const long long tiles = 9LL * ((Cin + TBM - 1) / TBM) * ((Cout + TBN - 1) / TBN);
  wgrad_tf32x3_kernel<<<dim3(static_cast<unsigned>(tiles), splits), TNT, SMEM_BYTES, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), dst, B, H, W, Cin, Cout,
      steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return conv3x3_wgrad_reduce(workspace, dw, 9LL * Cin * Cout, splits, stream);
}
