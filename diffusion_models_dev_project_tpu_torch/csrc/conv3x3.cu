// 3x3 stride-1 convolution with zero padding 1, NHWC x HWIO + bias -> NHWC.
//
// Replaces the Pallas TPU kernel `_kernel` / `conv3x3_same` of
// diffusion_models_dev_project_tpu/ops/conv3x3.py (nine shifted matmuls over
// a haloed row tile, fp32 accumulation, I/O in the input dtype).
//
// What bounds it on the H100: at the UNet's shapes the conv is a GEMM of
// M = B*H*W pixels, N = Cout and K = 9*Cin (K from 9 to 9216), far above the
// card's ~295 FLOP/byte ridge, so it is bound by arithmetic.  This first
// version runs on the CUDA cores (fp32 FMA, 67 TFLOP/s peak), not the tensor
// cores (989 TFLOP/s bf16): it is written to be right first.
//
// Design: implicit GEMM.  A block owns a 64-pixel x 64-channel output tile
// and walks K in chunks of 16.  Each chunk gathers its 64x16 slice of the
// virtual im2col matrix straight from x (the zero halo is a predicate, never
// a padded copy) and its 16x64 slice of the HWIO weight, converts both to
// fp32 in shared memory, and each of the 256 threads accumulates a 4x4
// micro-tile in registers, reading shared memory as float4.  Bias is added in
// the epilogue, and the result is rounded once to the output dtype.  Ragged
// edges (Cin = 1, Cout = 1, 8x8 maps, M or N not a multiple of 64) are
// masked.  The next steps are tensor cores (mma.sync / wgmma from TMA-fed
// shared memory) and a fused GroupNorm-SiLU prologue.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 16;    // reduction chunk of K = 9 * Cin
constexpr int TM = 4;     // pixels per thread
constexpr int TN = 4;     // channels per thread
constexpr int NT = (BM / TM) * (BN / TN);   // 256 threads

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               int B, int H, int W, int Cin, int Cout) {
  // rows padded by 4 floats: the gather's stores then spread over the banks,
  // and every row still starts on a 16-byte boundary for the float4 reads
  __shared__ __align__(16) float As[BK][BM + 4];   // im2col slice, k-major
  __shared__ __align__(16) float Bs[BK][BN];   // weight slice, k-major

  const int M = B * H * W;
  const int K = 9 * Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // loader roles: A element (pixel a_m + 16*i, reduction index a_k);
  // B element (reduction index b_k + 4*i, channel b_n)
  const int a_k = tid % BK;
  const int a_m = tid / BK;            // 0..15
  const int b_n = tid % BN;
  const int b_k = tid / BN;            // 0..3

  // the four pixels this thread gathers, decoded once
  int pb[4], ph[4], pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_m + 16 * i;
    if (m < M) {
      pb[i] = m / (H * W);
      const int r = m - pb[i] * H * W;
      ph[i] = r / W;
      pw[i] = r - ph[i] * W;
    } else {
      pb[i] = -1; ph[i] = 0; pw[i] = 0;
    }
  }

  // compute roles: pixels ty*4 .. ty*4+3, channels tx*4 .. tx*4+3
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // ---- gather the im2col slice: (64 pixels) x (16 reduction indices)
    {
      const int k = k0 + a_k;
      int tap = 0, ci = 0;
      if (k < K) { tap = k / Cin; ci = k - tap * Cin; }
      const int di = tap / 3 - 1;
      const int dj = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = 0.f;
        const int hh = ph[i] + di;
        const int ww = pw[i] + dj;
        if (k < K && pb[i] >= 0 && hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = load_f(x + ((static_cast<long long>(pb[i]) * H + hh) * W + ww) * Cin + ci);
        As[a_k][a_m + 16 * i] = v;
      }
    }
    // ---- weight slice: (16 reduction indices) x (64 output channels)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kl = b_k + 4 * i;
      const int k = k0 + kl;
      const int n = n0 + b_n;
      Bs[kl][b_n] = (k < K && n < Cout)
                        ? load_f(w + static_cast<long long>(k) * Cout + n) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- epilogue: + bias, round once to the output dtype
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < Cout)
        store_f(out + static_cast<long long>(m) * Cout + n, acc[i][j] + bias[n]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((Cout + BN - 1) / BN));
  conv3x3_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), B, H, W, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W,Cin) and w (3,3,Cin,Cout) in fp32 or bf16 (is_bf16), bias (Cout)
// fp32, out (B,H,W,Cout) in the input dtype; all contiguous on the device.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int conv3x3_forward(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int Cin,
                               int Cout, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, bias, out, B, H, W, Cin, Cout, s)
              : launch<float>(x, w, bias, out, B, H, W, Cin, Cout, s);
  return static_cast<int>(err);
}
