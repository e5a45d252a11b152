// 3x3 stride-1 convolution with zero padding 1, NHWC x HWIO + bias -> NHWC,
// on the CUDA cores: the `simt` and `narrow` variants of ops/conv3x3.py.
// (bf16 convs with Cin and Cout multiples of 64 go to the tensor cores,
// csrc/conv3x3_tc.cu.)
//
// Replaces the Pallas TPU kernel `_kernel` / `conv3x3_same` of
// diffusion_models_dev_project_tpu/ops/conv3x3.py (nine shifted matmuls over
// a haloed row tile, fp32 accumulation, I/O in the input dtype).
//
// `simt` takes every shape and dtype the others do not: fp32 I/O, the Cin = 1
// stem, channel counts that are not multiples of 64.  Such convs are GEMMs of
// M = B*H*W, N = Cout, K = 9*Cin, bound by arithmetic; this kernel runs them
// in fp32 FMA (67 TFLOP/s peak).  Design: implicit GEMM.  A block owns a
// 64-pixel x 64-channel output tile and walks K in chunks of 16.  Each chunk
// gathers its 64x16 slice of the virtual im2col matrix straight from x (the
// zero halo is a predicate, never a padded copy) and its 16x64 slice of the
// HWIO weight, converts both to fp32 in shared memory, and each of the 256
// threads accumulates a 4x4 micro-tile in registers, reading shared memory as
// float4.  Ragged edges (Cin = 1, M or N not a multiple of 64) are masked.
//
// `narrow` takes Cout < 16 (the UNet's final conv, 128 -> 1).  Its work is
// 9*Cin multiply-adds per output value, so it is bound by reading x once.  A
// block owns 16x16 output pixels, one per thread; it stages the haloed
// 18x18 input tile 16 channels at a time in shared memory (each input byte
// is read once by the block, 1.27 times overall), with the weights of those
// channels, and each thread sums its pixel's 9*Cin products for each output
// channel in registers.
//
// Both add the bias in the epilogue and round once to the output dtype.  The
// bias is shared (`bias_stride` 0) or a row of Cout per image (`bias_stride`
// Cout); the epilogue reads the row of the output pixel's image.
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
               const float* __restrict__ bias, int bias_stride, T* __restrict__ out,
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
    const float* bias_m = bias + static_cast<long long>(m / (H * W)) * bias_stride;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < Cout)
        store_f(out + static_cast<long long>(m) * Cout + n, acc[i][j] + bias_m[n]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, int bias_stride, void* out,
                   int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((Cout + BN - 1) / BN));
  conv3x3_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), bias_stride, static_cast<T*>(out), B, H, W, Cin, Cout);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- narrow
constexpr int NT_TILE = 16;                 // output pixels per block side
constexpr int NT_HALO = NT_TILE + 2;
constexpr int NT_C = 16;                    // input channels staged per pass
constexpr int NT_XS = NT_C + 4;             // float4-aligned row; spreads a quarter warp over the banks

// CO output channels (CO = 1, or up to 16 with the rest masked)
template <typename T, int CO>
__global__ void __launch_bounds__(NT_TILE * NT_TILE)
conv3x3_narrow_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, int bias_stride, T* __restrict__ out,
                      int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float xs[NT_HALO * NT_HALO][NT_XS];
  __shared__ __align__(16) float ws[9][CO][NT_C];
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * NT_TILE;
  const int w0 = blockIdx.x * NT_TILE;
  const int tid = threadIdx.x;
  const int ty = tid / NT_TILE, tx = tid % NT_TILE;
  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += NT_C) {
    for (int i = tid; i < NT_HALO * NT_HALO * NT_C; i += NT_TILE * NT_TILE) {
      const int p = i / NT_C, c = i % NT_C;
      const int hh = h0 - 1 + p / NT_HALO, ww = w0 - 1 + p % NT_HALO;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + c < Cin)
        v = load_f(x + ((static_cast<long long>(b) * H + hh) * W + ww) * Cin + c0 + c);
      xs[p][c] = v;
    }
    for (int i = tid; i < 9 * CO * NT_C; i += NT_TILE * NT_TILE) {
      const int tap = i / (CO * NT_C), o = (i / NT_C) % CO, c = i % NT_C;
      ws[tap][o][c] = (o < Cout && c0 + c < Cin)
                          ? load_f(w + (static_cast<long long>(tap) * Cin + c0 + c) * Cout + o)
                          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* xp = xs[(ty + tap / 3) * NT_HALO + tx + tap % 3];
#pragma unroll
      for (int c = 0; c < NT_C; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xp + c);
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          if (o >= Cout) break;
          const float4 k = *reinterpret_cast<const float4*>(&ws[tap][o][c]);
          acc[o] = fmaf(v.x, k.x, fmaf(v.y, k.y, fmaf(v.z, k.z, fmaf(v.w, k.w, acc[o]))));
        }
      }
    }
    __syncthreads();
  }

  const int hh = h0 + ty, ww = w0 + tx;
  if (hh < H && ww < W) {
    T* o_ptr = out + ((static_cast<long long>(b) * H + hh) * W + ww) * Cout;
    const float* bias_b = bias + static_cast<long long>(b) * bias_stride;
#pragma unroll
    for (int o = 0; o < CO; ++o)
      if (o < Cout) store_f(o_ptr + o, acc[o] + bias_b[o]);
  }
}

template <typename T>
cudaError_t launch_narrow(const void* x, const void* w, const void* bias, int bias_stride,
                          void* out, int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const dim3 grid((W + NT_TILE - 1) / NT_TILE, (H + NT_TILE - 1) / NT_TILE, B);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* bt = static_cast<const float*>(bias);
  T* ot = static_cast<T*>(out);
  if (Cout == 1)
    conv3x3_narrow_kernel<T, 1><<<grid, NT_TILE * NT_TILE, 0, stream>>>(
        xt, wt, bt, bias_stride, ot, H, W, Cin, Cout);
  else
    conv3x3_narrow_kernel<T, 16><<<grid, NT_TILE * NT_TILE, 0, stream>>>(
        xt, wt, bt, bias_stride, ot, H, W, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace

// The simt variant.  x (B,H,W,Cin) and w (3,3,Cin,Cout) in fp32 or bf16
// (is_bf16), bias fp32, (Cout) with bias_stride 0 or (B,Cout) with
// bias_stride Cout, out (B,H,W,Cout) in the input dtype; all contiguous on
// the device.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int conv3x3_forward(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int Cin,
                               int Cout, int bias_stride, int is_bf16, void* stream) {
  if (bias_stride != 0 && bias_stride != Cout) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, bias, bias_stride, out, B, H, W, Cin, Cout, s)
              : launch<float>(x, w, bias, bias_stride, out, B, H, W, Cin, Cout, s);
  return static_cast<int>(err);
}

// The narrow variant, Cout < 16; arguments as for conv3x3_forward.
extern "C" int conv3x3_narrow_forward(const void* x, const void* w, const void* bias,
                                      void* out, int B, int H, int W, int Cin,
                                      int Cout, int bias_stride, int is_bf16, void* stream) {
  if (Cout < 1 || Cout > 16 || (bias_stride != 0 && bias_stride != Cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_narrow<__nv_bfloat16>(x, w, bias, bias_stride, out, B, H, W, Cin, Cout, s)
              : launch_narrow<float>(x, w, bias, bias_stride, out, B, H, W, Cin, Cout, s);
  return static_cast<int>(err);
}
