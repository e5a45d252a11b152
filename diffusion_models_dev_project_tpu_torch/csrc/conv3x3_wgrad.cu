// Weight gradient of the 3x3 stride-1 zero-pad-1 convolution of conv3x3.cu
// and conv3x3_tc.cu, NHWC x HWIO:
//
//   dW[di, dj, ci, co] = sum over (b, h, w) of x[b, h+di-1, w+dj-1, ci] * dy[b, h, w, co]
//
// with a zero halo, fp32 accumulation and an fp32 (3, 3, Cin, Cout) result.
// The JAX package differentiates its XLA conv (the Pallas kernel
// `_kernel` / `conv3x3_same` of diffusion_models_dev_project_tpu/ops/conv3x3.py
// has no backward); the port's forward and input gradient are hand kernels,
// and this is the third GEMM of the same conv: M = 9 Cin rows (tap, input
// channel), N = Cout columns, K = B H W pixels.  ops/conv3x3.py::wgrad_plan
// picks the variant and the split of K.
//
// What bounds it on the H100: at the UNet's shapes it does the forward's
// operations (2 K M N, 1.1 TFLOP per batch-3 training backward) over a few
// hundred MB, so the tensor cores bound it; the shapes run from K = 196,608
// pixels with M x N = 1152 x 128 (256², batch 3) to K = 192 with
// 9216 x 512 (8²), so the grid has to split K where the M x N tiles are few.
//
// - `mma` (bf16, Cin and Cout multiples of 16): a block owns 128 input
//   channels of one tap by 128 output channels, and a range of K.  Its 8
//   warps each hold a 64 x 32 fp32 accumulator and run `mma.sync`
//   m16n8k16 bf16 x bf16 -> fp32: 64 operations per byte staged, twice a
//   64 x 64 tile's.  A stage of 32 pixels of the tap-shifted x and of dy
//   lands in shared memory by `cp.async` (16-byte copies; the halo and the
//   ragged ends are zero-filled copies that read nothing), four stages in
//   flight; both tiles are pixel-major, so `ldmatrix.trans` forms the A
//   (x^T) and B (dy) fragments.  Rows padded by 16 bytes keep ldmatrix
//   free of bank conflicts.
// - `simt` (fp32 FMA, any dtype and channel count: fp32 convs, the Cin = 1
//   stem, the Cout = 1 final conv): a block owns 64 (tap, channel) rows by
//   64 output channels and a range of K; 256 threads each accumulate a
//   4 x 4 tile, 16 pixels per stage through shared memory.  For Cout <= 16
//   (the final conv: a product with one column, bound by reading x) a
//   thread owns one (tap, channel) row of a 256-row block and walks the
//   split's pixels row by row of the image, reading x coalesced across the
//   block and dL/dy as a broadcast.
// - Determinism: no atomics.  A split of K writes its fp32 partial tile to
//   a workspace, and `wgrad_reduce_kernel` adds the splits in their order;
//   with one split the block writes dW itself.  Two launches give the same
//   bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"

namespace {

// ---------------------------------------------------------------- mma
constexpr int MBM = 128;         // input channels (of one tap) per block
constexpr int MBN = 128;         // output channels per block
constexpr int MBK = 32;          // pixels per stage
constexpr int MNT = 256;         // 8 warps, 2 x 4, each 64 x 32
constexpr int MLD = MBM + PAD;   // shared row stride (bf16); MBN == MBM
constexpr int STAGES = 4;        // stages in flight: three loads ahead of the products
constexpr int STAGE_ELEMS = MBK * MLD;                          // one tile of one stage
constexpr int MMA_SMEM_BYTES = 2 * STAGES * STAGE_ELEMS * 2;    // x and dL/dy tiles

// decode pixel p of the flattened (B, H, W) grid and return the offset of
// the tap-shifted source pixel in x (in pixels), or -1 outside the image
__device__ __forceinline__ long long shifted_pixel(int p, int P, int H, int W, int di, int dj) {
  if (p >= P) return -1;
  const int hw = H * W;
  const int b = p / hw;
  const int r = p - b * hw;
  const int h = r / W + di - 1;
  const int w = r - (r / W) * W + dj - 1;
  if (h < 0 || h >= H || w < 0 || w >= W) return -1;
  return (static_cast<long long>(b) * H + h) * W + w;
}

// grid: x = tile (co block fastest, then ci block, then tap), y = split
__global__ void __launch_bounds__(MNT)
wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 float* __restrict__ out, int B, int H, int W, int Cin, int Cout,
                 int steps_per_split) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* const xs = smem;                             // [STAGES][MBK][MLD]
  bf16* const ds = smem + STAGES * STAGE_ELEMS;      // [STAGES][MBK][MLD]

  const int n_co = (Cout + MBN - 1) / MBN;
  const int n_ci = (Cin + MBM - 1) / MBM;
  const int co0 = (blockIdx.x % n_co) * MBN;
  const int ci0 = ((blockIdx.x / n_co) % n_ci) * MBM;
  const int tap = blockIdx.x / (n_co * n_ci);
  const int di = tap / 3, dj = tap % 3;
  const int P = B * H * W;
  const int k_begin = blockIdx.y * steps_per_split * MBK;
  const int k_end = min(P, k_begin + steps_per_split * MBK);
  const int n_steps = (k_end - k_begin + MBK - 1) / MBK;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  // loader roles: rows r and r + 16 of a stage, 16-byte chunk c (8 channels)
  const int lr = tid >> 4, lc = (tid & 15) * 8;
  const bool x_col = ci0 + lc < Cin;
  const bool d_col = co0 + lc < Cout;

  // stage s of the split into buffer s % STAGES (nothing past the last step)
  auto load_stage = [&](int s) {
    if (s >= n_steps) return;
    const int k0 = k_begin + s * MBK;
    bf16* const xb = xs + (s % STAGES) * STAGE_ELEMS;
    bf16* const db = ds + (s % STAGES) * STAGE_ELEMS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 16 * i;
      const int p = k0 + r;
      const long long src = shifted_pixel(p, k_end, H, W, di, dj);
      const bool xin = x_col && src >= 0;
      cp_async16(smem_u32(xb + r * MLD + lc), xin ? x + src * Cin + ci0 + lc : x, xin ? 16 : 0);
      const bool din = d_col && p < k_end;
      cp_async16(smem_u32(db + r * MLD + lc),
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
  // wait<STAGES - 2> always leaves stage s landed
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // stage s landed for all; stage s - 1's buffer is free
    load_stage(s + STAGES - 1);
    cp_async_commit();
    const bf16* const xb = xs + (s % STAGES) * STAGE_ELEMS;
    const bf16* const db = ds + (s % STAGES) * STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < MBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // A = x^T: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        const int k = kk + (lane & 7) + (lane >> 4) * 8;
        const int m = wm + mi * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(a[mi], smem_u32(xb + k * MLD + m));
      }
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        // B = dy: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        uint32_t b[4];
        const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn + nj * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, smem_u32(db + k * MLD + n));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: (row g, cols 2c, 2c+1) and (row g+8, the same cols)
  float* dst = out + static_cast<long long>(blockIdx.y) * 9 * Cin * Cout;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + wm + mi * 16 + g + half * 8;
      if (ci >= Cin) continue;
      float* row = dst + (static_cast<long long>(tap) * Cin + ci) * Cout;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int co = co0 + wn + nj * 8 + c2;
        if (co < Cout)          // Cout % 16 == 0: co + 1 < Cout too
          *reinterpret_cast<float2*>(row + co) =
              make_float2(acc[mi][nj][half * 2], acc[mi][nj][half * 2 + 1]);
      }
    }
}

// ---------------------------------------------------------------- simt
constexpr int SBK = 16;          // pixels per stage
constexpr int SNT = 256;         // 16 x 16 threads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// grid: x = tile (n block fastest), y = split.  Rows m = tap * Cin + ci.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(SNT)
wgrad_simt_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ out,
                  int B, int H, int W, int Cin, int Cout, int steps_per_split) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float as[SBK][BM];
  __shared__ float bs[SBK][BN];

  const int M = 9 * Cin;
  const int n_n = (Cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_n) * BM;
  const int n0 = (blockIdx.x % n_n) * BN;
  const int P = B * H * W;
  const int k_begin = blockIdx.y * steps_per_split * SBK;
  const int k_end = min(P, k_begin + steps_per_split * SBK);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // this thread's A column (fixed over the stages): row m of dW
  const int am = tid % BM;
  const int m = m0 + am;
  const bool m_in = m < M;
  const int tap = m_in ? m / Cin : 0;
  const int ci = m_in ? m - tap * Cin : 0;
  const int bn_col = tid % BN;
  const bool n_in = n0 + bn_col < Cout;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += SBK) {
    for (int k = tid / BM; k < SBK; k += SNT / BM) {
      float v = 0.f;
      const int p = k0 + k;
      if (m_in && p < k_end) {
        const int hw = H * W;
        const int b = p / hw;
        const int r = p - b * hw;
        const int h = r / W + tap / 3 - 1;
        const int w = r % W + tap % 3 - 1;
        if (h >= 0 && h < H && w >= 0 && w < W)
          v = to_f(x[((static_cast<long long>(b) * H + h) * W + w) * Cin + ci]);
      }
      as[k][am] = v;
    }
    for (int k = tid / BN; k < SBK; k += SNT / BN) {
      const int p = k0 + k;
      bs[k][bn_col] = (n_in && p < k_end)
                          ? to_f(dy[static_cast<long long>(p) * Cout + n0 + bn_col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = out + static_cast<long long>(blockIdx.y) * M * Cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int mm = m0 + ty + 16 * i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nn = n0 + tx + 16 * j;
      if (nn < Cout) dst[static_cast<long long>(mm) * Cout + nn] = acc[i][j];
    }
  }
}

// Cout <= CO: thread = one row m = tap * Cin + ci of dW, 256 rows a block;
// grid x = row block, y = split.  The pixels of the split are walked one
// image row at a time, so that the tap's source row and its bounds are
// worked out once per row.
template <typename T, int CO>
__global__ void __launch_bounds__(SNT)
wgrad_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ out,
                  int B, int H, int W, int Cin, int Cout, int steps_per_split) {
  const int M = 9 * Cin;
  const int m = blockIdx.x * SNT + threadIdx.x;
  const bool m_in = m < M;
  const int tap = m_in ? m / Cin : 0;
  const int ci = m_in ? m - tap * Cin : 0;
  const int di = tap / 3, dj = tap % 3;
  const int P = B * H * W;
  const int hw = H * W;
  const int k_begin = blockIdx.y * steps_per_split * SBK;
  const int k_end = min(P, k_begin + steps_per_split * SBK);
  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;
  for (int p = k_begin; p < k_end;) {
    const int b = p / hw;
    const int r = p - b * hw;
    const int h = r / W, w0 = r - (r / W) * W;
    const int run = min(W - w0, k_end - p);     // pixels left in this image row
    const int hs = h + di - 1;
    const bool row_in = m_in && hs >= 0 && hs < H;
    const T* xrow = x + (static_cast<long long>(b) * H + (row_in ? hs : 0)) * W * Cin + ci;
    const T* drow = dy + static_cast<long long>(p) * Cout;
    for (int j = 0; j < run; ++j) {
      const int ws = w0 + j + dj - 1;
      const float v = (row_in && ws >= 0 && ws < W) ? to_f(xrow[static_cast<long long>(ws) * Cin])
                                                     : 0.f;
#pragma unroll
      for (int o = 0; o < CO; ++o)
        if (o < Cout) acc[o] = fmaf(v, to_f(drow[j * Cout + o]), acc[o]);
    }
    p += run;
  }
  if (!m_in) return;
  float* dst = out + static_cast<long long>(blockIdx.y) * M * Cout + static_cast<long long>(m) * Cout;
#pragma unroll
  for (int o = 0; o < CO; ++o)
    if (o < Cout) dst[o] = acc[o];
}

// ---------------------------------------------------------------- reduce
// out[i] = ws[0][i] + ws[1][i] + ... in split order: the same bits every time
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                    long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = ws[i];
  for (int k = 1; k < splits; ++k) s += ws[k * n + i];
  out[i] = s;
}

cudaError_t reduce(const float* ws, float* out, int Cin, int Cout, int splits, cudaStream_t s) {
  const long long n = 9LL * Cin * Cout;
  const int threads = 256;
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
      ws, out, n, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* x, const void* dy, float* dst, int B, int H, int W, int Cin,
                        int Cout, int splits, int steps_per_split, cudaStream_t s) {
  const dim3 grid((9 * Cin + SNT - 1) / SNT, splits);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  if (Cout == 1)
    wgrad_rows_kernel<T, 1><<<grid, SNT, 0, s>>>(xt, dt, dst, B, H, W, Cin, Cout, steps_per_split);
  else
    wgrad_rows_kernel<T, 16><<<grid, SNT, 0, s>>>(xt, dt, dst, B, H, W, Cin, Cout, steps_per_split);
  return cudaGetLastError();
}

template <typename T, int BM, int BN>
cudaError_t launch_simt(const void* x, const void* dy, float* dst, int B, int H, int W, int Cin,
                        int Cout, int splits, int steps_per_split, cudaStream_t s) {
  const long long tiles = static_cast<long long>((9 * Cin + BM - 1) / BM) * ((Cout + BN - 1) / BN);
  const dim3 grid(static_cast<unsigned>(tiles), splits);
  wgrad_simt_kernel<T, BM, BN><<<grid, SNT, 0, s>>>(static_cast<const T*>(x),
                                                    static_cast<const T*>(dy), dst, B, H, W, Cin,
                                                    Cout, steps_per_split);
  return cudaGetLastError();
}

bool bad_split(int B, int H, int W, int splits, int steps_per_split, int bk) {
  const long long P = static_cast<long long>(B) * H * W;
  const long long per = static_cast<long long>(steps_per_split) * bk;
  // every split non-empty, and the splits cover K
  return splits < 1 || splits > 65535 || steps_per_split < 1 || P < 1 || P > 0x7fffffffLL ||
         (splits - 1) * per >= P || splits * per < P;
}

}  // namespace

// The mma variant: x (B,H,W,Cin) and dy (B,H,W,Cout) bf16, 16-byte aligned,
// Cin and Cout multiples of 16; dw (3,3,Cin,Cout) fp32; workspace
// (splits, 9 Cin Cout) fp32 when splits > 1 (else unused, may be null).
// All contiguous on the device.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int conv3x3_wgrad_mma(const void* x, const void* dy, void* dw, void* workspace,
                                 int B, int H, int W, int Cin, int Cout, int splits,
                                 int steps_per_split, void* stream) {
  if (Cin < 16 || Cin % 16 || Cout < 16 || Cout % 16 || bad_split(B, H, W, splits, steps_per_split, MBK) ||
      (splits > 1 && workspace == nullptr) ||
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
    err = cudaFuncSetAttribute(wgrad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MMA_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed.fetch_or(1ULL << dev);
  }
  const long long tiles = 9LL * ((Cin + MBM - 1) / MBM) * ((Cout + MBN - 1) / MBN);
  wgrad_mma_kernel<<<dim3(static_cast<unsigned>(tiles), splits), MNT, MMA_SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), dst, B, H, W, Cin, Cout,
      steps_per_split);
  err = cudaGetLastError();
  if (err == cudaSuccess && splits > 1)
    err = reduce(static_cast<const float*>(workspace), static_cast<float*>(dw), Cin, Cout,
                 splits, s);
  return static_cast<int>(err);
}

// The simt variant: x and dy in fp32 or bf16 (is_bf16), any channel counts;
// bn is 64 (64 x 64 tiles), or 16 for Cout <= 16 (a thread per row of dW,
// 256 rows a block); other arguments as for conv3x3_wgrad_mma.
extern "C" int conv3x3_wgrad_simt(const void* x, const void* dy, void* dw, void* workspace,
                                  int B, int H, int W, int Cin, int Cout, int is_bf16, int bn,
                                  int splits, int steps_per_split, void* stream) {
  if (Cin < 1 || Cout < 1 || (bn != 64 && (bn != 16 || Cout > 16)) ||
      bad_split(B, H, W, splits, steps_per_split, SBK) || (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? workspace : dw);
  cudaError_t err;
  if (is_bf16)
    err = bn == 64 ? launch_simt<bf16, 64, 64>(x, dy, dst, B, H, W, Cin, Cout, splits, steps_per_split, s)
                   : launch_rows<bf16>(x, dy, dst, B, H, W, Cin, Cout, splits, steps_per_split, s);
  else
    err = bn == 64 ? launch_simt<float, 64, 64>(x, dy, dst, B, H, W, Cin, Cout, splits, steps_per_split, s)
                   : launch_rows<float>(x, dy, dst, B, H, W, Cin, Cout, splits, steps_per_split, s);
  if (err == cudaSuccess && splits > 1)
    err = reduce(static_cast<const float*>(workspace), static_cast<float*>(dw), Cin, Cout,
                 splits, s);
  return static_cast<int>(err);
}
