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
// What bounds it on the H100 depends on the shape, and so does the variant:
// the bf16 convs with Cin and Cout multiples of 64 (60 of the flagship
// UNet's 62) run on the tensor cores in conv3x3_wgrad_tc.cu (`tc`); this
// file holds the others.
//
// - `mma` (bf16, Cin and Cout multiples of 16, not taken by `tc`): a block
//   owns 128 input channels of one tap by 128 output channels, and a range
//   of K.  Its 8 warps each hold a 64 x 32 fp32 accumulator and run
//   `mma.sync` m16n8k16 bf16 x bf16 -> fp32.  A stage of 32 pixels of the
//   tap-shifted x and of dy lands in shared memory by `cp.async` (16-byte
//   copies; the halo and the ragged ends are zero-filled copies that read
//   nothing), four stages in flight; both tiles are pixel-major, so
//   `ldmatrix.trans` forms the A (x^T) and B (dy) fragments.  Rows padded
//   by 16 bytes keep ldmatrix free of bank conflicts.
// - `narrow_out` (Cout <= 16, any dtype: the UNet's final conv, 128 -> 1) and
//   `narrow_in` (Cin <= 16: the stem, 1 -> 128): a product with a handful of
//   rows or columns, so reading the large operand (x for narrow_out, dL/dy
//   for narrow_in) bounds it.  A thread owns one channel of that operand for
//   all nine taps and reads each of its pixels once, coalesced along the
//   channels; the small operand of the block's pixel tile, with a one-pixel
//   halo, sits in shared memory as fp32.  With one small channel the nine
//   taps' values come from a 3 x 3 window slid along the row in registers
//   (three shared-memory reads a pixel), and four row workers per block
//   share a tile's partial sum, added in worker order.
// - `simt` (fp32 FMA, fp32 I/O at the other shapes: the fp32 gates of the
//   kernels against their plain twins): a block owns 64 (tap, channel) rows
//   by 64 output channels and a range of K; 256 threads each accumulate a
//   4 x 4 tile, 16 pixels per stage through shared memory.
// - Determinism: no atomics.  A split of K writes its fp32 partial tile to
//   a workspace, and a second kernel adds the splits in a fixed order (see
//   WIDE_SPLITS); with one split the block writes dW itself.  Two launches
//   give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

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

// ---------------------------------------------------------------- narrow
constexpr int NNT = 128;          // channels of the large operand per block, one a thread

// Row workers of 128 threads per block: one small channel (NC == 1) leaves
// registers for four, and three such blocks on an SM (40 registers a
// thread); 16 small channels do not.
template <int NC>
struct Narrow {
  static constexpr int WORKERS = NC == 1 ? 4 : 1;
  static constexpr int THREADS = NNT * WORKERS;
  static constexpr int BLOCKS_PER_SM = NC == 1 ? 3 : 1;
};

// Split s of the narrow kernels: a tile of box_h rows x box_w columns of one
// image (source pixels of x for narrow_out, output pixels for narrow_in).
__device__ __forceinline__ void narrow_tile(int s, int H, int W, int box_h, int box_w, int& b,
                                            int& h0, int& w0) {
  const int tiles_w = (W + box_w - 1) / box_w;
  const int tiles_img = ((H + box_h - 1) / box_h) * tiles_w;
  b = s / tiles_img;
  const int t = s - b * tiles_img;
  h0 = (t / tiles_w) * box_h;
  w0 = (t % tiles_w) * box_w;
}

// The small operand's pixels of rows h0 - 1 .. h0 + box_h and columns
// w0 - 1 .. w0 + box_w into shared memory as fp32, [row][col][NC], zero off
// the image and past C channels.
template <typename T, int NC>
__device__ __forceinline__ void stage_halo(float* dst, const T* src, int b, int h0, int w0, int H,
                                           int W, int C, int box_h, int box_w) {
  const int sw = box_w + 2;
  const int n = (box_h + 2) * sw * NC;
  for (int e = threadIdx.y * NNT + threadIdx.x; e < n; e += Narrow<NC>::THREADS) {
    const int o = e % NC;
    const int c = (e / NC) % sw;
    const int r = e / (NC * sw);
    const int h = h0 - 1 + r, w = w0 - 1 + c;
    dst[e] = (o < C && h >= 0 && h < H && w >= 0 && w < W)
                 ? to_f(src[((static_cast<long long>(b) * H + h) * W + w) * C + o])
                 : 0.f;
  }
}

// The workers' partial sums acc[9][NC] added in worker order (the block's
// partial sum); worker 0 holds it on return.
template <int NC>
__device__ __forceinline__ void add_workers(float (&acc)[9][NC], float* red) {
  constexpr int WK = Narrow<NC>::WORKERS;
  if constexpr (WK > 1) {
    __syncthreads();                     // the halo tile is free: reuse it
    if (threadIdx.y > 0)
#pragma unroll
      for (int k = 0; k < 9 * NC; ++k)
        red[((threadIdx.y - 1) * 9 * NC + k) * NNT + threadIdx.x] = acc[k / NC][k % NC];
    __syncthreads();
    if (threadIdx.y == 0)
      for (int y = 1; y < WK; ++y)
#pragma unroll
        for (int k = 0; k < 9 * NC; ++k) acc[k / NC][k % NC] += red[((y - 1) * 9 * NC + k) * NNT + threadIdx.x];
  }
}

// Cout <= NC: grid x = block of 128 input channels, y = split; thread
// (x, y) owns input channel ci and the tile's rows y, y + WORKERS, ...
// Source pixel (hs, ws) of x feeds tap (di, dj) of output pixel
// (hs + 1 - di, ws + 1 - dj): halo row r + 2 - di, column c + 2 - dj.
template <typename T, int NC>
__global__ void __launch_bounds__(Narrow<NC>::THREADS, Narrow<NC>::BLOCKS_PER_SM)
wgrad_narrow_out_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ out,
                        int B, int H, int W, int Cin, int Cout, int box_h, int box_w) {
  extern __shared__ float halo[];
  int b, h0, w0;
  narrow_tile(blockIdx.y, H, W, box_h, box_w, b, h0, w0);
  stage_halo<T, NC>(halo, dy, b, h0, w0, H, W, Cout, box_h, box_w);
  __syncthreads();
  const int ci = blockIdx.x * NNT + threadIdx.x;
  const int sw = box_w + 2;
  const int cols = min(box_w, W - w0);
  float acc[9][NC];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int o = 0; o < NC; ++o) acc[k][o] = 0.f;
  if (ci < Cin) {
    for (int r = threadIdx.y; r < box_h && h0 + r < H; r += Narrow<NC>::WORKERS) {
      const T* xr = x + (static_cast<long long>(b) * H + h0 + r) * W * Cin + ci;
      const float* hr = halo + r * sw * NC;       // halo row r (tap di = 2)
      if constexpr (NC == 1) {
        // win[di][k]: halo rows r + 2 - di at columns c + k, slid along the row
        float win[3][3];
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          win[di][0] = hr[(2 - di) * sw];
          win[di][1] = hr[(2 - di) * sw + 1];
        }
#pragma unroll 4
        for (int c = 0; c < cols; ++c) {
          const float v = to_f(xr[static_cast<long long>(w0 + c) * Cin]);
#pragma unroll
          for (int di = 0; di < 3; ++di) win[di][2] = hr[(2 - di) * sw + c + 2];
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) acc[di * 3 + dj][0] = fmaf(v, win[di][2 - dj], acc[di * 3 + dj][0]);
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            win[di][0] = win[di][1];
            win[di][1] = win[di][2];
          }
        }
      } else {
        for (int c = 0; c < cols; ++c) {
          const float v = to_f(xr[static_cast<long long>(w0 + c) * Cin]);
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              const float* d = hr + ((2 - di) * sw + c + 2 - dj) * NC;
#pragma unroll
              for (int o = 0; o < NC; ++o) acc[di * 3 + dj][o] = fmaf(v, d[o], acc[di * 3 + dj][o]);
            }
        }
      }
    }
  }
  add_workers<NC>(acc, halo);
  if (threadIdx.y != 0 || ci >= Cin) return;
  float* dst = out + static_cast<long long>(blockIdx.y) * 9 * Cin * Cout;
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int o = 0; o < NC; ++o)
      if (o < Cout) dst[(static_cast<long long>(k) * Cin + ci) * Cout + o] = acc[k][o];
}

// Cin <= NC: grid x = block of 128 output channels, y = split; thread
// (x, y) owns output channel co and the tile's rows y, y + WORKERS, ...
// Output pixel (h, w) takes tap (di, dj) from x at (h + di - 1, w + dj - 1):
// halo row r + di, column c + dj.
template <typename T, int NC>
__global__ void __launch_bounds__(Narrow<NC>::THREADS, Narrow<NC>::BLOCKS_PER_SM)
wgrad_narrow_in_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ out,
                       int B, int H, int W, int Cin, int Cout, int box_h, int box_w) {
  extern __shared__ float halo[];
  int b, h0, w0;
  narrow_tile(blockIdx.y, H, W, box_h, box_w, b, h0, w0);
  stage_halo<T, NC>(halo, x, b, h0, w0, H, W, Cin, box_h, box_w);
  __syncthreads();
  const int co = blockIdx.x * NNT + threadIdx.x;
  const int sw = box_w + 2;
  const int cols = min(box_w, W - w0);
  float acc[9][NC];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[k][i] = 0.f;
  if (co < Cout) {
    for (int r = threadIdx.y; r < box_h && h0 + r < H; r += Narrow<NC>::WORKERS) {
      const T* gr = dy + (static_cast<long long>(b) * H + h0 + r) * W * Cout + co;
      const float* hr = halo + r * sw * NC;       // halo row r (tap di = 0)
      if constexpr (NC == 1) {
        // win[di][k]: halo rows r + di at columns c + k, slid along the row
        float win[3][3];
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          win[di][0] = hr[di * sw];
          win[di][1] = hr[di * sw + 1];
        }
#pragma unroll 4
        for (int c = 0; c < cols; ++c) {
          const float g = to_f(gr[static_cast<long long>(w0 + c) * Cout]);
#pragma unroll
          for (int di = 0; di < 3; ++di) win[di][2] = hr[di * sw + c + 2];
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) acc[di * 3 + dj][0] = fmaf(win[di][dj], g, acc[di * 3 + dj][0]);
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            win[di][0] = win[di][1];
            win[di][1] = win[di][2];
          }
        }
      } else {
        for (int c = 0; c < cols; ++c) {
          const float g = to_f(gr[static_cast<long long>(w0 + c) * Cout]);
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              const float* xv = hr + (di * sw + c + dj) * NC;
#pragma unroll
              for (int i = 0; i < NC; ++i) acc[di * 3 + dj][i] = fmaf(xv[i], g, acc[di * 3 + dj][i]);
            }
        }
      }
    }
  }
  add_workers<NC>(acc, halo);
  if (threadIdx.y != 0 || co >= Cout) return;
  float* dst = out + static_cast<long long>(blockIdx.y) * 9 * Cin * Cout;
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < Cin) dst[(static_cast<long long>(k) * Cin + i) * Cout + co] = acc[k][i];
}

// ---------------------------------------------------------------- reduce
// out[i] = the splits' partials of element i, ws[k][i], added in a fixed
// order: the same bits every time.  Up to WIDE_SPLITS splits a thread adds
// them in split order, V values (one float4 or one float) at a time.  More
// (the narrow kernels' hundreds of tiles over a few thousand values): a
// block takes 32 values, its warp q adds splits q, q + 8, q + 16, ... in
// order, and the 8 warps' sums are added in warp order.  Each is launched
// as a programmatic dependent of the kernel that wrote `ws`, and waits for
// that kernel's end.
constexpr int WIDE_SPLITS = 64;

template <int V>
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, long long n, int splits) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long nv = n / V;
  const Vec* w = reinterpret_cast<const Vec*>(ws);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < nv; i += gridDim.x * 256LL) {
    Vec s = w[i];
    for (int k = 1; k < splits; ++k) {
      const Vec p = w[k * nv + i];
      if constexpr (V == 4) {
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
      } else {
        s += p;
      }
    }
    reinterpret_cast<Vec*>(out)[i] = s;
  }
}

__global__ void __launch_bounds__(256)
wgrad_reduce_wide_kernel(const float* __restrict__ ws, float* __restrict__ out, long long n,
                         int splits) {
  __shared__ float part[8][32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x % 32, q = threadIdx.x / 32;
  const long long i = blockIdx.x * 32LL + lane;
  float s = 0.f;
  if (i < n)
    for (int k = q; k < splits; k += 8) s += ws[k * n + i];
  part[q][lane] = s;
  __syncthreads();
  if (q == 0 && i < n) {
    float t = part[0][lane];
    for (int r = 1; r < 8; ++r) t += part[r][lane];
    out[i] = t;
  }
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

template <typename T, int NC>
cudaError_t launch_narrow(bool out_side, const void* x, const void* dy, float* dst, int B, int H,
                          int W, int Cin, int Cout, int box_h, int box_w, int splits,
                          cudaStream_t s) {
  constexpr int WK = Narrow<NC>::WORKERS;
  const int halo = (box_h + 2) * (box_w + 2) * NC;
  const int red = (WK - 1) * 9 * NC * NNT;
  const size_t smem = 4 * static_cast<size_t>(halo > red ? halo : red);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int wide = out_side ? Cin : Cout;
  const dim3 grid(static_cast<unsigned>((wide + NNT - 1) / NNT), static_cast<unsigned>(splits));
  const dim3 block(NNT, WK);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  if (out_side)
    wgrad_narrow_out_kernel<T, NC><<<grid, block, smem, s>>>(xt, dt, dst, B, H, W, Cin, Cout, box_h, box_w);
  else
    wgrad_narrow_in_kernel<T, NC><<<grid, block, smem, s>>>(xt, dt, dst, B, H, W, Cin, Cout, box_h, box_w);
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

// dw = the sum over splits, in order, of workspace (splits, n) fp32, all on
// the device; launches on `stream`, returns cudaGetLastError().
extern "C" int conv3x3_wgrad_reduce(const void* workspace, void* dw, long long n, int splits,
                                    void* stream) {
  if (n < 1 || splits < 1 || workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const float* ws = static_cast<const float*>(workspace);
  float* out = static_cast<float*>(dw);
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(workspace) | reinterpret_cast<uintptr_t>(dw)) % 16 == 0;
  const long long items = vec ? n / 4 : n;
  const bool wide = splits > WIDE_SPLITS;
  const long long blocks = wide ? (n + 31) / 32 : std::min((items + 255) / 256, 4096LL);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  const cudaError_t err =
      wide  ? cudaLaunchKernelEx(&cfg, wgrad_reduce_wide_kernel, ws, out, n, splits)
      : vec ? cudaLaunchKernelEx(&cfg, wgrad_reduce_kernel<4>, ws, out, n, splits)
            : cudaLaunchKernelEx(&cfg, wgrad_reduce_kernel<1>, ws, out, n, splits);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

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
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return conv3x3_wgrad_reduce(workspace, dw, 9LL * Cin * Cout, splits, stream);
}

// The simt variant: x and dy in fp32 or bf16 (is_bf16), any channel counts,
// 64 x 64 tiles; other arguments as for conv3x3_wgrad_mma.
extern "C" int conv3x3_wgrad_simt(const void* x, const void* dy, void* dw, void* workspace,
                                  int B, int H, int W, int Cin, int Cout, int is_bf16,
                                  int splits, int steps_per_split, void* stream) {
  if (Cin < 1 || Cout < 1 || bad_split(B, H, W, splits, steps_per_split, SBK) ||
      (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? workspace : dw);
  const cudaError_t err =
      is_bf16 ? launch_simt<bf16, 64, 64>(x, dy, dst, B, H, W, Cin, Cout, splits, steps_per_split, s)
              : launch_simt<float, 64, 64>(x, dy, dst, B, H, W, Cin, Cout, splits, steps_per_split, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return conv3x3_wgrad_reduce(workspace, dw, 9LL * Cin * Cout, splits, stream);
}

// The narrow variants: x (B,H,W,Cin) and dy (B,H,W,Cout) in fp32 or bf16
// (is_bf16); `out_side` 1 for Cout <= 16 (narrow_out: a thread per input
// channel), 0 for Cin <= 16 (narrow_in: a thread per output channel).  A
// split is a tile of box_h x box_w pixels of one image, in (image, tile row,
// tile column) order: splits = B ceil(H / box_h) ceil(W / box_w).  dw and
// workspace (splits, 9 Cin Cout) as for conv3x3_wgrad_mma.
extern "C" int conv3x3_wgrad_narrow(const void* x, const void* dy, void* dw, void* workspace,
                                    int B, int H, int W, int Cin, int Cout, int is_bf16,
                                    int out_side, int box_h, int box_w, int splits, void* stream) {
  const int small = out_side ? Cout : Cin;
  const long long tiles =
      static_cast<long long>(B) * ((H + box_h - 1) / box_h) * ((W + box_w - 1) / box_w);
  if (Cin < 1 || Cout < 1 || small > 16 || box_h < 1 || box_w < 1 || B < 1 || H < 1 || W < 1 ||
      tiles != splits || splits > 65535 || (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? workspace : dw);
  const bool os = out_side != 0;
  cudaError_t err;
  if (small == 1)
    err = is_bf16 ? launch_narrow<bf16, 1>(os, x, dy, dst, B, H, W, Cin, Cout, box_h, box_w, splits, s)
                  : launch_narrow<float, 1>(os, x, dy, dst, B, H, W, Cin, Cout, box_h, box_w, splits, s);
  else
    err = is_bf16 ? launch_narrow<bf16, 16>(os, x, dy, dst, B, H, W, Cin, Cout, box_h, box_w, splits, s)
                  : launch_narrow<float, 16>(os, x, dy, dst, B, H, W, Cin, Cout, box_h, box_w, splits, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return conv3x3_wgrad_reduce(workspace, dw, 9LL * Cin * Cout, splits, stream);
}
