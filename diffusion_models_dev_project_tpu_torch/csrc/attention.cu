// Blockwise (flash) self-attention with the ADM legacy scaling:
// out = softmax((q * d^-1/4) (k * d^-1/4)^T) v, softmax in fp32.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` of
// diffusion_models_dev_project_tpu/ops/attention.py (online softmax over
// key blocks, padded keys masked to -1e30, any T, any d).
//
// This is the `simt` variant (ops/attention.py::plan): fp32 I/O, and bf16
// with d > 128.  bf16 with d <= 128, the UNet's path, goes to the
// tensor-core kernel of csrc/attention_mma.cu.
//
// What bounds it on the H100: at the UNet's shapes, (8, 256, 64) and
// (8, 64, 64) per image, ~0.27 GFLOP over ~1 MB, a few microseconds at either
// peak; the kernel is bound by its fp32 CUDA-core dot products, by launch
// latency and by how few blocks the small grid gives (32 and 8 over 132 SMs).
//
// Design: one block per (batch*head, 64 query rows), 256 threads, 4 threads
// per query row.  A thread keeps its quarter of the row's q (pre-scaled) and
// of the fp32 accumulator in registers, channels part, part+4, part+8, ...
// Key and value tiles of BKV rows stream through shared memory (converted to
// fp32, k pre-scaled); each score is a 4-lane partial dot product summed with
// two shuffles, the running max and sum are updated once per tile, and
// `acc / l` is written at the end in the input dtype.  Keys past T score
// -1e30, so exp() gives exactly 0 without inf - inf.  d up to 256: tiles of
// 32 keys up to d = 128, of 16 keys above, so that q and the accumulator
// stay at 64 registers each.
//
// Wider heads (d > 256, off every shipped path; the JAX kernel takes any d)
// run `attention_wide_kernel`: the head streams in column chunks of DC = 256.
// A third grid axis splits the output columns into those chunks; each block
// keeps the accumulator of its own chunk only, and recomputes the rows'
// logits, max and sum over the full d: per key tile, the K chunks pass
// through shared memory one after another and each thread adds its q
// channels of the chunk (read from global memory, not held) to the 4-lane
// partial dot products.  Only the V chunk of the block's columns is staged.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int TPR = 4;      // threads per query row
constexpr int NT = BQ * TPR;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// DMAX: the largest head width this instantiation takes (64, 128 or 256);
// BKV: keys per shared-memory tile
template <typename T, int DMAX, int BKV>
__global__ void __launch_bounds__(NT)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Tn, int D,
                 float scale) {
  constexpr int CPT = DMAX / TPR;           // channels per thread
  __shared__ float Ks[BKV][DMAX];
  __shared__ float Vs[BKV][DMAX];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qi = blockIdx.x * BQ + row;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;

  float qr[CPT], acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = part + TPR * i;
    qr[i] = (qi < Tn && c < D)
                ? load_f(q + base + static_cast<long long>(qi) * D + c) * scale
                : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = 0; j0 < Tn; j0 += BKV) {
    __syncthreads();   // the previous tile is no longer read
    for (int e = tid; e < BKV * DMAX; e += NT) {
      const int j = e / DMAX;
      const int c = e - j * DMAX;
      const int kj = j0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Tn && c < D) {
        const long long off = base + static_cast<long long>(kj) * D + c;
        kv = load_f(k + off) * scale;
        vv = load_f(v + off);
      }
      Ks[j][c] = kv;
      Vs[j][c] = vv;
    }
    __syncthreads();

    float s[BKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) p = fmaf(qr[i], Ks[j][part + TPR * i], p);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (j0 + j >= Tn) p = -1e30f;
      s[j] = p;
      tile_max = fmaxf(tile_max, p);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);      // 0 on the first tile
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = expf(s[j] - m_new);
      tile_sum += s[j];
    }
    l = l * alpha + tile_sum;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < BKV; ++j) a = fmaf(s[j], Vs[j][part + TPR * i], a);
      acc[i] = a;
    }
    m = m_new;
  }

  if (qi < Tn) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = part + TPR * i;
      if (c < D) store_f(out + base + static_cast<long long>(qi) * D + c, acc[i] * inv);
    }
  }
}

// d > 256: one block per (batch*head, 64 query rows, DC output columns)
template <typename T, int BKV>
__global__ void __launch_bounds__(NT)
attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int Tn, int D,
                      float scale) {
  constexpr int DC = 256;                   // columns per chunk
  constexpr int CPT = DC / TPR;             // channels per thread of a chunk
  __shared__ float Ks[BKV][DC];
  __shared__ float Vs[BKV][DC];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qi = blockIdx.x * BQ + row;
  const int cz = blockIdx.z * DC;           // this block's output columns
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long roff = base + static_cast<long long>(qi) * D;

  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = 0; j0 < Tn; j0 += BKV) {
    float s[BKV];
#pragma unroll
    for (int j = 0; j < BKV; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();   // the previous chunk is no longer read
      for (int e = tid; e < BKV * DC; e += NT) {
        const int j = e / DC;
        const int c = e - j * DC;
        const int kj = j0 + j;
        Ks[j][c] = (kj < Tn && c0 + c < D)
                       ? load_f(k + base + static_cast<long long>(kj) * D + c0 + c) * scale
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < CPT; ++i) {
        const int c = c0 + part + TPR * i;
        const float qv = (qi < Tn && c < D) ? load_f(q + roff + c) * scale : 0.f;
#pragma unroll
        for (int j = 0; j < BKV; ++j) s[j] = fmaf(qv, Ks[j][part + TPR * i], s[j]);
      }
    }
    for (int e = tid; e < BKV * DC; e += NT) {   // Vs was last read before the chunks' barriers
      const int j = e / DC;
      const int c = e - j * DC;
      const int kj = j0 + j;
      Vs[j][c] = (kj < Tn && cz + c < D)
                     ? load_f(v + base + static_cast<long long>(kj) * D + cz + c)
                     : 0.f;
    }
    __syncthreads();

    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float p = s[j];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (j0 + j >= Tn) p = -1e30f;
      s[j] = p;
      tile_max = fmaxf(tile_max, p);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);      // 0 on the first tile
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = expf(s[j] - m_new);
      tile_sum += s[j];
    }
    l = l * alpha + tile_sum;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < BKV; ++j) a = fmaf(s[j], Vs[j][part + TPR * i], a);
      acc[i] = a;
    }
    m = m_new;
  }

  if (qi < Tn) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = cz + part + TPR * i;
      if (c < D) store_f(out + roff + c, acc[i] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Tn, int D, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((Tn + BQ - 1) / BQ), static_cast<unsigned>(BH));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (D <= 64)
    attention_kernel<T, 64, 32><<<grid, NT, 0, stream>>>(qp, kp, vp, op, Tn, D, scale);
  else if (D <= 128)
    attention_kernel<T, 128, 32><<<grid, NT, 0, stream>>>(qp, kp, vp, op, Tn, D, scale);
  else if (D <= 256)
    attention_kernel<T, 256, 16><<<grid, NT, 0, stream>>>(qp, kp, vp, op, Tn, D, scale);
  else {
    const dim3 wide(grid.x, grid.y, static_cast<unsigned>((D + 255) / 256));
    attention_wide_kernel<T, 16><<<wide, NT, 0, stream>>>(qp, kp, vp, op, Tn, D, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (BH, T, D) contiguous on the device, fp32 or bf16 (is_bf16);
// any D >= 1 (past 256 in column chunks); `scale` = D^-1/4 applied to q and
// to k.  Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 void* out, int BH, int Tn, int D, float scale,
                                 int is_bf16, void* stream) {
  if (D < 1 || D > 65535 * 256 || Tn < 1 || BH < 1 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, BH, Tn, D, scale, s)
              : launch<float>(q, k, v, out, BH, Tn, D, scale, s);
  return static_cast<int>(err);
}
