// Blockwise (flash) self-attention with the ADM legacy scaling:
// out = softmax((q * d^-1/4) (k * d^-1/4)^T) v, softmax in fp32.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` of
// diffusion_models_dev_project_tpu/ops/attention.py (online softmax over
// key blocks, padded keys masked to -1e30, any T, any d).
//
// What bounds it on the H100: on the UNet's path q, k, v are (8, 256, 64) and
// (8, 64, 64) per image; that is ~0.27 GFLOP over ~1 MB, a few microseconds
// at either peak, so the kernel is bound by launch latency and by how few
// blocks the small grid gives (32 and 8 blocks over 132 SMs).
//
// Design: one block per (batch*head, 64 query rows), 256 threads, 4 threads
// per query row.  A thread keeps its quarter of the row's q (pre-scaled) and
// of the fp32 accumulator in registers, channels part, part+4, part+8, ...
// Key and value tiles of 32 rows stream through shared memory (converted to
// fp32, k pre-scaled); each score is a 4-lane partial dot product summed with
// two shuffles, the running max and sum are updated once per tile, and
// `acc / l` is written at the end in the input dtype.  Keys past T score
// -1e30, so exp() gives exactly 0 without inf - inf.  d up to 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int TPR = 4;      // threads per query row
constexpr int BKV = 32;     // keys per shared-memory tile
constexpr int NT = BQ * TPR;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// DMAX: the largest head width this instantiation takes (64 or 128)
template <typename T, int DMAX>
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Tn, int D, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((Tn + BQ - 1) / BQ), static_cast<unsigned>(BH));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (D <= 64)
    attention_kernel<T, 64><<<grid, NT, 0, stream>>>(qp, kp, vp, op, Tn, D, scale);
  else
    attention_kernel<T, 128><<<grid, NT, 0, stream>>>(qp, kp, vp, op, Tn, D, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (BH, T, D) contiguous on the device, fp32 or bf16 (is_bf16);
// D <= 128; `scale` = D^-1/4 applied to q and to k.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 void* out, int BH, int Tn, int D, float scale,
                                 int is_bf16, void* stream) {
  if (D < 1 || D > 128 || Tn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, BH, Tn, D, scale, s)
              : launch<float>(q, k, v, out, BH, Tn, D, scale, s);
  return static_cast<int>(err);
}
