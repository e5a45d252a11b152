// Backward of the ADM attention out = softmax(S) v, S = (q * s)(k * s)^T,
// s = d^-1/4: dq, dk and dv from q, k, v, the forward's output o and dout,
// the softmax and every accumulation in fp32.
//
// The JAX package differentiates this function with XLA (autodiff of its
// einsum attention, models/unet.py:531-539, ops/attention.py:30-37); its
// Pallas kernel `_flash_kernel` / `flash_attention`
// (diffusion_models_dev_project_tpu/ops/attention.py) has no backward.  The
// port runs every attention through its own forward kernels, so the
// gradient needs a kernel of its own too.
//
// With P = softmax(S), dP = dout v^T, D = rowsum(dout * o) and
// dS = P * (dP - D):  dq = s^2 dS k,  dk = s^2 dS^T q,  dv = P^T dout.
//
// What bounds it on the H100: at the UNet's shapes, (8, 256, 64) and
// (8, 64, 64) per image, ~0.35 GFLOP per call over ~2 MB: microseconds at
// either peak.  This first design is bound by its fp32 CUDA-core dot
// products, their shuffle reductions and its small grids; it is simple and
// deterministic, and making it fast is later work (ROADMAP.md queue 2).
//
// Design: two kernels, no atomics, so every launch gives the same bits.
// - Query pass, one block of 128 threads per (batch*head, ROWS query rows):
//   each query row is held by TPR threads, CPT channels each, in registers
//   (q scaled by s, dout, the dq accumulator).  A first stream over the key
//   tiles recomputes the row's max and sum of exp, online over groups of 4
//   keys; then D = rowsum(dout * o); a second stream over key and value
//   tiles forms P, dP and dS for 4 keys at a time (4 independent chains of
//   dot products and shuffle reductions, to hide their latency) and
//   accumulates dq.  It writes lse = m + log(l) and D per row to a
//   workspace.
// - Key pass, one block per (batch*head, ROWS key rows): each key row holds
//   k (scaled), v and the dk, dv accumulators; it streams tiles of q
//   (scaled), dout, lse and D, recomputes P and dS for 4 queries at a time
//   and accumulates dv = sum P dout and dk = sum dS q.
// Tiles are staged in shared memory as fp32, zero-padded to DMAX channels
// and to whole groups of 4 rows; rows past T get P = 0.  Loop bounds are the
// same for the whole block, so the shuffles stay converged.
//
// Wider heads (d > 256, off every shipped path) run the `_wide` pair: the
// same two passes with a third grid axis over column chunks of DC = 256.
// A block accumulates dq (dk and dv) for its own chunk of columns only; the
// logits and dP = dout v^T need the full d, so per tile of 16 keys (queries) the tile's chunks pass through
// shared memory one after another while each thread adds its own row's
// channels of the chunk, read from global memory, to 16 partial dot
// products each; the tile's rows of the block's own chunk are staged last
// for the accumulation.  Every chunk's block recomputes lse and D over the
// full d; the first chunk's writes them for the key pass.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 128;     // threads per block
constexpr int G = 4;        // keys (or queries) per group of independent chains

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// sum over the TPR neighbouring lanes that hold one row
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// stage rows r0 .. r0+BT-1 of a (T, D) matrix (times `mul`) into S[BT][DMAX]
template <typename T, int DMAX, int BT>
__device__ __forceinline__ void stage(float (*S)[DMAX], const T* __restrict__ src,
                                      long long base, int r0, int Tn, int D, float mul) {
  for (int e = threadIdx.x; e < BT * DMAX; e += NT) {
    const int j = e / DMAX;
    const int c = e - j * DMAX;
    const int r = r0 + j;
    S[j][c] = (r < Tn && c < D) ? load_f(src + base + static_cast<long long>(r) * D + c) * mul
                                : 0.f;
  }
}

template <typename T, int DMAX, int BKV, int CPT>
__global__ void __launch_bounds__(NT)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ lse_out, float* __restrict__ delta_out,
                        int Tn, int D, float scale) {
  constexpr int TPR = DMAX / CPT;
  constexpr int ROWS = NT / TPR;
  __shared__ float Ks[BKV][DMAX];
  __shared__ float Vs[BKV][DMAX];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int qi = blockIdx.x * ROWS + tid / TPR;
  const bool live = qi < Tn;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long roff = base + static_cast<long long>(qi) * D;

  float qr[CPT], gr[CPT], acc[CPT];
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = part + TPR * i;
    const bool in = live && c < D;
    qr[i] = in ? load_f(q + roff + c) * scale : 0.f;
    gr[i] = in ? load_f(dout + roff + c) : 0.f;
    delta += in ? gr[i] * load_f(o + roff + c) : 0.f;
    acc[i] = 0.f;
  }
  delta = row_sum<TPR>(delta);

  // pass 1: the row's max and sum of exp, online over groups of G keys
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < Tn; j0 += BKV) {
    __syncthreads();
    stage<T, DMAX, BKV>(Ks, k, base, j0, Tn, D, scale);
    __syncthreads();
    const int jn = min(BKV, Tn - j0);
    for (int j = 0; j < jn; j += G) {
      float s[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int i = 0; i < CPT; ++i) s[u] = fmaf(qr[i], Ks[j + u][part + TPR * i], s[u]);
      }
      float gm = -INFINITY;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        s[u] = row_sum<TPR>(s[u]);
        if (j + u >= jn) s[u] = -INFINITY;     // past T: exp() gives 0
        gm = fmaxf(gm, s[u]);
      }
      const float m_new = fmaxf(m, gm);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < G; ++u) sum += expf(s[u] - m_new);
      l = l * expf(m - m_new) + sum;
      m = m_new;
    }
  }
  const float lse = m + logf(l);

  // pass 2: P, dP and dS per key; dq += dS * (k * s)
  for (int j0 = 0; j0 < Tn; j0 += BKV) {
    __syncthreads();
    stage<T, DMAX, BKV>(Ks, k, base, j0, Tn, D, scale);
    stage<T, DMAX, BKV>(Vs, v, base, j0, Tn, D, 1.f);
    __syncthreads();
    const int jn = min(BKV, Tn - j0);
    for (int j = 0; j < jn; j += G) {
      float s[G], dp[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        s[u] = 0.f;
        dp[u] = 0.f;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          s[u] = fmaf(qr[i], Ks[j + u][part + TPR * i], s[u]);
          dp[u] = fmaf(gr[i], Vs[j + u][part + TPR * i], dp[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        s[u] = row_sum<TPR>(s[u]);
        dp[u] = row_sum<TPR>(dp[u]);
        s[u] = (j + u < jn) ? expf(s[u] - lse) * (dp[u] - delta) : 0.f;     // dS
      }
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        float a = acc[i];
#pragma unroll
        for (int u = 0; u < G; ++u) a = fmaf(s[u], Ks[j + u][part + TPR * i], a);
        acc[i] = a;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = part + TPR * i;
      if (c < D) store_f(dq + roff + c, acc[i] * scale);
    }
    if (part == 0) {
      const long long r = static_cast<long long>(blockIdx.y) * Tn + qi;
      lse_out[r] = lse;
      delta_out[r] = delta;
    }
  }
}

template <typename T, int DMAX, int BKV, int CPT>
__global__ void __launch_bounds__(NT)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Tn, int D, float scale) {
  constexpr int TPR = DMAX / CPT;
  constexpr int ROWS = NT / TPR;
  __shared__ float Qs[BKV][DMAX];
  __shared__ float Gs[BKV][DMAX];
  __shared__ float Ls[BKV];
  __shared__ float Ds[BKV];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int kj = blockIdx.x * ROWS + tid / TPR;
  const bool live = kj < Tn;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long roff = base + static_cast<long long>(kj) * D;
  const long long sbase = static_cast<long long>(blockIdx.y) * Tn;

  float kr[CPT], vr[CPT], dka[CPT], dva[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = part + TPR * i;
    const bool in = live && c < D;
    kr[i] = in ? load_f(k + roff + c) * scale : 0.f;
    vr[i] = in ? load_f(v + roff + c) : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  for (int i0 = 0; i0 < Tn; i0 += BKV) {
    __syncthreads();
    stage<T, DMAX, BKV>(Qs, q, base, i0, Tn, D, scale);
    stage<T, DMAX, BKV>(Gs, dout, base, i0, Tn, D, 1.f);
    for (int e = tid; e < BKV; e += NT) {
      const bool in = i0 + e < Tn;
      Ls[e] = in ? lse[sbase + i0 + e] : 0.f;
      Ds[e] = in ? delta[sbase + i0 + e] : 0.f;
    }
    __syncthreads();
    const int rn = min(BKV, Tn - i0);
    for (int r = 0; r < rn; r += G) {
      float p[G], ds[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          s = fmaf(kr[i], Qs[r + u][part + TPR * i], s);
          dp = fmaf(vr[i], Gs[r + u][part + TPR * i], dp);
        }
        p[u] = s;
        ds[u] = dp;
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float s = row_sum<TPR>(p[u]);
        const float dp = row_sum<TPR>(ds[u]);
        p[u] = (r + u < rn) ? expf(s - Ls[r + u]) : 0.f;     // queries past T: P = 0
        ds[u] = p[u] * (dp - Ds[r + u]);
      }
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        float a = dva[i], b = dka[i];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          a = fmaf(p[u], Gs[r + u][part + TPR * i], a);
          b = fmaf(ds[u], Qs[r + u][part + TPR * i], b);
        }
        dva[i] = a;
        dka[i] = b;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = part + TPR * i;
      if (c < D) {
        store_f(dk + roff + c, dka[i] * scale);
        store_f(dv + roff + c, dva[i]);
      }
    }
  }
}

// ---- d > 256: column chunks of DC on grid axis z
constexpr int DC = 256;     // columns per chunk
constexpr int WBT = 16;     // keys (queries) per tile
constexpr int WCPT = 16;    // channels per thread of a chunk
constexpr int WTPR = DC / WCPT;
constexpr int WROWS = NT / WTPR;

// stage columns c0 .. c0+DC-1 of rows r0 .. r0+WBT-1 of a (T, D) matrix
// (times `mul`) into S[WBT][DC]
template <typename T>
__device__ __forceinline__ void stage_chunk(float (*S)[DC], const T* __restrict__ src,
                                            long long base, int r0, int c0, int Tn, int D,
                                            float mul) {
  for (int e = threadIdx.x; e < WBT * DC; e += NT) {
    const int j = e / DC;
    const int c = e - j * DC;
    const int r = r0 + j;
    S[j][c] = (r < Tn && c0 + c < D)
                  ? load_f(src + base + static_cast<long long>(r) * D + c0 + c) * mul
                  : 0.f;
  }
}

// acc[j] += sum over this thread's channels of chunk c0 of a[row] * S[j]
// (`a` read from global memory at `roff`, times `mul`; 0 past D or T)
template <typename T>
__device__ __forceinline__ void dot_chunk(float* acc, const float (*S)[DC],
                                          const T* __restrict__ a, long long roff, bool live,
                                          int c0, int part, int D, float mul) {
#pragma unroll 4
  for (int i = 0; i < WCPT; ++i) {
    const int c = c0 + part + WTPR * i;
    const float x = (live && c < D) ? load_f(a + roff + c) * mul : 0.f;
#pragma unroll
    for (int j = 0; j < WBT; ++j) acc[j] = fmaf(x, S[j][part + WTPR * i], acc[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
attention_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ o,
                             const T* __restrict__ dout, T* __restrict__ dq,
                             float* __restrict__ lse_out, float* __restrict__ delta_out,
                             int Tn, int D, float scale) {
  __shared__ float Ks[WBT][DC];
  __shared__ float Vs[WBT][DC];

  const int tid = threadIdx.x;
  const int part = tid % WTPR;
  const int qi = blockIdx.x * WROWS + tid / WTPR;
  const bool live = qi < Tn;
  const int cz = blockIdx.z * DC;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long roff = base + static_cast<long long>(qi) * D;

  float delta = 0.f;
  for (int c = part; c < D; c += WTPR)
    if (live) delta += load_f(dout + roff + c) * load_f(o + roff + c);
  delta = row_sum<WTPR>(delta);

  // pass 1: the row's max and sum of exp over the full d, a tile at a time
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < Tn; j0 += WBT) {
    float s[WBT];
#pragma unroll
    for (int j = 0; j < WBT; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();
      stage_chunk<T>(Ks, k, base, j0, c0, Tn, D, scale);
      __syncthreads();
      dot_chunk<T>(s, Ks, q, roff, live, c0, part, D, scale);
    }
    float tm = -INFINITY;
#pragma unroll
    for (int j = 0; j < WBT; ++j) {
      s[j] = row_sum<WTPR>(s[j]);
      if (j0 + j >= Tn) s[j] = -INFINITY;     // past T: exp() gives 0
      tm = fmaxf(tm, s[j]);
    }
    const float m_new = fmaxf(m, tm);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < WBT; ++j) sum += expf(s[j] - m_new);
    l = l * expf(m - m_new) + sum;
    m = m_new;
  }
  const float lse = m + logf(l);

  // pass 2: dS per key from the full d; dq of this chunk += dS * (k * s)
  float acc[WCPT];
#pragma unroll
  for (int i = 0; i < WCPT; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < Tn; j0 += WBT) {
    float s[WBT], dp[WBT];
#pragma unroll
    for (int j = 0; j < WBT; ++j) s[j] = dp[j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();
      stage_chunk<T>(Ks, k, base, j0, c0, Tn, D, scale);
      stage_chunk<T>(Vs, v, base, j0, c0, Tn, D, 1.f);
      __syncthreads();
      dot_chunk<T>(s, Ks, q, roff, live, c0, part, D, scale);
      dot_chunk<T>(dp, Vs, dout, roff, live, c0, part, D, 1.f);
    }
#pragma unroll
    for (int j = 0; j < WBT; ++j) {
      const float sj = row_sum<WTPR>(s[j]);
      const float dpj = row_sum<WTPR>(dp[j]);
      s[j] = (j0 + j < Tn) ? expf(sj - lse) * (dpj - delta) : 0.f;     // dS
    }
    __syncthreads();
    stage_chunk<T>(Ks, k, base, j0, cz, Tn, D, scale);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WCPT; ++i) {
      float a = acc[i];
#pragma unroll
      for (int j = 0; j < WBT; ++j) a = fmaf(s[j], Ks[j][part + WTPR * i], a);
      acc[i] = a;
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < WCPT; ++i) {
      const int c = cz + part + WTPR * i;
      if (c < D) store_f(dq + roff + c, acc[i] * scale);
    }
    if (part == 0 && blockIdx.z == 0) {
      const long long r = static_cast<long long>(blockIdx.y) * Tn + qi;
      lse_out[r] = lse;
      delta_out[r] = delta;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
attention_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int Tn, int D,
                               float scale) {
  __shared__ float Qs[WBT][DC];
  __shared__ float Gs[WBT][DC];
  __shared__ float Ls[WBT];
  __shared__ float Ds[WBT];

  const int tid = threadIdx.x;
  const int part = tid % WTPR;
  const int kj = blockIdx.x * WROWS + tid / WTPR;
  const bool live = kj < Tn;
  const int cz = blockIdx.z * DC;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * D;
  const long long roff = base + static_cast<long long>(kj) * D;
  const long long sbase = static_cast<long long>(blockIdx.y) * Tn;

  float dka[WCPT], dva[WCPT];
#pragma unroll
  for (int i = 0; i < WCPT; ++i) dka[i] = dva[i] = 0.f;

  for (int i0 = 0; i0 < Tn; i0 += WBT) {
    float p[WBT], ds[WBT];
#pragma unroll
    for (int r = 0; r < WBT; ++r) p[r] = ds[r] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();
      stage_chunk<T>(Qs, q, base, i0, c0, Tn, D, scale);
      stage_chunk<T>(Gs, dout, base, i0, c0, Tn, D, 1.f);
      __syncthreads();
      dot_chunk<T>(p, Qs, k, roff, live, c0, part, D, scale);
      dot_chunk<T>(ds, Gs, v, roff, live, c0, part, D, 1.f);
    }
    __syncthreads();
    stage_chunk<T>(Qs, q, base, i0, cz, Tn, D, scale);
    stage_chunk<T>(Gs, dout, base, i0, cz, Tn, D, 1.f);
    for (int e = tid; e < WBT; e += NT) {
      const bool in = i0 + e < Tn;
      Ls[e] = in ? lse[sbase + i0 + e] : 0.f;
      Ds[e] = in ? delta[sbase + i0 + e] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < WBT; ++r) {
      const float s = row_sum<WTPR>(p[r]);
      const float dp = row_sum<WTPR>(ds[r]);
      p[r] = (i0 + r < Tn) ? expf(s - Ls[r]) : 0.f;     // queries past T: P = 0
      ds[r] = p[r] * (dp - Ds[r]);
    }
#pragma unroll
    for (int i = 0; i < WCPT; ++i) {
      float a = dva[i], b = dka[i];
#pragma unroll
      for (int r = 0; r < WBT; ++r) {
        a = fmaf(p[r], Gs[r][part + WTPR * i], a);
        b = fmaf(ds[r], Qs[r][part + WTPR * i], b);
      }
      dva[i] = a;
      dka[i] = b;
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < WCPT; ++i) {
      const int c = cz + part + WTPR * i;
      if (c < D) {
        store_f(dk + roff + c, dka[i] * scale);
        store_f(dv + roff + c, dva[i]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* dq, void* dk, void* dv, float* ws, int BH,
                        int Tn, int D, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((Tn + WROWS - 1) / WROWS), static_cast<unsigned>(BH),
                  static_cast<unsigned>((D + DC - 1) / DC));
  float* lse = ws;
  float* delta = ws + static_cast<long long>(BH) * Tn;
  attention_bwd_dq_wide_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta,
      Tn, D, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_wide_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Tn, D,
      scale);
  return cudaGetLastError();
}

template <typename T, int DMAX, int BKV, int CPT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* ws, int BH,
                   int Tn, int D, float scale, cudaStream_t stream) {
  constexpr int ROWS = NT / (DMAX / CPT);
  const dim3 grid(static_cast<unsigned>((Tn + ROWS - 1) / ROWS), static_cast<unsigned>(BH));
  float* lse = ws;
  float* delta = ws + static_cast<long long>(BH) * Tn;
  attention_bwd_dq_kernel<T, DMAX, BKV, CPT><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta,
      Tn, D, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<T, DMAX, BKV, CPT><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Tn, D,
      scale);
  return cudaGetLastError();
}

// head width -> (DMAX, keys per tile, channels per thread): 8 threads a row
// up to d = 128, 16 at d = 256 and in the column chunks past it
// (ops/attention.py::backward_plan mirrors it)
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, void* dq, void* dk, void* dv, float* ws, int BH,
                     int Tn, int D, float scale, cudaStream_t s) {
  if (D <= 64)
    return launch<T, 64, 32, 8>(q, k, v, o, dout, dq, dk, dv, ws, BH, Tn, D, scale, s);
  if (D <= 128)
    return launch<T, 128, 32, 16>(q, k, v, o, dout, dq, dk, dv, ws, BH, Tn, D, scale, s);
  if (D <= 256)
    return launch<T, 256, 16, 16>(q, k, v, o, dout, dq, dk, dv, ws, BH, Tn, D, scale, s);
  return launch_wide<T>(q, k, v, o, dout, dq, dk, dv, ws, BH, Tn, D, scale, s);
}

}  // namespace

// q, k, v, o (the forward's output), dout and dq, dk, dv: (BH, T, D)
// contiguous on the device, all fp32 or all bf16 (is_bf16); any D >= 1;
// `scale` = D^-1/4; `workspace` holds 2 * BH * T floats (the rows' lse and
// D).  Launches two kernels on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int attention_backward(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  void* workspace, int BH, int Tn, int D, float scale,
                                  int is_bf16, void* stream) {
  if (D < 1 || D > 65535 * 256 || Tn < 1 || BH < 1 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, ws, BH, Tn, D, scale, s)
              : dispatch<float>(q, k, v, o, dout, dq, dk, dv, ws, BH, Tn, D, scale, s);
  return static_cast<int>(err);
}
