// Weight gradient of the 3x3 stride-1 zero-pad-1 convolution on Hopper's
// tensor cores, for bf16 x and dL/dy with Cin and Cout multiples of 64:
//
//   dW[di, dj, ci, co] = sum over (b, h, w) of x[b, h+di-1, w+dj-1, ci] * dy[b, h, w, co]
//
// with a zero halo, fp32 accumulation and an fp32 (3, 3, Cin, Cout) result.
// The JAX package differentiates its XLA conv (`MatmulConv3x3`; the Pallas
// kernel `_kernel` / `conv3x3_same` of diffusion_models_dev_project_tpu/ops/
// conv3x3.py has no backward), so this kernel replaces no TPU kernel of its
// own.  It is the third GEMM of the conv whose forward and input gradient
// are conv3x3_tc.cu: M = input channels, N = Cout, K = B H W pixels, per tap.
// ops/conv3x3.py::wgrad_plan picks it (`tc`), its box and its split of K.
//
// What bounds it on the H100: 2 K 9 Cin Cout operations (1.11 TFLOP per
// batch-3 training backward of the flagship UNet) over a few hundred MB, so
// the bf16 tensor-core rate; at these tiles the bytes staged from L2 come
// close to it (below).  What the design does about it:
//
// - `wgmma.mma_async` m64n128k16, bf16 x bf16 -> fp32, both operands
//   MN-major from shared memory: A = x^T (M = channels, K = pixels) and
//   B = dL/dy (K = pixels, N = channels) land pixel-major, 64 channels (128
//   bytes) a row, as TMA writes them; wgmma's transpose bits take them so.
// - A block owns one kernel column (fixed dj; di = 0, 1, 2) x 128 input
//   channels x 128 output channels: three m64n128 accumulators (192 fp32
//   registers) in each of its two warpgroups.  A stage holds one box of
//   Ht x Wt output pixels of dL/dy and one box of x, Ht + 2 rows x Wt
//   columns at (w0 + dj - 1, h0 - 1), whose zero fill off the image is the
//   conv's padding.  Tap di's operand starts di Wt pixel rows into the x
//   box; with Wt a multiple of 8 that is a multiple of the 128-byte
//   swizzle's 1024-byte period, so a plain descriptor offset selects the
//   tap.  So each byte of dL/dy staged feeds three products, and x is read
//   once per column of taps instead of once per tap: 181 operations per
//   staged byte at 16 x 8 boxes, where a one-tap block of the same size
//   gets 64.  The 132 blocks of a wave then ask L2 for ~5 TB/s, about
//   what it gives: loads and products each take most of the time alone.
// - No producer warp: the 192 accumulators need the 255 registers a thread
//   has only at 8 warps a block (a ninth warp puts three warps on one of
//   the SM's four register quarters, 168 registers each; nvcc 12.9 did not
//   lend the consumers a producer's registers through `setmaxnreg`, and
//   spilled).  Thread 0 issues the TMA loads, predicated inside the
//   instructions, and every wait loop sits inside one asm block: a branch
//   around them makes the compiler serialize the wgmma.
// - A ring of as many stages as fit (3 for 16 x 8 boxes), `mbarrier`s
//   for "stage full" and "stage empty"; a slot is refilled once every
//   thread is done with it.  A wait on a barrier that does not complete
//   traps (tma_wgmma.cuh).
// - Split-K in one wave: the plan sizes splits x tiles to the device's SMs
//   (one block per SM).  Splits have fixed boundaries: split y of S runs K
//   steps [y K / S, (y + 1) K / S), so any S up to K leaves none empty.  A
//   cluster of `cluster` consecutive splits adds its partial sums in rank
//   order through distributed shared memory, each block summing a slice of
//   the tile, so only one fp32 partial per cluster reaches device memory; a
//   second kernel (conv3x3_wgrad.cu) adds the clusters' partials in order.
//   No atomics: two launches give the same bits.  Both kernels launch as
//   programmatic dependents of the one before them, so each one's set-up
//   overlaps the end of the previous one.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tma_wgmma.cuh"

extern "C" int conv3x3_wgrad_reduce(const void* workspace, void* dw, long long n, int splits,
                                    void* stream);

namespace {

constexpr int MAX_STAGES = 6;             // ring slots, as many as the box's stages fit
constexpr int ROW = 128;                    // bytes of one pixel row of a box: 64 bf16 channels
constexpr int BM = 128;                     // input channels per block: two consumer warpgroups
constexpr int BN = 128;                     // output channels per block: two dL/dy boxes
constexpr int BOX_W = 8;                    // output pixels of a box's row
constexpr int MAX_BOX_H = 16;               // rows of a box, at most: 128 output pixels
constexpr int MAX_STAGE = 2 * (MAX_BOX_H + 2) * BOX_W * ROW + 2 * MAX_BOX_H * BOX_W * ROW;
constexpr int THREADS = 256;                // two warpgroups, 64 input channels each
constexpr int PAIRS = 96;                   // float2 pairs of a thread's 3 x 64 accumulators
constexpr int RING = 3 * MAX_STAGE;        // three stages of the largest box
constexpr int EXCHANGE = PAIRS * THREADS * 8;       // a block's tile, staged for its cluster
constexpr int BARRIERS = RING > EXCHANGE ? RING : EXCHANGE;
constexpr int SMEM = BARRIERS + 1024 + 2 * MAX_STAGES * 8;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared address `addr` of this block in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// Grid: x = tile (co block fastest, then ci block, then dj), y = split.
// Split y runs K steps [y K / S, (y + 1) K / S); a K step is one box of
// box_h x box_w output pixels of one image.  `out` is dW when a cluster
// holds all the splits, else the workspace, one partial per cluster.
__global__ void __launch_bounds__(THREADS, 1)
wgrad_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap dy_map, float* __restrict__ out, int H, int W,
                int Cin, int Cout, int box_h, int box_w, int k_steps, int cluster) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARRIERS);
  uint64_t* empty = full + MAX_STAGES;

  const int n_co = Cout / BN + (Cout % BN != 0);
  const int n_ci = Cin / BM + (Cin % BM != 0);
  const int co0 = (blockIdx.x % n_co) * BN;
  const int ci0 = ((blockIdx.x / n_co) % n_ci) * BM;
  const int dj = blockIdx.x / (n_co * n_ci);
  const int s_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * k_steps / gridDim.y);
  const int n_steps =
      static_cast<int>(static_cast<long long>(blockIdx.y + 1) * k_steps / gridDim.y) - s_begin;
  const int x_bytes = (box_h + 2) * box_w * ROW;      // one 64-channel box of x
  const int d_bytes = box_h * box_w * ROW;            // one 64-channel box of dL/dy
  const int stride = 2 * (x_bytes + d_bytes);         // a stage: a multiple of 1024 bytes
  const int stages = min(MAX_STAGES, RING / stride);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);    // warpgroup, warp-uniform

  if (tid == 0) {
    for (int i = 0; i < MAX_STAGES; ++i) {
      mbar_init(&full[i], 1);                  // the issuing thread's expect_tx
      mbar_init(&empty[i], THREADS);           // every thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // launched as a programmatic dependent of the stream's previous kernel:
  // the set-up above overlaps its end; x and dL/dy are read only after it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // step s of the block's range into ring slot `slot`: the x box of this
  // column of taps (both 64-channel halves) and the dL/dy boxes.  Every
  // thread runs it; thread 0 alone issues (predicates inside the
  // instructions: a branch here would make the compiler serialize wgmma).
  const int tiles_w = (W + box_w - 1) / box_w;
  const int tiles_img = ((H + box_h - 1) / box_h) * tiles_w;
  const bool leader = tid == 0;
  auto issue = [&](int s, int slot) {
    mbar_expect_tx(&full[slot], 2 * (x_bytes + d_bytes), leader);
    const int b = s / tiles_img;
    const int t = s - b * tiles_img;
    const int h0 = (t / tiles_w) * box_h;
    const int w0 = (t % tiles_w) * box_w;
    const uint32_t base = smem_u32(smem + slot * stride);
    tma_load_4d(base, &x_map, &full[slot], ci0, w0 + dj - 1, h0 - 1, b, leader);
    tma_load_4d(base + x_bytes, &x_map, &full[slot], ci0 + 64, w0 + dj - 1, h0 - 1, b, leader);
    tma_load_4d(base + 2 * x_bytes, &dy_map, &full[slot], co0, w0, h0, b, leader);
    tma_load_4d(base + 2 * x_bytes + d_bytes, &dy_map, &full[slot], co0 + 64, w0, h0, b, leader);
  };
  for (int i = 0; i < stages && i < n_steps; ++i) issue(s_begin + i, i);

  float acc[3][64];
#pragma unroll
  for (int di = 0; di < 3; ++di)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[di][i] = 0.f;
  const int k16 = box_h * box_w / 16;
  const uint64_t tap = static_cast<uint64_t>(box_w * ROW / 16);   // di * box_w pixel rows
  int stage = 0, phase = 0;
  for (int i = 0; i < n_steps; ++i) {
    mbar_wait(&full[stage], phase);
    // descriptors of this warpgroup's x box and of the dL/dy boxes (B's
    // leading offset steps to the second 64-channel box); a k16 step is 16
    // pixel rows, 2048 bytes, further on; the address field counts 16-byte
    // units
    const uint32_t base = smem_u32(smem + stage * stride);
    const uint64_t da = smem_desc(base + g * x_bytes, x_bytes, 1024);
    const uint64_t db = smem_desc(base + 2 * x_bytes, d_bytes, 1024);
#pragma unroll
    for (int di = 0; di < 3; ++di) fence_operands(acc[di]);
    wgmma_fence();
    for (int kk = 0; kk < k16; ++kk) {
      const uint64_t step = static_cast<uint64_t>(kk * 2048 / 16);
#pragma unroll
      for (int di = 0; di < 3; ++di) wgmma_m64n128k16<1>(acc[di], da + step + di * tap, db + step);
    }
    wgmma_commit();
    // the previous step's wgmma are done: its slot is free once every
    // thread says so, and is refilled with the step `stages` after it
    wgmma_wait<1>();
#pragma unroll
    for (int di = 0; di < 3; ++di) fence_operands(acc[di]);
    if (i > 0) {
      const int slot = stage == 0 ? stages - 1 : stage - 1;
      mbar_arrive(&empty[slot]);
      if (i - 1 + stages < n_steps) {
        mbar_wait(&empty[slot], ((i - 1) / stages) & 1);
        issue(s_begin + i - 1 + stages, slot);
      }
    }
    if (++stage == stages) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int di = 0; di < 3; ++di) fence_operands(acc[di]);
  // the split-K reduction may start launching; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // ---- epilogue.  Accumulator layout of m64nNk16: register 4j + 2i + e
  // holds row 16*warp + lane/4 + 8i, column 8j + 2*(lane%4) + e; pair
  // p = 32 di + 2j + i holds tap di's (e = 0, 1).
  const int row_base = ci0 + 64 * g + 16 * ((tid % 128) / 32) + lane / 4;
  const int col_base = co0 + 2 * (lane % 4);
  float* const dst = out + static_cast<long long>(blockIdx.y / cluster) * 9 * Cin * Cout;
  auto store = [&](int di, int j, int i, float2 v) {
    const int ci = row_base + 8 * i, co = col_base + 8 * j;
    if (ci < Cin && co < Cout)           // Cout % 64 == 0: co + 1 < Cout too
      *reinterpret_cast<float2*>(dst + (static_cast<long long>(di * 3 + dj) * Cin + ci) * Cout + co) = v;
  };
  if (cluster == 1) {
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          store(di, j, i, make_float2(acc[di][4 * j + 2 * i], acc[di][4 * j + 2 * i + 1]));
    return;
  }
  // Cluster: stage the tile (pair-major, a float2 per thread), then block
  // `rank` sums pairs [rank, rank + 1) x PAIRS / cluster over the cluster's
  // blocks in rank order and stores them.
  float2* const ex = reinterpret_cast<float2*>(smem);
  __syncthreads();                       // both warpgroups are off the ring
#pragma unroll
  for (int di = 0; di < 3; ++di)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ex[(32 * di + 2 * j + i) * THREADS + tid] =
            make_float2(acc[di][4 * j + 2 * i], acc[di][4 * j + 2 * i + 1]);
  cluster_sync();
  // PAIRS / cluster pairs (96 or 48) in runs of 12, each run's
  // remote loads issued together: a DSMEM load takes hundreds of clocks
  constexpr int RUN = 12;
  const int per = PAIRS / cluster;
  const int p0 = static_cast<int>(cluster_rank()) * per;
  const uint32_t mine = smem_u32(ex + tid);
  for (int p = p0; p < p0 + per; p += RUN) {
    float2 v[RUN];
    const uint32_t first = cluster_addr(mine, 0) + p * THREADS * 8;
#pragma unroll
    for (int k = 0; k < RUN; ++k) v[k] = ld_cluster_f2(first + k * THREADS * 8);
    for (int q = 1; q < cluster; ++q) {
      const uint32_t at = cluster_addr(mine, q) + p * THREADS * 8;
      float2 u[RUN];
#pragma unroll
      for (int k = 0; k < RUN; ++k) u[k] = ld_cluster_f2(at + k * THREADS * 8);
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        v[k].x += u[k].x;
        v[k].y += u[k].y;
      }
    }
#pragma unroll
    for (int k = 0; k < RUN; ++k) store((p + k) / 32, ((p + k) % 32) / 2, (p + k) % 2, v[k]);
  }
  cluster_sync();                        // no block leaves while another reads its tile
}

// the launch of the kernel on `grid` in clusters of `cluster` splits, as a
// programmatic dependent of the stream's previous kernel (at[0 .. 1])
cudaLaunchConfig_t config(dim3 grid, int cluster, cudaStream_t stream, cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = static_cast<unsigned>(cluster);
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace

// x (B,H,W,Cin) and dy (B,H,W,Cout) bf16, Cin and Cout multiples of 64,
// 16-byte aligned; dw (3,3,Cin,Cout) fp32; workspace (splits / cluster, 9
// Cin Cout) fp32 when splits > cluster (else unused, may be null).  All
// contiguous on the device.  box_h x box_w output pixels per K step (box_w
// 8, box_h even, 2 to 16); 1 <= splits <= K steps, in clusters of
// `cluster` (1 or 2, dividing splits).  Launches on `stream`, allocates
// nothing.  Returns a cudaError_t, or minus the CUresult
// when a tensor map cannot be encoded.
extern "C" int conv3x3_wgrad_tc(const void* x, const void* dy, void* dw, void* workspace, int B,
                                int H, int W, int Cin, int Cout, int box_h, int box_w, int splits,
                                int cluster, void* stream) {
  const bool box_ok = box_w == BOX_W && box_h >= 2 && box_h <= MAX_BOX_H && box_h % 2 == 0;
  if (!box_ok || B < 1 || H < 1 || W < 1 || Cin < 64 || Cin % 64 || Cout < 64 || Cout % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long k_steps =
      static_cast<long long>(B) * ((H + box_h - 1) / box_h) * ((W + box_w - 1) / box_w);
  const int groups = cluster > 0 ? splits / cluster : 0;
  const bool ok = k_steps <= 0x7fffffffLL && splits >= 1 && splits <= 65535 && splits <= k_steps &&
                  (cluster == 1 || cluster == 2) &&
                  splits % cluster == 0 && (groups == 1 || workspace != nullptr) &&
                  (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap xm, dym;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t xstrides[3] = {2ULL * Cin, 2ULL * Cin * W, 2ULL * Cin * W * H};
  const cuuint32_t xbox[4] = {64, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h + 2), 1};
  CUresult r = encode(&xm, x, 4, xdims, xstrides, xbox);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const cuuint64_t ddims[4] = {static_cast<cuuint64_t>(Cout), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t dstrides[3] = {2ULL * Cout, 2ULL * Cout * W, 2ULL * Cout * W * H};
  const cuuint32_t dbox[4] = {64, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1};
  r = encode(&dym, dy, 4, ddims, dstrides, dbox);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  static std::atomic<unsigned long long> allowed{0};
  cudaError_t err = allow_smem(wgrad_tc_kernel, SMEM, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dst = static_cast<float*>(groups > 1 ? workspace : dw);
  const unsigned tiles = 3u * (Cin / BM + (Cin % BM != 0)) * (Cout / BN + (Cout % BN != 0));
  int k = static_cast<int>(k_steps);
  cudaLaunchAttribute at[2];
  const cudaLaunchConfig_t cfg = config(dim3(tiles, static_cast<unsigned>(splits), 1), cluster,
                                        static_cast<cudaStream_t>(stream), at);
  void* args[] = {&xm, &dym, &dst, &H, &W, &Cin, &Cout, &box_h, &box_w, &k, &cluster};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(wgrad_tc_kernel), args);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  return conv3x3_wgrad_reduce(workspace, dw, 9LL * Cin * Cout, groups, stream);
}

// The most clusters of `cluster` blocks of the tc kernel the current device
// runs at once (cudaOccupancyMaxActiveClusters), in *count.
extern "C" int conv3x3_wgrad_tc_max_clusters(int cluster, int* count) {
  static std::atomic<unsigned long long> allowed{0};
  const cudaError_t err = allow_smem(wgrad_tc_kernel, SMEM, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute at[2];
  const cudaLaunchConfig_t cfg = config(dim3(1, static_cast<unsigned>(cluster), 1), cluster,
                                        nullptr, at);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, reinterpret_cast<const void*>(wgrad_tc_kernel), &cfg));
}
