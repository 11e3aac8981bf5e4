// Shared pieces of the weight-only GEMV kernels: the skeleton of the
// CUDA-core ones (int8_gemv.cu, q4_gemv.cu), the din-split reduce and the
// mma.sync of the tensor-core ones (q4_mma.cu, q4_wgmma.cu, int8_mma.cu).
//
// The CUDA-core kernels compute y[B, dout] = x[B, din] @ W[din, dout] for a
// small batch B (1..kMaxBatch) over weights stored dout-contiguous, the
// layout of moshi_tpu's QTensor / QTensor4.  At these batches the work is
// 2*B flops per weight byte (int8) or per half byte (q4): device-memory
// bandwidth bounds them, and at the small layers the fixed cost of a launch
// as much.  One design serves both, one launch per call, no workspace:
//
//  - Columns.  A lane owns `cols` neighbouring output columns (4, 8 or 16:
//    one 4-, 8- or 16-byte load of a weight row; at most kMaxAcc / B of
//    them, so a lane keeps at most kMaxAcc f32 sums), a warp 32 * cols
//    contiguous columns, whole 128-byte lines of each row.  A block is
//    `warps` warps on the same columns (one column tile, blockIdx.x).
//  - The din split, on chip.  The blocks of a column tile form a thread
//    block cluster of `cluster` <= kMaxCluster blocks (blockIdx.y is the
//    rank); rank r takes din rows [r * rows_per_block, ...), and its warps
//    take consecutive slices of those.  Every warp ends with the sums of
//    its slice and stores them into its block's shared memory; the block
//    adds its warps' sums in warp order, and each rank owns a share of the
//    tile's B * 32 * cols outputs: the block stores its sums straight into
//    the owners' shared memory (distributed shared memory), one 16-byte
//    store per four outputs, one slot per source rank.  One cluster barrier
//    later each rank adds its slots in rank order and stores y: no atomics,
//    no f32 partials in device memory, and the same bits from run to run.
//  - Bytes in flight.  A warp streams its slice kBatchRows weight rows at
//    a time through a ring of `stages(...)` stages in shared memory of its
//    own, kRingBytes a warp: cp.async (16 bytes a lane with L1 bypassed, 4
//    or 8 through L1, a 256-byte L2 prefetch) fills the stages ahead while
//    the warp sums the oldest one, at no cost in registers.  A ring in
//    registers held too little (each batch waited out a load's ~1.7 us);
//    8 KB a warp lets two blocks of 8 warps share an SM, which beat one
//    block with 16 or 24 KB a warp (PERF.md).  The first stages are
//    requested before x is staged.
//  - x.  Staged once per block (or per segment of seg_rows din rows, where
//    B * rows_per_block f32 would not fit) in shared memory as f32 [B, ld],
//    read as warp broadcasts.  No bf16 arithmetic happens in device code:
//    x is converted with __bfloat162float when it is staged and y with
//    __float2bfloat16 when it is stored.
//
// The host (ops/q4matmul.py `gemv_plan`) picks cols, warps, cluster,
// rows_per_block and seg_rows; `smem_bytes` is the shared memory that plan
// takes, which the host reckons the same way.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gemv {

constexpr int kMaxBatch = 16;    // batch rows a launch takes
constexpr int kMaxAcc = 64;      // batch rows x columns a lane sums
constexpr int kMaxWarps = 8;     // warps of a block
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kBatchRows = 8;    // weight rows (q4: packed rows) a warp loads at a time
constexpr int kXPad = 8;         // the staged x's row length is a multiple of this
constexpr int kSmemLimit = 227 * 1024;  // an H100 block's shared memory, opted in

// columns a lane may own at `batch` rows: 16, 8 or 4, at most max_acc / batch
// (kMaxAcc for int8_gemv.cu; q4_gemv.cu keeps two sums a column, the
// group's and the total, and takes kMaxAcc / 2)
__host__ __device__ constexpr int max_cols(int batch, int max_acc = kMaxAcc) {
  return batch <= max_acc / 16 ? 16 : batch <= max_acc / 8 ? 8 : 4;
}

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The stages of a warp's ring of weight rows (stage_bytes a stage): as
// many as kRingBytes hold, 2..8 (2 at B = 1 with 16 columns a lane).
constexpr int kRingBytes = 8 * 1024;
__host__ __device__ constexpr int stages(int stage_bytes) {
  return kRingBytes / stage_bytes < 2 ? 2 : kRingBytes / stage_bytes > 8 ? 8
                                                                          : kRingBytes / stage_bytes;
}

// Shared memory of a launch: each warp's sums [warps, batch, 32 * cols]
// f32; the slots of the sums the other ranks send, [ranks, quads a rank
// owns, 4] f32 (rank r owns the tile's quads of four outputs [r * q, ...),
// q = ceil(batch * 8 * cols / ranks), row-major [batch, 32 * cols]); x
// [batch, ld] f32, ld = seg_rows rounded up to kXPad; then each warp's
// ring of weight rows, ring_bytes a warp.
__host__ __device__ constexpr int rank_quads(int batch, int cols, int ranks) {
  return (batch * 8 * cols + ranks - 1) / ranks;
}
__host__ __device__ constexpr int x_offset(int batch, int cols, int warps, int ranks) {
  return warps * batch * 32 * cols + ranks * rank_quads(batch, cols, ranks) * 4;
}
__host__ __device__ constexpr size_t smem_bytes(int batch, int cols, int warps, int ranks,
                                                int seg_rows, int ring_bytes) {
  return sizeof(float) * (static_cast<size_t>(x_offset(batch, cols, warps, ranks)) +
                          static_cast<size_t>(batch) * round_up(seg_rows, kXPad)) +
         static_cast<size_t>(warps) * ring_bytes;
}

// What a launch of either CUDA-core kernel is given.  din rows (or groups)
// [rank * rows_per_block, ...) go to cluster rank `rank`; a block stages x
// seg_rows din rows at a time (both multiples of group_size for q4).
struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  void* out;
  int din, dout, group_size, rows_per_block, seg_rows;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// C bytes of a weight row.
template <int C>
struct Vec {
  uint32_t w[C / 4];
};
// ... copied from device memory into shared memory without a register: 16
// bytes with L1 bypassed (read once), 4 and 8 through L1 (cp.async.cg takes
// only 16); a 256-byte L2 prefetch brings the neighbouring lanes' and
// blocks' bytes along.  A warp's copies of a batch are one commit group.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int C>
__device__ __forceinline__ void cp_async(uint32_t dst, const int8_t* src) {
  if constexpr (C == 16) {
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
                 "n"(C)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// a lane's C bytes back from shared memory
template <int C>
__device__ __forceinline__ Vec<C> lds(const unsigned char* p) {
  Vec<C> v;
  if constexpr (C == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    v.w[0] = u.x, v.w[1] = u.y, v.w[2] = u.z, v.w[3] = u.w;
  } else if constexpr (C == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v.w[0] = u.x, v.w[1] = u.y;
  } else {
    v.w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  return v;
}

// The cluster barrier in two halves (every thread of every block arrives).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Rows [r0, r1) of x[NB, din] into xs [NB, ld] as f32, times 1/16 on odd
// rows where kOddOver16 (q4_gemv.cu's high nibbles; r0 is even there),
// zeros in the row tails [r1 - r0, ld).  In two halves: load() issues a
// thread's first kRows rows of every batch row into registers, before the
// kernel requests its first weight stages, so that x does not queue behind
// them; store() writes those, stages any rows past kRows * blockDim.x
// (segments longer than the main paths'), then a block barrier.
template <typename T, int NB, bool kOddOver16>
struct XStage {
  static constexpr int kRows = NB >= 8 ? 2 : NB >= 4 ? 4 : 16;
  float v[kRows][NB];

  __device__ __forceinline__ void load_round(const T* __restrict__ x, int din, int r0, int rows,
                                             int r) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int rr = r + u * static_cast<int>(blockDim.x);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        v[u][b] = rr < rows ? to_f32(x[static_cast<size_t>(b) * din + r0 + rr]) : 0.f;
    }
  }
  __device__ __forceinline__ void store_round(float* xs, int ld, int r) const {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int rr = r + u * static_cast<int>(blockDim.x);
      if (rr < ld) {
        const float f = kOddOver16 && (rr & 1) ? 0.0625f : 1.f;
#pragma unroll
        for (int b = 0; b < NB; ++b) xs[b * ld + rr] = v[u][b] * f;
      }
    }
  }
  __device__ __forceinline__ void load(const T* __restrict__ x, int din, int r0, int r1) {
    load_round(x, din, r0, r1 - r0, threadIdx.x);
  }
  __device__ __forceinline__ void store(const T* __restrict__ x, float* xs, int ld, int din, int r0,
                                        int r1) {
    store_round(xs, ld, threadIdx.x);
    for (int r = threadIdx.x + kRows * blockDim.x; r < ld; r += kRows * blockDim.x) {
      load_round(x, din, r0, r1 - r0, r);
      store_round(xs, ld, r);
    }
    __syncthreads();
  }
};

// The end of both kernels: this warp's sums acc[b][j] (column tile0 +
// cols * lane + j, row b) into the block's shared memory; the block's sums
// (its warps added in order) into the owners' slots, 16 bytes at a time;
// one cluster barrier; then this rank's outputs, its slots added in rank
// order, times colscale[col] where colscale is not null, stored to out[b,
// col] for col < dout.  The kernel arrived (relaxed) at the cluster barrier
// when it started, so that no block stores into a block that has not.
template <typename T, int NB, int C>
__device__ __forceinline__ void reduce_store(const float (&acc)[NB][C], float* smem,
                                             const float* __restrict__ colscale,
                                             T* __restrict__ out, int dout, int tile0) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kQuads = NB * 8 * C;  // the tile's outputs, four at a time
  const int rank = blockIdx.y, ranks = gridDim.y;
  const int warps = blockDim.x / 32, wk = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* sums = reinterpret_cast<float4*>(smem);  // [warps, kQuads]
  float4* slots = sums + warps * kQuads;           // [ranks, q]
  const int q = rank_quads(NB, C, ranks);
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int k = 0; k < C / 4; ++k)
      sums[wk * kQuads + (b * 32 + lane) * (C / 4) + k] =
          make_float4(acc[b][4 * k], acc[b][4 * k + 1], acc[b][4 * k + 2], acc[b][4 * k + 3]);
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  for (int i = threadIdx.x; i < kQuads; i += blockDim.x) {
    float4 s = sums[i];
    for (int w = 1; w < warps; ++w) {
      const float4 v = sums[w * kQuads + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int owner = i / q;
    *(cluster.map_shared_rank(slots, owner) + rank * q + i - owner * q) = s;
  }
  cluster_arrive_release();
  cluster_wait();  // every rank's sums are in their owners' slots

  const int first = rank * q, n = min(q, kQuads - first);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float4 s = slots[i];
    for (int r = 1; r < ranks; ++r) {
      const float4 v = slots[r * q + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int quad = first + i, b = quad / (8 * C), col = tile0 + 4 * (quad % (8 * C));
    T* o = out + static_cast<size_t>(b) * dout + col;
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (col + t < dout) store(o + t, colscale ? v[t] * colscale[col + t] : v[t]);
  }
}

// Launch `kernel` (a __global__ of one Args) on the plan: a grid of
// ceil(dout / (32 * cols)) column tiles by `cluster` ranks, clusters of
// (1, cluster, 1), 32 * warps threads, smem_bytes of shared memory (rings
// of ring_bytes a warp).
template <int NB, int C>
cudaError_t launch(void (*kernel)(Args), int ring_bytes, const Args& a, int warps, int cluster,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(NB, C, warps, cluster, a.seg_rows, ring_bytes);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((a.dout + 32 * C - 1) / (32 * C), cluster, 1);
  config.blockDim = dim3(32 * warps, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The blocks of `kernel` under a plan the card holds at once: the clusters
// of `cluster` blocks of 32 * warps threads and smem_bytes of shared memory
// that fit together (cudaOccupancyMaxActiveClusters, which counts how
// clusters pack into the GPCs), times cluster; 0 where the plan's shared
// memory passes kSmemLimit, minus a CUDA error code where the query fails.
template <int NB, int C>
int resident(void (*kernel)(Args), int ring_bytes, int warps, int cluster, int seg_rows) {
  const size_t smem = smem_bytes(NB, C, warps, cluster, seg_rows, ring_bytes);
  if (smem > kSmemLimit) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1, cluster, 1);
  config.blockDim = dim3(32 * warps, 1, 1);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters * cluster;
}

// The checks both C entry points make of a plan (the rest is the kernel's
// own): batch, cols for the batch, warps, cluster, rows covering din.
inline bool plan_ok(int batch, int din, int dout, int cols, int warps, int cluster,
                    int rows_per_block, int seg_rows, int max_acc) {
  return batch >= 1 && batch <= kMaxBatch && din >= 1 && dout >= 1 &&
         (cols == 4 || cols == 8 || cols == 16) && cols <= max_cols(batch, max_acc) && warps >= 1 &&
         warps <= kMaxWarps && cluster >= 1 && cluster <= kMaxCluster &&
         rows_per_block >= 1 && static_cast<long long>(rows_per_block) * cluster >= din &&
         seg_rows >= 1 && seg_rows <= rows_per_block;
}

// Calls FN<T, NB, cols>::run(args...) for the batch and cols of a call
// (cols 4, 8, 16 where max_cols(NB, kAcc) allows) and returns its result as
// an int; cudaErrorInvalidValue for anything else.
template <typename T, int kAcc, int NB, template <typename, int, int> class FN, typename... A>
int dispatch_cols(int cols, A... args) {
  if (cols == 4) return static_cast<int>(FN<T, NB, 4>::run(args...));
  if constexpr (max_cols(NB, kAcc) >= 8) {
    if (cols == 8) return static_cast<int>(FN<T, NB, 8>::run(args...));
  }
  if constexpr (max_cols(NB, kAcc) >= 16) {
    if (cols == 16) return static_cast<int>(FN<T, NB, 16>::run(args...));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
template <typename T, int kAcc, template <typename, int, int> class FN, int NB = 1,
          typename... A>
int dispatch(int batch, int cols, A... args) {
  if (batch == NB) return dispatch_cols<T, kAcc, NB, FN>(cols, args...);
  if constexpr (NB < kMaxBatch) {
    return dispatch<T, kAcc, FN, NB + 1>(batch, cols, args...);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the din-split reduce of the tensor-core kernels that split din over
// blocks (q4_mma.cu, q4_wgmma.cu)

// out[i] = (sum over splits of partial[s, i]) * scale[i % dout], for i over
// [n = B * dout); scale may be null.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ partial,
                              const float* __restrict__ scale,
                              T* __restrict__ out, int splits, int n, int dout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[static_cast<size_t>(k) * n + i];
  if (scale != nullptr) s *= scale[i % dout];
  store(out + i, s);
}

template <typename T>
void launch_reduce(const float* partial, const float* scale, T* out, int splits,
                   int n, int dout, cudaStream_t stream) {
  reduce_splits<T><<<(n + 255) / 256, 256, 0, stream>>>(partial, scale, out,
                                                         splits, n, dout);
}

// ---- the tensor-core kernels: mma.sync.m16n8k16 with bf16 operands

// d += a @ b on one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace gemv

// Message for an error code returned by a C entry point of this library.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
