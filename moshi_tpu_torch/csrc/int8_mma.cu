// int8_mma: per-output-channel int8 weight-only GEMV on the tensor cores,
// for bf16 activations at a decoding batch (B <= 16), on Hopper (sm_90a).
//
// Replaces, beside int8_gemv.cu, the Pallas TPU kernel
// moshi_tpu/ops/qmatmul.py `qgemv` (and the dequantising dot XLA fused for
// `wdot(x, QTensor)`).  ops/qmatmul.py sends bf16 calls of 1..16 rows here
// and every other call (f32, other shapes) to int8_gemv.cu.
//
// Computes y[B, dout] = (x[B, din] @ q[din, dout]) * scale[1, dout]:
//   q     int8 [din, dout], dout-contiguous (the QTensor layout, unchanged);
//   scale f32 [1, dout], applied once per column after the whole f32 dot,
//         as the TPU kernel does (qmatmul.py:42-44);
//   x, y  bf16.
// Every int8 and every bf16 x is exact in bf16, so each tensor-core product
// is exact and only the order of the f32 sums differs from the plain version.
//
// What bounds it: 2*B flops per weight byte, so at B <= 16 device-memory
// bandwidth, and at the depformer's 1-6 MB per call the latency of one
// launch as much.  int8_gemv.cu did those flops as f32 FMAs on the CUDA
// cores and split din over blocks whose f32 partial sums went through device
// memory to a second kernel (4x the weight's bytes at B = 16).  Here one
// mma.sync.m16n8k16 does 16 rows x 8 columns x 16 din of them, the CUDA cores
// only convert bytes, and the din split is added on chip: one launch, no
// workspace, and nothing between a block's first loads and its first mma but
// their latency.
//
// Fragment mapping (lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
// the PTX ISA layouts of mma.m16n8k16.row.col with bf16 operands):
//  - a warp computes 16 batch rows x 64 output columns as eight n8 tiles t;
//    fragment column n of tile t is output column c0 + 8n + t;
//  - k: the sum does not care which din row sits in which k slot, as long
//    as A and B agree.  In the k16 step at din k0, slots 2tig, 2tig+1,
//    2tig+8, 2tig+9 of a lane hold din rows k0+4tig .. k0+4tig+3;
//  - B: register b0 holds rows k0+4tig (low half) and k0+4tig+1 (high half)
//    of fragment column gid: byte t of the 8 contiguous bytes
//    q[row * dout + c0 + 8 gid ..] of those rows; b1 the same of rows +2 and
//    +3.  So a lane loads 8 bytes of each of 4 consecutive rows per step, and
//    across the warp one load reads 4 rows x 64 contiguous bytes: every
//    32-byte sector is used whole.  No weight goes through shared memory and
//    nothing is re-laid out;
//  - A: a0/a2 are the low/high 4 bytes of one 8-byte load of x[gid, k0+4tig
//    ..], a1/a3 the same of row gid + 8, straight from global memory (x is
//    small and stays in L2); rows >= B are zero in registers;
//  - C: a lane holds, in rows gid and gid + 8, output columns
//    c0 + 16 tig + 8j + t (j = 0, 1; t = 0..7): 16 contiguous columns.
//
// int8 -> bf16, exact, in registers: a byte permute puts the biased byte
// u = v ^ 0x80 = v + 128 under the exponent of 2^23 (f32 bits 0x4B0000uu =
// 2^23 + u); one f32 subtraction of 2^23 + 128 gives v exactly; v is an
// integer of at most 8 significant bits, so the f32's low 16 bits are zero
// and its high half is v in bf16: one more byte permute packs two rows'
// halves into a B register.  Per byte that is 1.5 permutes and one FADD (32
// bytes per lane and k16 step): at 3.35 TB/s, 5.0e12 permutes/s against
// the ~1.5e13 of the 132 SMs' integer pipes (64 lanes a clock at ~1.75 GHz)
// and 3.4e12 FADDs/s against ~3e13, so the conversion is not the limit.
//
// The din split, added on chip in a fixed order (a result does not change
// from run to run), in one pass and one cluster barrier:
//  - a block is one warp's 64 columns; its kWarps warps take interleaved k16
//    steps of its rows; the blocks of one column tile form a thread block
//    cluster (at most 8, the portable size) over din;
//  - rank r of the cluster owns a share of the tile's outputs.  After its
//    dot every warp stores its f32 sums straight into the owners' shared
//    memory (distributed shared memory, map_shared_rank), one slot per
//    (rank, warp); one cluster barrier (release / acquire) later each rank
//    adds its slots in rank and warp order, scales and stores bf16.  A rank
//    reads only its own shared memory after the barrier, so no block waits
//    for another to finish reading before it exits, and the barrier that
//    makes sure every block has started before the first remote store is
//    arrived at before the dot and waited on after it.
// Each lane loads the weight and x bytes of its next kDepth k16 steps before
// it works on this one's; weights with L1::no_allocate and a 256-byte L2
// prefetch.
//
// Chosen by measurement on the H100 (PERF.md): x read straight from
// global memory beat staging it in shared memory first; pushing the sums
// into the owners' slots behind one barrier beat reading every rank's block
// sum after a full cluster.sync() (a launch's fixed cost fell); one 64-column
// warp tile per block with four warps over din beat 128-column blocks and
// eight warps; loading one step ahead beat two and four.

#include <cooperative_groups.h>

#include "gemv_common.cuh"

namespace cg = cooperative_groups;

namespace {

using gemv::mma_bf16;

constexpr int kTiles = 8;                // n8 tiles per warp
constexpr int kBlockCols = 8 * kTiles;   // ops/qmatmul.py MMA_BLOCK_COLS: one warp's columns
constexpr int kWarps = 4;                // warps that split a block's din rows
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 1;                // k16 steps of bytes loaded ahead
constexpr int kMaxCluster = 8;                  // the portable cluster size
constexpr uint32_t kBias = 0x80808080u;         // byte v -> v ^ 0x80 = v + 128
constexpr uint32_t kTwo23 = 0x4B000000u;        // f32 2^23
constexpr float kTwo23Plus128 = 8388736.0f;     // 2^23 + 128

// The lane's 8 bytes of one weight row: read once, so not kept in L1, and
// with a 256-byte L2 prefetch, so that the neighbouring warps' bytes of the
// row come from L2.
__device__ __forceinline__ uint2 load8(const int8_t* p) {
  uint2 w;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
      : "=r"(w.x), "=r"(w.y) : "l"(p));
  return w;
}

// The bytes a lane needs for one k16 step: 8 of each of the 4 weight rows
// k0+4tig .. +3, and 8 of x's rows gid and gid + 8 (0 past the batch).
__device__ __forceinline__ void load_step(const int8_t* q, size_t dout,
                                          const __nv_bfloat16* xlo, const __nv_bfloat16* xhi,
                                          bool lo_row, bool hi_row, uint2 (&w)[4],
                                          uint2 (&xv)[2]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) w[r] = load8(q + r * dout);
  xv[0] = lo_row ? __ldg(reinterpret_cast<const uint2*>(xlo)) : make_uint2(0, 0);
  xv[1] = hi_row ? __ldg(reinterpret_cast<const uint2*>(xhi)) : make_uint2(0, 0);
}

// A B register from biased words: byte t of `lo` as the low bf16, byte t of
// `hi` as the high one (see the note at the top: exact).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi, int t) {
  const uint32_t sel = 0x7440u | t;  // bytes (u, 0, 0, 0x4B): f32 2^23 + u
  const float flo = __uint_as_float(__byte_perm(lo, kTwo23, sel)) - kTwo23Plus128;
  const float fhi = __uint_as_float(__byte_perm(hi, kTwo23, sel)) - kTwo23Plus128;
  return __byte_perm(__float_as_uint(flo), __float_as_uint(fhi), 0x7632u);
}

// Shared memory of a block: the slots of the outputs it owns, float4
// [ranks, kWarps, per] (per = its share of the tile's quads of columns),
// then the block's kBlockCols scales.
__host__ __device__ __forceinline__ size_t slots_bytes(int batch, int ranks) {
  const int quads = batch * kBlockCols / 4, per = (quads + ranks - 1) / ranks;
  return sizeof(float4) * ranks * kWarps * per;
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

// grid: (ceil(dout / kBlockCols), cluster size), clusters of (1, size, 1):
// the cluster is one column tile, its rank r covers din rows
// [r * rows_per_block, ...).
__global__ void __launch_bounds__(kThreads) int8_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int batch,
    int din, int dout, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.y, ranks = gridDim.y;  // the cluster spans gridDim.y
  float4* slots = reinterpret_cast<float4*>(smem);
  float* ss = reinterpret_cast<float*>(smem + slots_bytes(batch, ranks));
  cluster_arrive_relaxed();  // this block has started; waited on before the first remote store
  const int row0 = rank * rows_per_block;
  const int rows = max(0, min(rows_per_block, din - row0));

  const int wk = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * kBlockCols;
  const int nsteps = rows / 16;
  // this warp's k16 steps of the block: wk, wk + kWarps, ... (warp-uniform:
  // mma.sync needs every lane)
  const int mine = wk < nsteps ? (nsteps - wk + kWarps - 1) / kWarps : 0;
  const size_t ld = dout;
  const int krow = row0 + 16 * wk + 4 * tig;  // the lane's first din row
  const int8_t* qp = q + static_cast<size_t>(krow) * ld + c0 + 8 * gid;
  const size_t step = 16 * kWarps * ld;  // bytes from one of this warp's steps to the next
  const bool lo_row = gid < batch, hi_row = gid + 8 < batch;
  const __nv_bfloat16* xlo = x + static_cast<size_t>(gid) * din + krow;
  const __nv_bfloat16* xhi = xlo + 8 * static_cast<size_t>(din);
  const int xstep = 16 * kWarps;

  uint2 ring[kDepth][4], xring[kDepth][2];
#pragma unroll
  for (int i = 0; i < kDepth; ++i)
    if (i < mine)
      load_step(qp + i * step, ld, xlo + i * xstep, xhi + i * xstep, lo_row, hi_row, ring[i],
                xring[i]);
  for (int i = threadIdx.x; i < kBlockCols / 4; i += kThreads) {
    const int col = blockIdx.x * kBlockCols + 4 * i;
    if (col < dout)
      reinterpret_cast<float4*>(ss)[i] = __ldg(reinterpret_cast<const float4*>(scale + col));
  }

  float acc[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;

  for (int j0 = 0; j0 < mine; j0 += kDepth) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int j = j0 + i;
      if (j < mine) {
        uint32_t w[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          w[r][0] = ring[i][r].x ^ kBias;
          w[r][1] = ring[i][r].y ^ kBias;
        }
        const uint32_t a[4] = {xring[i][0].x, xring[i][1].x, xring[i][0].y, xring[i][1].y};
        if (j + kDepth < mine) {
          const int jn = j + kDepth;
          load_step(qp + jn * step, ld, xlo + jn * xstep, xhi + jn * xstep, lo_row, hi_row,
                    ring[i], xring[i]);
        }
#pragma unroll
        for (int t = 0; t < kTiles; ++t)
          mma_bf16(acc[t], a, bf16_pair(w[0][t / 4], w[1][t / 4], t % 4),
                   bf16_pair(w[2][t / 4], w[3][t / 4], t % 4));
      }
    }
  }

  // the warp's sums to the owners' slots: rank owns quads [rank * per, ...)
  // of the tile's batch * kBlockCols outputs (row-major, 4 columns a quad)
  const int quads = batch * kBlockCols / 4, per = (quads + ranks - 1) / ranks;
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows gid and gid + 8: acc[t][2h + j]
    const int row = gid + 8 * h;
    if (row < batch) {
#pragma unroll
      for (int i = 0; i < kTiles / 2; ++i) {  // columns 16 tig + 4i .. +3 = 8j + t
        const int j = i / 2, t = 4 * (i % 2);
        const int quad = (row * kBlockCols + 16 * tig + 4 * i) / 4;
        const int owner = quad / per;
        float4* dst = cluster.map_shared_rank(slots, owner);
        dst[(rank * kWarps + wk) * per + quad - owner * per] =
            make_float4(acc[t][2 * h + j], acc[t + 1][2 * h + j], acc[t + 2][2 * h + j],
                        acc[t + 3][2 * h + j]);
      }
    }
  }
  cluster_arrive_release();
  cluster_wait();  // every rank's sums are in their owners' slots

  // this rank's outputs: its slots added in rank and warp order, scaled
  for (int lq = threadIdx.x; lq < per && rank * per + lq < quads; lq += kThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < ranks; ++r) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 v = slots[(r * kWarps + w) * per + lq];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
    const int quad = rank * per + lq;
    const int b = 4 * quad / kBlockCols, c = 4 * quad % kBlockCols;
    const int col = blockIdx.x * kBlockCols + c;
    if (col < dout) {
      const float4 sc = *reinterpret_cast<const float4*>(ss + c);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x * sc.x, s.y * sc.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z * sc.z, s.w * sc.w);
      *reinterpret_cast<uint2*>(out + static_cast<size_t>(b) * dout + col) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/qmatmul.py.  x and
// out are bf16.  The grid is one cluster of `cluster` blocks per 64-column
// tile; rank r covers din rows [r * rows_per_block, ...), which must cover
// din.  Takes batch 1..16, din a multiple of 16, dout a multiple of 64,
// rows_per_block a multiple of 16, cluster 1..8, x and q 8-byte and scale
// 16-byte aligned, at most 48 KB of shared memory; anything else returns
// cudaErrorInvalidValue.  Returns the launch's error code.
extern "C" int int8_mma(const void* x, const void* q, const void* scale, void* out,
                        int batch, int din, int dout, int rows_per_block, int cluster,
                        void* stream) {
  if (batch < 1 || batch > gemv::kMaxBatch || din < 16 || din % 16 != 0 ||
      dout % kBlockCols != 0 || rows_per_block < 16 || rows_per_block % 16 != 0 ||
      cluster < 1 || cluster > kMaxCluster ||
      static_cast<long long>(rows_per_block) * cluster < din ||
      reinterpret_cast<uintptr_t>(x) % 8 != 0 || reinterpret_cast<uintptr_t>(q) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(scale) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slots_bytes(batch, cluster) + sizeof(float) * kBlockCols;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((dout + kBlockCols - 1) / kBlockCols, cluster, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, int8_mma_kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), batch, din, dout, rows_per_block);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
