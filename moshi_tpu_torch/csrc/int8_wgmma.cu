// int8_wgmma: per-output-channel int8 weight-only matrix product for bf16 x
// of more than 16 rows, on Hopper (sm_90a) with TMA and wgmma.
//
// Replaces, for bf16 x of more than 16 rows, the Pallas TPU kernel
// moshi_tpu/ops/qmatmul.py `qgemv` (:48), and the dequantising dot XLA
// fuses for `wdot(x, QTensor)` at any row count
// (moshi_tpu/utils/matmul.py:83).  ops/qmatmul.py sends bf16 calls of more
// than 16 rows here (TTS at 32 model rows, int8 training's B * T, the
// depformer past 16 slots); int8_mma.cu keeps 1..16 rows, int8_gemv.cu f32
// and widths off 64.
//
// Computes y[M, dout] = (x[M, din] @ q[din, dout]) * scale[1, dout]:
//   q     int8 [din, dout], dout-contiguous (the QTensor layout, unchanged;
//         a member of a stacked weight is the view q[l]);
//   scale f32 [1, dout], applied once per column after the whole f32 dot,
//         as the TPU kernel does (qmatmul.py:44);
//   x, y  bf16.
// Every int8 and every bf16 x is exact in bf16, so every product is exact
// and only the order of the f32 sums differs from the plain version.
//
// What bounds it: 2*M flops per weight byte.  Up to M ~ 150 that is under
// the card's ~295 flops a byte, so device memory bounds it (the depformer
// at M = 32 and 64, the TTS frame at 32 rows); at M = 512 (the training
// forward) the tensor cores do.  The 16-row int8_mma launches this replaces
// read the whole weight, and converted every byte on the CUDA cores, once
// per 16 rows, and mma.sync cannot reach the tensor cores' rate.  Here a
// block takes kRows = 128 rows, so each weight is converted once per 128
// rows, into shared memory, where wgmma reads it; the row tiles of a column
// tile are neighbours in launch order, so all but the first read its
// weights from L2; one launch a call (and the reduce of a din split).  The
// conversion (gemv::int8_bf16_pair: 1.5 permutes and one FADD a byte, and 2
// bytes of shared memory written a weight) has only to keep up with an
// SM's share of device memory at M <= 64, and can set the pace at M = 512:
// the design gives it warps of its own, off the copies' and the tensor
// cores' path.
//
// The design (a block computes kRows x kCols of y):
//  - kProducerGroups warpgroups produce.  Thread 0 keeps a ring of kStages
//    stages in flight with two TMA copies a stage, kK = 64 din of x bf16
//    [128, 64] and of q int8 [64, kCols], both stored with the 128-byte
//    swizzle; they complete on the stage's `full` mbarrier.  The other
//    kConvertWarps warps convert each landed int8 tile, once, into the
//    stage's bf16 [kCols, 64] tile, K-major with the 128-byte swizzle (the
//    layout of wgmma_common.cuh), and arrive on its `ready` mbarrier after
//    fence.proxy.async.  A stage is kUnits units of 8 din rows x kCols
//    columns, dealt round the converting warps in one sequence over all
//    stages (unit u of stage s to warp (kUnits s + u) % kConvertWarps), so
//    any warp count shares the work evenly;
//  - two consumer warpgroups, 64 rows of x each: x lies in the same
//    swizzled K-major layout as the bf16 tile, so wgmma.m64n128k16 takes
//    both operands from shared memory by descriptor, into one f32
//    accumulator (64 registers a thread: no group scale, unlike q4).  A
//    stage's four k16 steps are one batch; each consumer warp releases a
//    stage's slot on its `empty` mbarrier once the next stage's batch is
//    issued and this one's is done (wgmma.wait_group 1);
//  - the epilogue: the accumulator times the column scale, read once for
//    each of a lane's columns, to bf16; with a din split, the unscaled f32
//    partial sums instead.
// The copies wait for a free slot only, the conversion for the copies only.
// Rows past M and din past the weight read as zero (the TMA's fill), and
// rows past M are not stored; a warpgroup whose 64 rows all lie past M
// issues no wgmma.  Where the row and column tiles leave SMs idle,
// ops/qmatmul.py splits din into whole stages (blockIdx.z); each split
// writes f32 partial sums [splits, M, dout] that gemv::reduce_splits adds in
// split order and scales: no atomics, so a call gives the same bits every
// time.

#include <climits>

#include "wgmma_common.cuh"

namespace {

using namespace wgmma;

constexpr int kRows = 128;   // rows of x a block takes: two m64 warpgroups (ops/qmatmul.py WGMMA_ROWS)
constexpr int kCols = 128;   // columns of y a block takes: wgmma n128 (ops/qmatmul.py WGMMA_COLS)
constexpr int kK = 64;       // din of a stage: 64 bf16, one 128-byte swizzle row (ops/qmatmul.py WGMMA_STAGE_ROWS)
constexpr int kSteps = kK / 16;  // k16 steps of a stage
constexpr int kStages = 4;   // the ring
constexpr int kProducerGroups = 2;  // warp 0: thread 0 copies; the other warps convert
constexpr int kConvertWarps = 4 * kProducerGroups - 1;
constexpr int kProducers = 128 * kProducerGroups;
constexpr int kConsumers = 256;
constexpr int kThreads = kProducers + kConsumers;
constexpr int kUnits = kK / 8;                          // a stage's units of 8 din rows
constexpr int kRowBytes = 2 * kK;                        // 128: a swizzled row
constexpr int kXBytes = kRows * kRowBytes;               // x bf16 [128, 64]
constexpr int kBBytes = kCols * kRowBytes;               // the converted bf16 [128, 64]
constexpr int kQBytes = kK * kCols;                      // q int8 [64, 128]
constexpr int kBOffset = kXBytes, kQOffset = kBOffset + kBBytes;
constexpr int kStageBytes = kQOffset + kQBytes;          // 40960, a multiple of 1024
constexpr int kBarOffset = kStages * kStageBytes;        // full, ready, empty: kStages each
constexpr int kSmemBytes = kBarOffset + 3 * kStages * 8 + 1024;  // + alignment to 1024
constexpr int kProducerRegs = kProducerGroups == 1 ? 56 : 72;
constexpr int kConsumerRegs = kProducerGroups == 1 ? 224 : 184;

static_assert(kStageBytes % 1024 == 0 && kBOffset % 1024 == 0 && kQOffset % 1024 == 0,
              "swizzled tiles start on 1024-byte boundaries");
static_assert(kSmemBytes <= 232448, "shared memory a block may opt in to");
static_assert(kProducerRegs * kProducers + kConsumerRegs * kConsumers <= 65536, "registers");

using Ring = StageRing<kStages, kStageBytes>;

// ---- the conversion

// Unit u of a stage: din rows 8u .. 8u + 7 of the int8 tile qs (kK rows of
// kCols bytes as the TMA stores them: row r's 16-byte chunk c at chunk
// c ^ r % 8) into chunk u of every column of the bf16 tile bs (column n's
// 64 din at n * kRowBytes, its chunk k8 at chunk k8 ^ n % 8).  Lane l reads
// its 32-bit word (columns 4l .. 4l + 3) of each of the 8 rows, so the warp
// reads each row whole, without a bank conflict, and writes those four
// columns' chunks, 16 bytes each, in an order turned by (l / 2) % 4: the 8
// lanes of a quarter warp then write 8 different chunk positions, no bank
// conflict either.
__device__ __forceinline__ void convert_unit(const unsigned char* qs, unsigned char* bs, int u,
                                             int lane) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)  // row 8u + i, at swizzle phase i
    w[i] = *reinterpret_cast<const uint32_t*>(qs + (8 * u + i) * kCols +
                                              (((lane >> 2) ^ i) << 4) + ((lane & 3) << 2)) ^
           gemv::kInt8Bias;
  const int turn = (lane >> 1) & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = (j + turn) & 3, n = 4 * lane + t;
    *reinterpret_cast<uint4*>(bs + n * kRowBytes + ((u ^ (n & 7)) << 4)) =
        make_uint4(gemv::int8_bf16_pair(w[0], w[1], t), gemv::int8_bf16_pair(w[2], w[3], t),
                   gemv::int8_bf16_pair(w[4], w[5], t), gemv::int8_bf16_pair(w[6], w[7], t));
  }
}

struct Args {
  const float* scale;
  __nv_bfloat16* out;
  float* partial;
  int m, din, dout, split_rows;
};

// The block's two tensor maps: x and q.
struct Maps {
  CUtensorMap x, q;
};

// What the block's threads share: its operands, din split, ring and tile.
struct Block {
  const Args& a;
  const Maps& maps;
  int kbeg, stages;  // the split: din [kbeg, kbeg + kK * stages), cut at din
  Ring ring;
  int row0, c0;

  // Stage i's two TMA copies into its slot, completing on its `full`
  // barrier: x's kK din of the block's kRows rows and q's kK rows of the
  // block's columns, both with the 128-byte swizzle.  Rows past M, columns
  // past dout and din past the weight read as zero.
  __device__ __forceinline__ void copy(int i) const {
    const int k0 = kbeg + kK * i;
    const uint32_t st = smem_u32(ring.stage(i)), full = ring.bar(ring.full, i);
    mbar_expect(full, kXBytes + kQBytes);
    tma_load_2d(st, &maps.x, k0, row0, full);
    tma_load_2d(st + kQOffset, &maps.q, c0, k0, full);
  }

  // this consumer warp is done with stage s's slot
  __device__ __forceinline__ void release(int s, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.bar(ring.empty, s));
  }
};

// Warp 0, thread 0: copies each stage as soon as the consumers have
// released its slot.
__device__ __forceinline__ void copy_stages(const Block& b) {
  for (int i = 0; i < b.stages; ++i) {
    if (i >= kStages) mbar_wait(b.ring.bar(b.ring.empty, i), b.ring.parity(i) ^ 1);
    b.copy(i);
  }
}

// Converting warp w (0 .. kConvertWarps - 1): each stage once it has landed
// (its slot's bf16 tile is free then: the copies waited for the slot's
// release), its units of the stage, then an arrival on the stage's `ready`
// barrier.
__device__ __forceinline__ void convert_stages(const Block& b, int w, int lane) {
  for (int s = 0; s < b.stages; ++s) {
    mbar_wait(b.ring.bar(b.ring.full, s), b.ring.parity(s));
    unsigned char* st = b.ring.stage(s);
    const int first = kUnits * s;
    for (int g = first + (w - first % kConvertWarps + kConvertWarps) % kConvertWarps;
         g < first + kUnits; g += kConvertWarps)
      convert_unit(st + kQOffset, st + kBOffset, g - first, lane);
    fence_proxy_async();
    mbar_arrive(b.ring.bar(b.ring.ready, s));
  }
}

// The consumer thread's place: rows 64 wg + 16 warp .. of the block (wg from
// lane 0, so that the compiler knows it, and so `live`, is the same across
// the warp), a warpgroup past M issuing no wgmma.
struct Lane {
  int wg, warp, lane, tig;
  bool live;
};

// the descriptors of stage s's x rows of this warpgroup and of its bf16 tile
__device__ __forceinline__ uint64_t desc_x(const Ring& ring, int s, int wg) {
  return sw128_desc(smem_u32(ring.stage(s) + wg * 64 * kRowBytes));
}
__device__ __forceinline__ uint64_t desc_w(const Ring& ring, int s) {
  return sw128_desc(smem_u32(ring.stage(s) + kBOffset));
}

// The warpgroup's 64 rows x kCols of the split's dot into acc: a stage's
// kSteps wgmma as one batch once it has landed and been converted; stage s
// - 1's slot released when stage s's batch is issued and s - 1's is done.
__device__ __forceinline__ void consume(const Block& b, const Lane& l, float (&acc)[64]) {
  const Ring& ring = b.ring;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int s = 0; s < b.stages; ++s) {
    const uint64_t da = desc_x(ring, s, l.wg), db = desc_w(ring, s);
    mbar_wait(ring.bar(ring.full, s), ring.parity(s));
    mbar_wait(ring.bar(ring.ready, s), ring.parity(s));
    if (l.live) {
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kSteps; ++i)  // +32 bytes a k16 step along the 128-byte rows
        wgmma_m64n128k16(acc, da + 2 * i, db + 2 * i, 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
    if (s > 0) b.release(s - 1, l.lane);
  }
  if (l.live) {
    wgmma_wait<0>();
    fence_regs(acc);
  }
}

// Rows 16 warp + lane / 4 (+ 8) of the warpgroup's 64, columns 8 j +
// 2 (lane % 4): to y scaled with one split, else to this split's partials.
__device__ __forceinline__ void store(const Args& a, const float (&acc)[64], const Lane& l,
                                      int row0, int c0) {
  const int r_lo = row0 + 64 * l.wg + 16 * l.warp + (l.lane >> 2), r_hi = r_lo + 8;
  const bool whole = gridDim.z == 1;
  float* part = a.partial + static_cast<size_t>(blockIdx.z) * a.m * a.dout;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + 2 * l.tig;
    if (col >= a.dout) continue;
    const float2 s = whole ? __ldg(reinterpret_cast<const float2*>(a.scale + col))
                           : make_float2(1.f, 1.f);
    if (r_lo < a.m) {
      const size_t at = static_cast<size_t>(r_lo) * a.dout + col;
      if (whole)
        *reinterpret_cast<uint32_t*>(a.out + at) = pack_bf16(acc[4 * j] * s.x,
                                                             acc[4 * j + 1] * s.y);
      else
        *reinterpret_cast<float2*>(part + at) = make_float2(acc[4 * j], acc[4 * j + 1]);
    }
    if (r_hi < a.m) {
      const size_t at = static_cast<size_t>(r_hi) * a.dout + col;
      if (whole)
        *reinterpret_cast<uint32_t*>(a.out + at) = pack_bf16(acc[4 * j + 2] * s.x,
                                                             acc[4 * j + 3] * s.y);
      else
        *reinterpret_cast<float2*>(part + at) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// grid (ceil(m / kRows), ceil(dout / kCols), splits): block (x, y, z) takes
// rows kRows x, columns kCols y and split z (din [z * split_rows, ...)).
// The row tiles of a column tile are neighbours in launch order, so all but
// the first read its weights from L2.
__global__ void __launch_bounds__(kThreads, 1)
    int8_wgmma_kernel(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + kBarOffset);
  const Ring ring{smem, bars, bars + 8 * kStages, bars + 16 * kStages};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(ring.full + 8 * i, 1);                    // the copy's arrival and bytes
      mbar_init(ring.ready + 8 * i, 32 * kConvertWarps);  // every converting thread
      mbar_init(ring.empty + 8 * i, kConsumers / 32);     // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int row0 = blockIdx.x * kRows, c0 = blockIdx.y * kCols;
  const int kbeg = blockIdx.z * a.split_rows;
  const int stages = (min(a.din, kbeg + a.split_rows) - kbeg + kK - 1) / kK;
  const Block b{a, maps, kbeg, stages, ring, row0, c0};
  if (threadIdx.x < kProducers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int warp = threadIdx.x >> 5;
    if (warp > 0)
      convert_stages(b, warp - 1, threadIdx.x & 31);
    else if (threadIdx.x == 0)
      copy_stages(b);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x - kProducers;
    const int wg = __shfl_sync(0xffffffffu, ct >> 7, 0);
    const Lane l{wg, (ct >> 5) & 3, ct & 31, ct & 3, row0 + 64 * wg < a.m};
    float acc[64];
    consume(b, l, acc);
    if (l.live) store(a, acc, l, row0, c0);
  }
}

cudaError_t launch(const Maps& maps, const Args& a, dim3 grid, cudaStream_t s) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  int8_wgmma_kernel<<<grid, kThreads, kSmemBytes, s>>>(maps, a);
  return cudaSuccess;
}

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/qmatmul.py.  x
// [m, din] and out [m, dout] are bf16; `partial` is an f32 workspace of
// splits * m * dout elements (unused when splits == 1).  Takes any m >= 1,
// din a multiple of 16, dout a multiple of 64, x, q and scale 16-byte
// aligned, splits of split_rows din rows (a multiple of kK) covering din,
// the last one short or whole.  Returns cudaGetLastError() after the
// launches.
extern "C" int int8_wgmma(const void* x, const void* q, const void* scale, void* out,
                          void* partial, int m, int din, int dout, int split_rows, int splits,
                          void* stream) {
  if (m < 1 || din < 16 || din % 16 != 0 || dout < 64 || dout % 64 != 0 || split_rows < kK ||
      split_rows % kK != 0 || splits < 1 || splits > 65535 ||
      static_cast<long long>(split_rows) * (splits - 1) >= din ||
      static_cast<long long>(split_rows) * splits < din ||
      static_cast<long long>(m) * dout > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scale) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kRows - 1) / kRows, (dout + kCols - 1) / kCols, splits);
  const Args a{static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(partial), m, din, dout, split_rows};
  // x [m, din] bf16 in kRows x kK tiles, q [din, dout] bytes in kK x kCols
  // tiles, both with the 128-byte swizzle
  Maps maps;
  cudaError_t err = tensor_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, din, m,
                               2 * static_cast<size_t>(din), kK, kRows,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&maps.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, dout, din, dout, kCols, kK,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) err = launch(maps, a, grid, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    gemv::launch_reduce<__nv_bfloat16>(static_cast<const float*>(partial),
                                       static_cast<const float*>(scale),
                                       static_cast<__nv_bfloat16*>(out), splits, m * dout, dout,
                                       s);
  }
  return static_cast<int>(cudaGetLastError());
}
