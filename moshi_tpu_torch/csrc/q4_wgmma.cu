// q4_wgmma: group-wise 4-bit weight-only matrix product for bf16 x of many
// rows (the offline forward's M = B * T), on Hopper (sm_90a) with wgmma.
//
// Replaces, for bf16 x of more than 16 rows, the Pallas TPU kernels
// moshi_tpu/ops/q4matmul.py `q4gemm` (:83) and `q4gemm_stacked` (:144; a
// member of a stacked weight is the pointer q[l]).  ops/q4matmul.py sends
// bf16 calls of M > 16 rows here; q4_mma.cu keeps the decoding batch (2..16
// rows), q4_gemv.cu one row and f32.
//
// Computes y[M, dout] = sum_g (x[:, g*gs:(g+1)*gs] @ w_g) * scale[g, :] in
// q4_gemv.cu's layout: q int8 [din/2, dout] of sequential-pair nibbles (byte
// (i, n) holds din 2i in its low and 2i+1 in its high nibble), scale f32
// [din/gs, 1, dout]; x and y bf16.  The tensor cores sum each group's dot in
// f32, which is then multiplied by the group's f32 scale (post-dot scaling,
// as the TPU kernel does, q4matmul.py:56-80).  Nibbles in [-8, 7] and bf16 x
// are exact in bf16, so every product is exact and only the order of the f32
// sums differs from the plain version.
//
// What bounds it: 2*M flops per weight against 0.5 byte of packed weight and
// 4/gs bytes of scale.  At M = 256 that is the tensor cores (the 129
// launches of one Moshi-7B forward: 3.47 ms of flops at 989 TFLOP/s against
// 1.25 ms of bytes), at M <= 64 device memory.  q4_mma.cu takes 16 rows a
// block and so unpacks every weight once per 16 rows, and the unpack, not
// its mma.sync, sets its pace above a decoding batch.  Here a block takes
// kRows = 128 rows, so each weight is unpacked once per 128 rows, into
// shared memory, where wgmma (the only way to the full tensor-core rate)
// reads it.  Two costs remain beside the tensor cores': the unpack, and the
// group scale, an FMA per accumulator every gs / 16 k16 steps (at gs = 32,
// half the tensor cores' time on the CUDA cores).  The design gives the
// unpack warps of its own and keeps both off the copies' path; on the H100
// the unpack warps set the pace (PERF.md, scripts/time_q4_wgmma_variants.py).
//
// The design (a block computes kRows x kCols of y; 384 threads):
//  - warpgroup 0 produces.  Its thread 0 keeps a ring of kStages stages in
//    flight with three TMA copies a stage: kK = 64 din of x bf16 [128, 64]
//    and of packed q [32, kCols], both stored with the 128-byte swizzle,
//    and the f32 scale rows of the groups that end in the stage; they
//    complete on the stage's `full` mbarrier.  Its warps 1-3 unpack a landed
//    stage's packed tile, once, into the stage's bf16 [kCols, 64] tile of
//    the raw nibbles (-8..7, exact), K-major with the 128-byte swizzle (one
//    128-byte row per column), and arrive on its `ready` mbarrier after
//    fence.proxy.async.  The copies wait for a free slot only, the unpack
//    for the copies only.  (Measured slower: the copies issued by an
//    unpacking thread, or by the last consumer warp to free a slot, and the
//    unpack done by the consumer warps under their wgmma; PERF.md);
//  - warpgroups 1 and 2 consume, 64 rows of x each, independently of each
//    other: x lies in the same swizzled K-major layout as the bf16 tile, so
//    wgmma.m64n128k16 takes both operands from shared memory by
//    descriptor.  A group takes gs / 16 k16 steps into a group accumulator
//    (its first with scale-d = 0), then wgmma.wait_group and an FMA by the
//    lane's column scales into the main accumulator (64 + 64 f32 registers
//    a thread).  A group may straddle two stages where gs does not divide
//    kK;
//  - each consumer warp arrives on a stage's `empty` mbarrier once its
//    wgmma have read the stage and its scale rows are used, and the
//    producer refills the slot.
// The unpack's lanes read the swizzled packed tile and write the bf16 tile
// without a bank conflict (unpack_unit).
//
// Rows past M are zero in x (the TMA's fill) and are not stored; a
// warpgroup whose 64 rows all lie past M issues no wgmma.  Where the row
// and column tiles leave SMs idle, ops/q4matmul.py splits din into whole
// groups (blockIdx.z); each split writes f32 partial sums [splits, M, dout]
// that gemv::reduce_splits adds in split order: no atomics, so a call gives
// the same bits every time.

#include <climits>

#include "wgmma_common.cuh"

namespace {

using namespace wgmma;

constexpr int kRows = 128;   // rows of x a block takes: two m64 warpgroups (ops/q4matmul.py WGMMA_ROWS)
constexpr int kCols = 128;   // columns of y a block takes: wgmma n128 (ops/q4matmul.py WGMMA_COLS)
constexpr int kK = 64;       // din of a stage: 64 bf16, one 128-byte swizzle row
constexpr int kSteps = kK / 16;  // k16 steps of a stage
constexpr int kStages = 4;   // the ring
constexpr int kThreads = 384;
constexpr int kProducers = 128;  // warp 0: thread 0 copies; warps 1-3 unpack
constexpr int kUnpackWarps = 3;
constexpr int kConsumers = 256;
constexpr int kRowBytes = 2 * kK;                        // 128: a swizzled row
constexpr int kXBytes = kRows * kRowBytes;               // x bf16 [128, 64]
constexpr int kBBytes = kCols * kRowBytes;               // the unpacked bf16 [128, 64]
constexpr int kQBytes = kK / 2 * kCols;                  // packed q [32, 128]
constexpr int kScaleRows = kSteps;                       // groups ending in a stage, at most
constexpr int kSBytes = kScaleRows * kCols * 4;          // their f32 scale rows
constexpr int kBOffset = kXBytes, kQOffset = kBOffset + kBBytes, kSOffset = kQOffset + kQBytes;
constexpr int kStageBytes = kSOffset + kSBytes;          // 38912, a multiple of 1024
constexpr int kBarOffset = kStages * kStageBytes;        // full, ready, empty: kStages each
constexpr int kSmemBytes = kBarOffset + 3 * kStages * 8 + 1024;  // + alignment to 1024
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// bf16 (136, 136).  A nibble n (two's complement v) XORed into bf16 136's
// low mantissa bits gives 128 + (n ^ 8) = 136 + v exactly.
constexpr uint32_t kBf16Pair136 = 0x43084308u;

static_assert(kStageBytes % 1024 == 0 && kBOffset % 1024 == 0 && kQOffset % 1024 == 0,
              "swizzled tiles start on 1024-byte boundaries");
static_assert(kProducerRegs * kProducers + kConsumerRegs * kConsumers <= 65536, "registers");

// ---- the unpack

// The selector of nibble_pair for byte t: bytes t, t, t + 4, t + 4.
__device__ __forceinline__ uint32_t byte_selector(int t) { return 0x1111u * t + 0x4400u; }

// bf16 pair (low nibble, high nibble) of byte t of a packed word w (ws =
// w >> 4; sel = byte_selector(t)): each nibble XORed into bf16 136 gives
// 136 + v, minus 136 the signed nibble v.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t ws, uint32_t sel) {
  uint32_t v = (__byte_perm(w, ws, sel) & 0x000F000Fu) ^ kBf16Pair136;
  uint32_t k = kBf16Pair136;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<__nv_bfloat162*>(&k));
  return *reinterpret_cast<uint32_t*>(&r);
}

// One eighth of a stage's packed tile qs (32 packed rows of kCols bytes, as
// the TMA stores them: chunk c of row r at chunk c ^ r % 8) into the bf16
// tile bs (column n's 64 din at n * 128, its 16-byte chunk k8 at chunk
// k8 ^ n % 8).  Unit u takes columns 64 (u % 2) .. + 63 and the din chunks
// k8 = 2 (u / 2), + 1.  Lane l reads the 4 packed rows of chunk
// k8 = 2 (u / 2) + l % 2 in one 32-bit column word (columns 4 cw .. 4 cw + 3,
// cw = 16 (u % 2) + l / 2) and writes those 4 columns' k8 chunks, in an
// order turned by 2 for every other pair of words: so neither the warp's
// reads nor a quarter warp's 16-byte writes meet a bank conflict.
__device__ __forceinline__ void unpack_unit(const unsigned char* qs, unsigned char* bs, int u,
                                            int lane) {
  const int k8 = 2 * (u >> 1) + (lane & 1);
  const int cwl = lane >> 1, cw = 16 * (u & 1) + cwl;
  uint32_t w[4], ws[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * k8 + i;
    w[i] = *reinterpret_cast<const uint32_t*>(qs + r * kCols + ((((cw >> 2) ^ (r & 7))) << 4) +
                                              ((cw & 3) << 2));
    ws[i] = w[i] >> 4;
  }
  const int turn = 2 * ((cwl >> 1) & 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = (j + turn) & 3, n = 4 * cw + t;
    const uint32_t sel = byte_selector(t);
    *reinterpret_cast<uint4*>(bs + n * kRowBytes + ((k8 ^ (n & 7)) << 4)) =
        make_uint4(nibble_pair(w[0], ws[0], sel), nibble_pair(w[1], ws[1], sel),
                   nibble_pair(w[2], ws[2], sel), nibble_pair(w[3], ws[3], sel));
  }
}

// acc += g * the lane's column scales (ss: the group's kCols f32 scales)
__device__ __forceinline__ void scale_group(float (&acc)[64], const float (&g)[64],
                                            const float* ss, int tig) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(ss + 8 * j + 2 * tig);
    acc[4 * j] = fmaf(g[4 * j], s.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(g[4 * j + 1], s.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(g[4 * j + 2], s.x, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(g[4 * j + 3], s.y, acc[4 * j + 3]);
  }
}

struct Args {
  const __nv_bfloat16* x;
  const unsigned char* q;
  const float* scale;
  __nv_bfloat16* out;
  float* partial;
  int m, din, dout, gs, groups_per_split;
};

// This block's split: din [kbeg, kend), steps (k16) counted from kbeg,
// groups from g0 = kbeg / gs.
struct Split {
  int kbeg, steps, stages, g0;
};

__device__ __forceinline__ Split this_split(const Args& a) {
  const int kbeg = blockIdx.z * a.groups_per_split * a.gs;
  const int kend = min(a.din, kbeg + a.groups_per_split * a.gs);
  const int steps = (kend - kbeg) / 16;
  return {kbeg, steps, (steps + kSteps - 1) / kSteps, kbeg / a.gs};
}

// The block's shared memory and barriers (mbarrier addresses).
using Ring = StageRing<kStages, kStageBytes>;

// The block's three tensor maps: x, packed q and the scales.
struct Maps {
  CUtensorMap x, q, scale;
};

// What the block's threads share: its operands, split, ring and tile.
struct Block {
  const Args& a;
  const Maps& maps;
  Split sp;
  Ring ring;
  int row0, c0;

  // Stage i's copies into its slot: three TMA copies that complete on the
  // stage's `full` barrier: x's 64 din of the block's kRows rows, q's 32
  // packed rows of the block's columns (both with the
  // 128-byte swizzle), and the scale rows of the kScaleRows groups from the
  // first that ends in the stage.  Rows past M, columns past dout and rows
  // past the tensors' ends read as zero.
  __device__ __forceinline__ void copy(int i) const {
    const int k0 = sp.kbeg + kK * i;
    const uint32_t st = smem_u32(ring.stage(i)), full = ring.bar(ring.full, i);
    mbar_expect(full, kXBytes + kQBytes + kSBytes);
    tma_load_2d(st, &maps.x, k0, row0, full);
    tma_load_2d(st + kQOffset, &maps.q, c0, k0 / 2, full);
    tma_load_2d(st + kSOffset, &maps.scale, c0, sp.g0 + i * kSteps / (a.gs / 16), full);
  }

  // this consumer warp is done with stage s's slot
  __device__ __forceinline__ void release(int s, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.bar(ring.empty, s));
  }
};

// Warpgroup 0, thread 0: copies each stage as soon as the consumers have
// released its slot.
__device__ __forceinline__ void copy_stages(const Block& b) {
  for (int i = 0; i < b.sp.stages; ++i) {
    if (i >= kStages) mbar_wait(b.ring.bar(b.ring.empty, i), b.ring.parity(i) ^ 1);
    b.copy(i);
  }
}

// Warpgroup 0, warps 1-3: unpack each stage once it has landed (its slot's
// bf16 tile is free then: the copies waited for the slot's release), units
// w, w + kUnpackWarps, .. of the eight for unpack warp w, and arrive on its
// `ready` barrier.
__device__ __forceinline__ void unpack_stages(const Block& b, int u) {
  for (int i = 0; i < b.sp.stages; ++i) {
    mbar_wait(b.ring.bar(b.ring.full, i), b.ring.parity(i));
    unsigned char* st = b.ring.stage(i);
    for (int unit = u >> 5; unit < 8; unit += kUnpackWarps)
      unpack_unit(st + kQOffset, st + kBOffset, unit, u & 31);
    fence_proxy_async();
    mbar_arrive(b.ring.bar(b.ring.ready, i));
  }
}

// The consumer thread's place: rows 64 wg .. of the block (wg from lane 0,
// so that the compiler knows it, and so `live`, is the same across the
// warp), a warpgroup past M issuing no wgmma.
struct Lane {
  int wg, lane, tig;
  bool live;
};

// the descriptors of stage s's x rows of this warpgroup and of its bf16 tile
__device__ __forceinline__ uint64_t desc_x(const Ring& ring, int s, int wg) {
  return sw128_desc(smem_u32(ring.stage(s) + wg * 64 * kRowBytes));
}
__device__ __forceinline__ uint64_t desc_w(const Ring& ring, int s) {
  return sw128_desc(smem_u32(ring.stage(s) + kBOffset));
}
__device__ __forceinline__ const float* scales(const Ring& ring, int s) {
  return reinterpret_cast<const float*>(ring.stage(s) + kSOffset);
}

// stage s landed (its x by TMA) and unpacked
__device__ __forceinline__ void wait_stage(const Ring& ring, int s) {
  mbar_wait(ring.bar(ring.full, s), ring.parity(s));
  mbar_wait(ring.bar(ring.ready, s), ring.parity(s));
}

// Group sizes that tile a stage: G = kSteps / spg groups a stage (4, 2, 1
// for gs = 16, 32, 64), each issued as one batch of spg wgmma, waited for
// and scaled, the loop over a stage's groups unrolled at compile time (a
// run-time segment loop, as in Segmented, measured 24% slower).
template <int G>
struct Grouped {
  static constexpr int kSpg = kSteps / G;
  float acc[64], g0[64];

  __device__ __forceinline__ void run(const Block& b, const Lane& l) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = g0[i] = 0.f;
    for (int s = 0; s < b.sp.stages; ++s) {
      const int groups = min(kSteps, b.sp.steps - s * kSteps) / kSpg;
      const uint64_t da = desc_x(b.ring, s, l.wg), db = desc_w(b.ring, s);
      wait_stage(b.ring, s);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < groups && l.live) {
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < kSpg; ++i)  // +32 bytes a k16 step along the 128-byte rows
            wgmma_m64n128k16(g0, da + 2 * (j * kSpg + i), db + 2 * (j * kSpg + i), i);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(g0);
          scale_group(acc, g0, scales(b.ring, s) + j * kCols, l.tig);
        }
      }
      b.release(s, l.lane);
    }
  }
};

// Any group size (a multiple of 16): a stage's steps go in segments that end
// where a group or the stage ends, each one unbroken batch of wgmma; a
// group is waited for and scaled when it ends, a stage released when its
// last segment is done.
struct Segmented {
  float acc[64], g0[64];

  __device__ __forceinline__ void run(const Block& b, const Lane& l) {
    const Ring& ring = b.ring;
    const Split& sp = b.sp;
    const int gs = b.a.gs;
    const int spg = gs / 16;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = g0[i] = 0.f;
    int in_group = 0, g = 0;  // steps of the open group issued; its index in the split
    for (int s = 0; s < sp.stages; ++s) {
      const int steps = min(kSteps, sp.steps - s * kSteps);
      const uint64_t da = desc_x(ring, s, l.wg), db = desc_w(ring, s);
      const int gfirst = s * kSteps / spg;
      wait_stage(ring, s);
      for (int kk = 0; kk < steps;) {
        const int seg = min(steps - kk, spg - in_group);
        if (l.live) {
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < kSteps; ++i)
            if (i < seg) wgmma_m64n128k16(g0, da + 2 * (kk + i), db + 2 * (kk + i), in_group + i);
          wgmma_commit();
        }
        kk += seg;
        in_group += seg;
        if (in_group == spg) {
          if (l.live) {
            wgmma_wait<0>();
            fence_regs(g0);
            scale_group(acc, g0, scales(ring, s) + (g - gfirst) * kCols, l.tig);
          }
          in_group = 0;
          ++g;
        }
      }
      if (l.live) {
        wgmma_wait<0>();  // a group that goes on into the next stage: this stage read
        fence_regs(g0);
      }
      b.release(s, l.lane);
    }
  }
};

// Rows 16 (warp % 4) + lane / 4 (+ 8) of the warpgroup's 64, columns
// 8 j + 2 (lane % 4): to y with one split, else to this split's partials.
__device__ __forceinline__ void store(const Args& a, const float (&acc)[64], const Lane& l,
                                      int ct, int row0, int c0) {
  const int r_lo = row0 + 64 * l.wg + 16 * ((ct >> 5) & 3) + (l.lane >> 2), r_hi = r_lo + 8;
  const bool whole = gridDim.z == 1;
  float* part = a.partial + static_cast<size_t>(blockIdx.z) * a.m * a.dout;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + 2 * l.tig;
    if (col >= a.dout) continue;
    if (r_lo < a.m) {
      const size_t at = static_cast<size_t>(r_lo) * a.dout + col;
      if (whole)
        *reinterpret_cast<uint32_t*>(a.out + at) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
      else
        *reinterpret_cast<float2*>(part + at) = make_float2(acc[4 * j], acc[4 * j + 1]);
    }
    if (r_hi < a.m) {
      const size_t at = static_cast<size_t>(r_hi) * a.dout + col;
      if (whole)
        *reinterpret_cast<uint32_t*>(a.out + at) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      else
        *reinterpret_cast<float2*>(part + at) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// grid (ceil(m / kRows), ceil(dout / kCols), splits): block (x, y, z) takes
// rows kRows x, columns kCols y and split z (din [z * gps * gs, ...)).  The
// row tiles of a column tile are neighbours in launch order, so all but the
// first read its packed weights from L2.  G: groups a stage (Grouped<G>),
// 0 for any group size (Segmented).
template <int G>
__global__ void __launch_bounds__(kThreads, 1)
    q4_wgmma_kernel(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + kBarOffset);
  const Ring ring{smem, bars, bars + 8 * kStages, bars + 16 * kStages};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(ring.full + 8 * i, 1);                   // the copy's arrival and bytes
      mbar_init(ring.ready + 8 * i, 32 * kUnpackWarps);  // every unpacker
      mbar_init(ring.empty + 8 * i, kConsumers / 32);    // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int row0 = blockIdx.x * kRows, c0 = blockIdx.y * kCols;
  const Block b{a, maps, this_split(a), ring, row0, c0};
  if (threadIdx.x < kProducers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32)
      unpack_stages(b, threadIdx.x - 32);
    else if (threadIdx.x == 0)
      copy_stages(b);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x - kProducers;
    const int wg = __shfl_sync(0xffffffffu, ct >> 7, 0);
    const Lane l{wg, ct & 31, ct & 3, row0 + 64 * wg < a.m};
    if constexpr (G > 0) {
      Grouped<G> c;
      c.run(b, l);
      if (l.live) store(a, c.acc, l, ct, row0, c0);
    } else {
      Segmented c;
      c.run(b, l);
      if (l.live) store(a, c.acc, l, ct, row0, c0);
    }
  }
}

template <int G>
cudaError_t launch(const Maps& maps, const Args& a, dim3 grid, cudaStream_t s) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        q4_wgmma_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  q4_wgmma_kernel<G><<<grid, kThreads, kSmemBytes, s>>>(maps, a);
  return cudaSuccess;
}

// x [m, din] bf16 in kRows x kK tiles, q [din/2, dout] bytes in
// 32 x kCols tiles, both with the 128-byte swizzle; scale [din/gs, dout]
// f32 in kScaleRows x kCols tiles.
cudaError_t tensor_maps(Maps* maps, const void* x, const void* q, const void* scale, int m,
                        int din, int dout, int group_size) {
  cudaError_t err = tensor_map(&maps->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, din, m,
                               2 * static_cast<size_t>(din), kK, kRows,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&maps->q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, dout, din / 2, dout, kCols,
                     kK / 2, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&maps->scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, dout,
                     din / group_size, 4 * static_cast<size_t>(dout), kCols, kScaleRows,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  return err;
}

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/q4matmul.py.  x
// [m, din] and out [m, dout] are bf16; `partial` is an f32 workspace of
// splits * m * dout elements (unused when splits == 1).  Takes any m >= 1,
// group_size a multiple of 16 dividing din, dout a multiple of 64, x, q and
// scale 16-byte aligned, splits of groups_per_split whole groups covering
// din.  Returns cudaGetLastError() after the launches.
extern "C" int q4_wgmma(const void* x, const void* q, const void* scale, void* out,
                        void* partial, int m, int din, int dout, int group_size,
                        int groups_per_split, int splits, void* stream) {
  const long long groups = group_size > 0 ? din / group_size : 0;
  if (m < 1 || din < 1 || group_size < 16 || group_size % 16 != 0 || din % group_size != 0 ||
      dout < 64 || dout % 64 != 0 || groups_per_split < 1 || splits < 1 || splits > 65535 ||
      static_cast<long long>(groups_per_split) * (splits - 1) >= groups ||
      static_cast<long long>(groups_per_split) * splits < groups ||
      static_cast<long long>(m) * dout > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scale) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kRows - 1) / kRows, (dout + kCols - 1) / kCols, splits);
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(q),
               static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(partial), m, din, dout, group_size, groups_per_split};
  Maps maps;
  cudaError_t err = tensor_maps(&maps, x, q, scale, m, din, dout, group_size);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = group_size == 16   ? launch<4>(maps, a, grid, s)
        : group_size == 32 ? launch<2>(maps, a, grid, s)
        : group_size == 64 ? launch<1>(maps, a, grid, s)
                           : launch<0>(maps, a, grid, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    gemv::launch_reduce<__nv_bfloat16>(static_cast<const float*>(partial), nullptr,
                                       static_cast<__nv_bfloat16*>(out), splits, m * dout,
                                       dout, s);
  }
  return static_cast<int>(cudaGetLastError());
}
