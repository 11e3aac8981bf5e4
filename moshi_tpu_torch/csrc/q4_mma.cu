// q4_mma: group-wise 4-bit weight-only matrix product on the tensor cores,
// for bf16 activations of a decoding batch (M = 1..16 rows), on Hopper
// (sm_90a).
//
// Replaces, beside q4_gemv.cu and q4_wgmma.cu, the Pallas TPU kernels
// moshi_tpu/ops/q4matmul.py `q4gemm` and `q4gemm_stacked` (a member of a
// stacked weight is the pointer q[l]), which take any M as one block.
// ops/q4matmul.py sends bf16 calls of MMA_MIN_BATCH..16 rows here, bf16
// calls of more rows to q4_wgmma.cu and every other call to q4_gemv.cu.
//
// Computes y[M, dout] = sum_g (x[:, g*gs:(g+1)*gs] @ w_g) * scale[g, :] in
// q4_gemv.cu's layout: q int8 [din/2, dout] of sequential-pair nibbles (byte
// (i, n) holds din 2i in its low and 2i+1 in its high nibble), scale f32
// [din/gs, 1, dout]; x and y bf16.  The tensor cores sum each group's dot in
// f32, which is then multiplied by its scale, as the TPU kernel does
// (q4matmul.py:70-75).  Nibbles in [-8, 7] and bf16 x are exact in bf16, so
// every product is exact and only the order of the f32 sums differs from the
// plain version.
//
// Rows: a block takes the batch as one 16-row tile of x (an m16 tile).
// Each weight is unpacked in registers for the tile's mma.sync; above 16
// rows that unpack would be redone per tile and set the pace, so larger M
// runs q4_wgmma.cu, which unpacks a weight once per 128 rows.
//
// What bounds it: 2*M flops per weight against 0.5 byte of packed weight and
// 4/gs bytes of scale, so at M <= 16 device-memory bandwidth.  q4_gemv.cu does
// those flops as f32 FMAs on the CUDA cores, which bounds it by arithmetic at
// B = 16; here one mma.sync.m16n8k16 does 16 rows x 8 columns x 16 din of
// them, and the CUDA cores only unpack nibbles.
//
// Fragment mapping (lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
// the PTX ISA layouts of mma.m16n8k16.row.col with bf16 operands):
//  - a warp computes 16 batch rows x 64 output columns as eight n8 tiles t;
//    fragment column n of tile t is output column c0 + 8n + t;
//  - B: register b0 of the k16 step at din k0 holds k rows k0+2tig and
//    k0+2tig+1 of fragment column gid, which are the low and the high nibble
//    of packed byte (k0/2 + tig, c0 + 8 gid + t).  One 64-bit load of
//    q[(k0/2 + tig) * dout + c0 + 8 gid] so holds b0 of all eight tiles, and
//    the one 4 packed rows below holds b1 (k + 8).  Across the warp a load
//    reads 4 rows x 64 contiguous bytes, the block's four warps 256 bytes
//    of each row.  No weight goes through shared memory;
//  - A: x is staged once per block in shared memory as bf16 [B, rows of the
//    split + 8] (the 8 of padding put the 32 lanes of a fragment load on 32
//    banks); rows gid, gid + 8 >= B are zero in registers;
//  - C: a lane holds, in rows gid and gid + 8, output columns
//    c0 + 16 tig + 8j + t (j = 0, 1; t = 0..7): 16 contiguous columns, so
//    a group's scales are four float4 loads and a row's output two 16-byte
//    stores.
// Each lane loads the packed words of the next k16 step before it works on
// this one's (kDepth steps ahead).  A split's x is staged once.  Split
// partial sums go to an f32 workspace [splits, M, dout] that
// gemv::reduce_splits adds in split order: no atomics.
//
// Chosen by measurement on the H100 (PERF.md): eight tiles per warp with
// the L2 prefetch beat four tiles with 32-bit loads, and loading one step
// ahead beat two or four steps ahead.

#include "gemv_common.cuh"

namespace {

using gemv::mma_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 8;                        // n8 tiles per warp
constexpr int kWords = kTiles / 4;               // 32-bit words a lane reads per packed row
constexpr int kWarpCols = 8 * kTiles;            // ops/q4matmul.py MMA_WARP_COLS
constexpr int kBlockCols = kWarpCols * kWarps;   // ops/q4matmul.py MMA_BLOCK_COLS
constexpr int kDepth = 1;                        // k16 steps of packed words loaded ahead
constexpr int kPad = 8;                          // bf16 padding of a staged x row
constexpr int kTileRows = 16;                    // rows of x a launch takes: one m16 tile
constexpr int kStageRows = 1024;                 // din rows a split stages: ops/q4matmul.py MAX_SPLIT_ROWS
constexpr uint32_t kBias = 0x88888888u;          // nibble v -> v ^ 8 = signed v + 8
constexpr uint32_t kBf16Pair128 = 0x43004300u;   // bf16 (128, 128)
constexpr uint32_t kBf16Pair136 = 0x43084308u;   // bf16 (136, 136)

// The lane's 8 bytes of one packed row: read once, so not kept in L1, and
// with a 256-byte L2 prefetch, so that the neighbouring warps' bytes of the
// row come from L2.
__device__ __forceinline__ void load_row(const uint32_t* p, uint32_t (&w)[kWords]) {
  static_assert(kWords == 2, "one 64-bit load per packed row");
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
      : "=r"(w[0]), "=r"(w[1]) : "l"(p));
}

// The B register of a tile from a biased packed word w (w ^ kBias) and
// w >> 4: byte `t`'s low nibble u as the low bf16 and its high nibble as
// the high one.  A nibble u in the mantissa of bf16 128 gives 128 + u
// exactly; minus 136 that is u - 8, the signed nibble.
__device__ __forceinline__ uint32_t unpack_tile(uint32_t w, uint32_t w_shifted, int t) {
  const uint32_t sel = t | (t << 4) | ((t + 4) << 8) | ((t + 4) << 12);
  uint32_t v = (__byte_perm(w, w_shifted, sel) & 0x000F000Fu) | kBf16Pair128;
  uint32_t k = kBf16Pair136;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<__nv_bfloat162*>(&k));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Stage rows [row0, row0 + rows) of x[batch, din] into xs[batch, stride], 16
// bytes at a time where x's address and din allow it.
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        __nv_bfloat16* xs, int batch, int din,
                                        int row0, int rows, int stride) {
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && din % 8 == 0) {
    const int chunks = rows / 8;
    for (int i = threadIdx.x; i < batch * chunks; i += blockDim.x) {
      const int b = i / chunks, c = i - b * chunks;
      *reinterpret_cast<uint4*>(xs + b * stride + 8 * c) = __ldg(
          reinterpret_cast<const uint4*>(x + static_cast<size_t>(b) * din + row0 + 8 * c));
    }
  } else {
    for (int i = threadIdx.x; i < batch * rows; i += blockDim.x) {
      const int b = i / rows, r = i - b * rows;
      xs[b * stride + r] = x[static_cast<size_t>(b) * din + row0 + r];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One row of the output (or of this split's partial sums): the lane's
// 2 * kTiles contiguous columns, index kTiles * j + t = acc[t][j0 + j].
__device__ __forceinline__ void store_row(const float (&acc)[kTiles][4], int j0,
                                          __nv_bfloat16* out, float* part) {
  float v[2 * kTiles];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < kTiles; ++t) v[kTiles * j + t] = acc[t][j0 + j];
  if (out != nullptr) {
#pragma unroll
    for (int i = 0; i < kTiles / 4; ++i)
      reinterpret_cast<uint4*>(out)[i] = make_uint4(
          pack_bf16(v[8 * i], v[8 * i + 1]), pack_bf16(v[8 * i + 2], v[8 * i + 3]),
          pack_bf16(v[8 * i + 4], v[8 * i + 5]), pack_bf16(v[8 * i + 6], v[8 * i + 7]));
  } else {
#pragma unroll
    for (int i = 0; i < kTiles / 2; ++i)
      reinterpret_cast<float4*>(part)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// The mma loop over `rows` staged din rows starting at group g0 (whole
// groups): acc += the group-scaled products of x's staged rows (xs, row
// stride `stride`; rows gid and gid + 8 where lo_row / hi_row) with this
// warp's kWarpCols columns from c0.  gacc holds the open group's f32 sums
// and is zero again on return.
__device__ __forceinline__ void mma_rows(float (&acc)[kTiles][4], float (&gacc)[kTiles][4],
                                         const __nv_bfloat16* xs, int stride,
                                         const uint32_t* __restrict__ q,
                                         const float* __restrict__ scale, int g0, int rows,
                                         int gs, int dout, int c0, int gid, int tig,
                                         bool lo_row, bool hi_row) {
  // this lane's words of packed row r start at q[r * words + (c0 + kTiles gid) / 4]
  const size_t words = dout / 4;
  const uint32_t* qp =
      q + (static_cast<size_t>(g0) * gs / 2 + tig) * words + (c0 + kTiles * gid) / 4;
  const size_t step_words = 8 * words;  // a k16 step is 8 packed rows
  const size_t b1_words = 4 * words;    // b1: 4 packed rows below b0
  const int nsteps = rows / 16;
  const int ng = rows / gs;

  uint32_t ring[kDepth][2][kWords];
#pragma unroll
  for (int i = 0; i < kDepth; ++i) {
    if (i < nsteps) {
      load_row(qp + i * step_words, ring[i][0]);
      load_row(qp + i * step_words + b1_words, ring[i][1]);
    }
  }

  const uint32_t* xlo = reinterpret_cast<const uint32_t*>(xs + gid * stride) + tig;
  const uint32_t* xhi = reinterpret_cast<const uint32_t*>(xs + (gid + 8) * stride) + tig;

  // the lane's 2 * kTiles scale columns, c0 + 2 kTiles tig + ...
  const float4* sp =
      reinterpret_cast<const float4*>(scale + static_cast<size_t>(g0) * dout + c0 + 2 * kTiles * tig);
  float4 sc4[kTiles / 2];
#pragma unroll
  for (int i = 0; i < kTiles / 2; ++i) sc4[i] = __ldg(sp + i);

  const int steps_per_group = gs / 16;
  int left = steps_per_group;  // steps left in the current group
  int g = 0;                   // the current group, within the rows
  for (int s0 = 0; s0 < nsteps; s0 += kDepth) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int s = s0 + i;
      if (s < nsteps) {
        uint32_t w0[kWords], w1[kWords];
#pragma unroll
        for (int u = 0; u < kWords; ++u) {
          w0[u] = ring[i][0][u] ^ kBias;
          w1[u] = ring[i][1][u] ^ kBias;
        }
        if (s + kDepth < nsteps) {
          load_row(qp + (s + kDepth) * step_words, ring[i][0]);
          load_row(qp + (s + kDepth) * step_words + b1_words, ring[i][1]);
        }
        const uint32_t a[4] = {lo_row ? xlo[8 * s] : 0u, hi_row ? xhi[8 * s] : 0u,
                               lo_row ? xlo[8 * s + 4] : 0u, hi_row ? xhi[8 * s + 4] : 0u};
#pragma unroll
        for (int t = 0; t < kTiles; ++t) {
          const uint32_t u0 = w0[t / 4], u1 = w1[t / 4];
          mma_bf16(gacc[t], a, unpack_tile(u0, u0 >> 4, t % 4),
                   unpack_tile(u1, u1 >> 4, t % 4));
        }
        if (--left == 0) {
          // the group's scale: column index kTiles * j + t of the lane's
          const float* sc = reinterpret_cast<const float*>(sc4);
#pragma unroll
          for (int t = 0; t < kTiles; ++t)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              acc[t][j] = fmaf(gacc[t][j], sc[kTiles * j + t], acc[t][j]);
              acc[t][2 + j] = fmaf(gacc[t][2 + j], sc[kTiles * j + t], acc[t][2 + j]);
              gacc[t][j] = gacc[t][2 + j] = 0.f;
            }
          left = steps_per_group;
          if (++g < ng) {
            sp += dout / 4;
#pragma unroll
            for (int k = 0; k < kTiles / 2; ++k) sc4[k] = __ldg(sp + k);
          }
        }
      }
    }
  }
}

// Rows gid and gid + 8 of the lane's columns: to y with one split, else to
// this split's partial sums partial[s, row, col] (m rows).
__device__ __forceinline__ void store_rows(const float (&acc)[kTiles][4], int m, int dout,
                                           int c0, int gid, int tig, bool lo_row, bool hi_row,
                                           __nv_bfloat16* out, float* partial) {
  const int col = c0 + 2 * kTiles * tig;
  const bool whole = gridDim.y == 1;
  float* part = partial + static_cast<size_t>(blockIdx.y) * m * dout;
  if (lo_row) {
    const size_t at = static_cast<size_t>(gid) * dout + col;
    store_row(acc, 0, whole ? out + at : nullptr, part + at);
  }
  if (hi_row) {
    const size_t at = static_cast<size_t>(gid + 8) * dout + col;
    store_row(acc, 2, whole ? out + at : nullptr, part + at);
  }
}

// A decoding batch (batch <= kTileRows rows, one m16 tile): grid
// (ceil(dout / kBlockCols), splits); split s covers groups
// [s * groups_per_split, ...), at most kStageRows din rows, staged once.
__global__ void __launch_bounds__(kThreads) q4_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
    float* __restrict__ partial, int batch, int din, int dout, int gs,
    int groups_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [batch, rows + kPad]
  const int g0 = blockIdx.y * groups_per_split;
  const int ng = min(groups_per_split, din / gs - g0);
  const int rows = ng * gs;
  const int stride = rows + kPad;
  stage_x(x, xs, batch, din, g0 * gs, rows, stride);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * kBlockCols + warp * kWarpCols;
  if (c0 >= dout) return;  // a whole warp: mma.sync needs every lane

  const bool lo_row = gid < batch, hi_row = gid + 8 < batch;
  float acc[kTiles][4], gacc[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = gacc[t][c] = 0.f;
  mma_rows(acc, gacc, xs, stride, q, scale, g0, rows, gs, dout, c0, gid, tig, lo_row, hi_row);
  store_rows(acc, batch, dout, c0, gid, tig, lo_row, hi_row, out, partial);
}

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/q4matmul.py.  x
// [m, din] and out [m, dout] are bf16; `partial` is an f32 workspace of
// splits * m * dout elements (unused when splits == 1).  Takes m = 1..16,
// group_size a multiple of 16 up to kStageRows, a split of at most
// kStageRows din rows, dout a multiple of 64, q 8-byte and scale 16-byte
// aligned.  Returns cudaGetLastError() after the launches.
extern "C" int q4_mma(const void* x, const void* q, const void* scale, void* out,
                      void* partial, int m, int din, int dout, int group_size,
                      int groups_per_split, int splits, void* stream) {
  if (m < 1 || m > kTileRows || group_size % 16 != 0 || group_size > kStageRows ||
      dout % kWarpCols != 0 || splits < 1 || splits > 65535 || groups_per_split < 1 ||
      groups_per_split * group_size > kStageRows ||
      reinterpret_cast<uintptr_t>(q) % 8 != 0 || reinterpret_cast<uintptr_t>(scale) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(__nv_bfloat16) * m * (groups_per_split * group_size + kPad);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((dout + kBlockCols - 1) / kBlockCols, splits);
  q4_mma_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), m, din, dout, group_size, groups_per_split);
  if (splits > 1) {
    gemv::launch_reduce<__nv_bfloat16>(static_cast<const float*>(partial), nullptr,
                                       static_cast<__nv_bfloat16*>(out), splits,
                                       m * dout, dout, s);
  }
  return static_cast<int>(cudaGetLastError());
}
