// q4_gemv: group-wise 4-bit weight-only GEMV on the CUDA cores, for Hopper
// (sm_90a).
//
// Replaces, beside q4_mma.cu and q4_wgmma.cu, the Pallas TPU kernels
// moshi_tpu/ops/q4matmul.py `q4gemm` and `q4gemm_stacked`.  The stacked
// variant existed because XLA copies a dynamic slice of a stacked weight
// before a Pallas call; here member l of a contiguous [L, din/2, dout] stack
// is a pointer offset, so one kernel serves both.  ops/q4matmul.py sends
// here one bf16 row (the B = 1 frame: all 129 q4 linears of Moshi-7B), f32
// x (16 rows a launch) and shapes the tensor-core kernels do not take.
//
// Computes y[B, dout] = sum_g (x[:, g*gs:(g+1)*gs] @ w_g) * scale[g, :]:
//   q     int8 [din/2, dout], sequential-pair nibbles: byte (i, n) holds din
//         position 2i in the low nibble and 2i+1 in the high nibble, each a
//         signed value in [-7, 7] (moshi_tpu/utils/quantize.py:225-239);
//   scale f32 [din/gs, 1, dout]; group g covers din [g*gs, (g+1)*gs);
//   x     [B, din] bf16 or f32; y has x's dtype.
// Each group is summed in f32 and then multiplied by its scale, as the TPU
// kernel does (q4matmul.py:70-75).
//
// What bounds it: 2*B flops per weight against 0.5 byte of packed weight
// and 4/gs bytes of scale, 0.625 * din bytes per output column at gs = 32:
// at B = 1 device-memory bandwidth (a Moshi-7B frame's 129 launches read
// 4.19 GB, 1.25 ms at 3.35 TB/s).  The design is gemv_common.cuh's (a
// lane's `cols` columns, 16 at B = 1, one 16-byte load per packed row;
// warps over din slices in whole groups, a cluster over din, the sums added
// in distributed shared memory; one launch, no workspace).
//
// Unpacking, exact, in few instructions: a nibble n at bit 4p (p = 0..3) of
// a 16-bit half h of a word becomes the f32 2^23 + 16^p (n ^ 8) by one LOP3,
// (h & 0xF << 4p) ^ (0x4B000000 | 0x8 << 4p), and one FADD of -(2^23 + 8 *
// 16^p) leaves 16^p v exactly (v = (n ^ 8) - 8, the signed nibble; 16^3 * 15
// < 2^23).  The high half takes one shift a word.  I2F (a quarter-rate
// instruction) is not used.  The powers of 16 are taken out without a
// multiply: x's odd din rows (the high nibbles) are staged divided by 16, so
// a column at an even byte of its word sums the true products and a column
// at an odd byte 256 times them (both exact: powers of two), and a group's
// sum is multiplied by its scale times 1 or 2^-8.  So ~3 instructions a
// weight at B = 1 (LOP3, FADD, FFMA): ~0.7 ms of the 132 SMs' issue for a
// frame's 6.7e9 weights at one instruction a cycle; measured alone (the
// copies dropped) the frame's arithmetic takes 1.8 ms and the copies 2.1,
// together 2.6 (PERF.md).

#include "gemv_common.cuh"

namespace {

using gemv::Args;
using gemv::Vec;

// Two f32 sums a column (the group's and the total) and the x values of a
// packed row: a lane owns at most a quarter of gemv::kMaxAcc columns x rows
// (16 columns at one row, 8 at two, 4 above; at 2 x 16 ptxas spilled); and
// above 8 rows of x, packed rows are summed two at a time.
constexpr int kMaxAcc = gemv::kMaxAcc / 4;
__host__ __device__ constexpr int batch_rows(int nb) { return nb > 8 ? 2 : gemv::kBatchRows; }
// a warp's ring in shared memory: stages of batch_rows packed rows of 32 * c
// bytes
__host__ __device__ constexpr int stage_bytes(int nb, int c) { return batch_rows(nb) * 32 * c; }
__host__ __device__ constexpr int ring_bytes(int nb, int c) {
  return gemv::stages(stage_bytes(nb, c)) * stage_bytes(nb, c);
}

// nibble P of the 16-bit half h (bits 4P..4P+3, the rest masked): 16^P v.
// (h & mask) ^ key is one LOP3 (table 0x6A) with the mask as its immediate
// and the key in a register; written as C, ptxas emits an AND and an XOR,
// as an instruction takes one 32-bit immediate.
template <int P>
__device__ __forceinline__ float nibble(uint32_t h, uint32_t key) {
  constexpr uint32_t kMask = 0xFu << (4 * P);
  constexpr float kSub = 8388608.0f + 8.0f * static_cast<float>(1 << (4 * P));
  uint32_t f;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(f) : "r"(h), "n"(kMask), "r"(key));
  return __uint_as_float(f) - kSub;
}

// the keys of nibbles 0..3: 0x4B000000 | 0x8 << 4P, kept in registers
struct Keys {
  uint32_t k[4];
};

// The lane's C scales of group g, times 2^-8 at the columns of odd bytes
// (whose sums are 256 times the true ones).
template <int C>
__device__ __forceinline__ void load_scales(float (&s)[C], const float* sc, size_t dout, int g) {
#pragma unroll
  for (int k = 0; k < C / 4; ++k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(sc + g * dout) + k);
    s[4 * k] = v.x;
    s[4 * k + 1] = v.y * 0.00390625f;
    s[4 * k + 2] = v.z;
    s[4 * k + 3] = v.w * 0.00390625f;
  }
}

// gacc[b][c] += the packed rows [0, n) of the lane's stage st (row j's C
// bytes at st + 32 C j; din 2i and 2i + 1 of each) against x; xr is x's
// column of the batch's first din row in the staged [NB, ld] x.  kWhole: n
// == R, with no test per row (a group of a multiple of R packed rows, every
// batch at gs = 32), so the compiler schedules the batch as one block.
template <int NB, int C, int R, bool kWhole>
__device__ __forceinline__ void compute(const unsigned char* st, float (&gacc)[NB][C],
                                        const float* xr, int ld, int n, const Keys& key) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (kWhole || j < n) {
      const Vec<C> w = gemv::lds<C>(st + j * 32 * C);
      float lo[C], hi[C];  // din 2i (x as is) and 2i + 1 (x / 16); odd bytes x 256
#pragma unroll
      for (int k = 0; k < C / 4; ++k) {
        const uint32_t h0 = w.w[k], h1 = h0 >> 16;
        lo[4 * k] = nibble<0>(h0, key.k[0]);
        hi[4 * k] = nibble<1>(h0, key.k[1]);
        lo[4 * k + 1] = nibble<2>(h0, key.k[2]);
        hi[4 * k + 1] = nibble<3>(h0, key.k[3]);
        lo[4 * k + 2] = nibble<0>(h1, key.k[0]);
        hi[4 * k + 2] = nibble<1>(h1, key.k[1]);
        lo[4 * k + 3] = nibble<2>(h1, key.k[2]);
        hi[4 * k + 3] = nibble<3>(h1, key.k[3]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float2 xv = *reinterpret_cast<const float2*>(xr + b * ld + 2 * j);
#pragma unroll
        for (int c = 0; c < C; ++c) gacc[b][c] = fmaf(xv.y, hi[c], fmaf(xv.x, lo[c], gacc[b][c]));
      }
    }
  }
}

// A warp's walk over its groups [ga, gb) of a segment (from din row s0):
// batch k is group ga + k / bpg, packed rows from (k % bpg) * R.
template <int C, int R>
struct Warp {
  const int8_t* qc;  // the lane's byte of packed row 0
  const float* sc;   // the lane's scale of group 0
  size_t dout;
  int ga, gb, bpg, half, s0;

  __device__ __forceinline__ int first_row(int k, int& n, bool& last) const {
    const int g = ga + k / bpg, jb = k - (g - ga) * bpg;
    n = min(R, half - jb * R);
    last = jb == bpg - 1;
    return g * half + jb * R;
  }

  // batch k's packed rows into the lane's stage at st (shared memory), one
  // commit group
  __device__ __forceinline__ void fetch(uint32_t st, int k) const {
    int n;
    bool last;
    const int p = first_row(k, n, last);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < n) gemv::cp_async<C>(st + j * 32 * C, qc + static_cast<size_t>(p + j) * dout);
  }
};

// Batch k's arithmetic from the lane's stage st; after a group's last
// batch, its sums times the scales into acc, and the next group's scales
// requested.
template <int NB, int C, int R>
__device__ __forceinline__ void step(const Warp<C, R>& wp, const unsigned char* st, int k,
                                     const float* xs, int ld, float (&gacc)[NB][C],
                                     float (&acc)[NB][C], float (&s)[C], const Keys& key) {
  int n;
  bool last;
  const int p = wp.first_row(k, n, last);
  if (n == R)
    compute<NB, C, R, true>(st, gacc, xs + (2 * p - wp.s0), ld, n, key);
  else
    compute<NB, C, R, false>(st, gacc, xs + (2 * p - wp.s0), ld, n, key);
  if (last) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[b][c] = fmaf(gacc[b][c], s[c], acc[b][c]);
        gacc[b][c] = 0.f;
      }
    const int g = p / wp.half + 1;  // the next group
    if (g < wp.gb) load_scales(s, wp.sc, wp.dout, g);
  }
}

// grid: (column tiles, cluster ranks), clusters of (1, ranks, 1); see
// gemv_common.cuh.  rows_per_block and seg_rows are multiples of gs, and a
// warp takes whole groups.  Shared memory: the warps' sums, the slots, x
// f32 [NB, ld], then the warps' rings.
template <typename T, int NB, int C>
__global__ void __launch_bounds__(gemv::kMaxThreads, 1) q4_gemv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  gemv::cluster_arrive_relaxed();  // this block has started; waited on before the first remote store
  constexpr int R = batch_rows(NB), S = gemv::stages(stage_bytes(NB, C));
  const int rank = blockIdx.y, ranks = gridDim.y;
  const int warps = blockDim.x / 32, wk = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xs = smem + gemv::x_offset(NB, C, warps, ranks);
  const int ld = gemv::round_up(a.seg_rows, gemv::kXPad);
  // the lane's C bytes of each stage of its warp's ring
  const unsigned char* ring = reinterpret_cast<const unsigned char*>(xs + NB * ld) +
                              wk * ring_bytes(NB, C) + lane * C;
  const uint32_t ring_s = gemv::smem_addr(ring);
  const int tile0 = blockIdx.x * 32 * C;
  // a lane past dout reads the tile's first columns; its sums are dropped
  const int col = tile0 + C * lane < a.dout ? tile0 + C * lane : tile0;
  const size_t dout = a.dout;
  const int gs = a.group_size, half = gs / 2;
  Keys key;
#pragma unroll
  for (int p = 0; p < 4; ++p) key.k[p] = 0x4B000000u | (0x8u << (4 * p));
  const int bpg = (half + R - 1) / R;  // batches a group
  const int8_t* qc = a.q + col;
  const float* sc = a.scale + col;
  const int blk0 = rank * a.rows_per_block, blk1 = min(a.din, blk0 + a.rows_per_block);

  float acc[NB][C] = {}, gacc[NB][C] = {};
  float s[C];  // the current group's scales
  for (int s0 = blk0; s0 < blk1; s0 += a.seg_rows) {
    const int s1 = min(blk1, s0 + a.seg_rows);
    // this warp's groups of the segment [ga, gb), as nb batches
    const int groups = (s1 - s0) / gs, per = (groups + warps - 1) / warps;
    const int ga = s0 / gs + min(groups, wk * per), gb = s0 / gs + min(groups, (wk + 1) * per);
    const int nb = (gb - ga) * bpg;
    if (s0 != blk0) __syncthreads();  // every warp is done with the last segment's x
    const Warp<C, R> wp{qc, sc, dout, ga, gb, bpg, half, s0};
    if (nb > 0) load_scales(s, sc, dout, ga);
    gemv::XStage<T, NB, true> xst;  // x's loads go out before the weights'
    xst.load(static_cast<const T*>(a.x), a.din, s0, s1);
    // stages 0 .. S - 2 requested ahead, one commit group each (empty past nb)
#pragma unroll
    for (int d = 0; d < S - 1; ++d) {
      if (d < nb) wp.fetch(ring_s + d * stage_bytes(NB, C), d);
      gemv::cp_async_commit();
    }
    xst.store(static_cast<const T*>(a.x), xs, ld, a.din, s0, s1);
    for (int k = 0; k < nb; ++k) {
      const int kn = k + S - 1;  // into the stage batch k - 1 was summed from
      if (kn < nb) wp.fetch(ring_s + (kn % S) * stage_bytes(NB, C), kn);
      gemv::cp_async_commit();
      gemv::cp_async_wait<S - 1>();  // batch k's group has landed
      step<NB, C, R>(wp, ring + (k % S) * stage_bytes(NB, C), k, xs, ld, gacc, acc, s, key);
    }
    gemv::cp_async_wait<0>();
  }
  gemv::reduce_store<T, NB, C>(acc, smem, nullptr, static_cast<T*>(a.out), a.dout, tile0);
}

template <typename T, int NB, int C>
struct Resident {
  static int run(int warps, int cluster, int seg_rows) {
    return gemv::resident<NB, C>(q4_gemv_kernel<T, NB, C>, ring_bytes(NB, C), warps, cluster, seg_rows);
  }
};

template <typename T, int NB, int C>
struct Launch {
  static cudaError_t run(Args a, int warps, int cluster, cudaStream_t stream) {
    return gemv::launch<NB, C>(q4_gemv_kernel<T, NB, C>, ring_bytes(NB, C), a, warps, cluster,
                               stream);
  }
};

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/q4matmul.py.  The
// plan (ops/q4matmul.py `gemv_plan`) as for int8_gemv: `cols` 4, 8 or 16
// (at most gemv::max_cols(batch); dout and q aligned to it), `warps` 1..8,
// `cluster` 1..8, rows_per_block and seg_rows multiples of group_size
// (even), rows_per_block * cluster covering din (a multiple of
// group_size); scale 16-byte aligned.  Anything else returns
// cudaErrorInvalidValue; otherwise the launch's error code.
extern "C" int q4_gemv(const void* x, const void* q, const void* scale, void* out, int batch,
                       int din, int dout, int group_size, int cols, int warps, int cluster,
                       int rows_per_block, int seg_rows, int x_is_bf16, void* stream) {
  if (!gemv::plan_ok(batch, din, dout, cols, warps, cluster, rows_per_block, seg_rows,
                     kMaxAcc) ||
      group_size < 2 || group_size % 2 != 0 || din % group_size != 0 ||
      rows_per_block % group_size != 0 || seg_rows % group_size != 0 || dout % cols != 0 ||
      reinterpret_cast<uintptr_t>(q) % cols != 0 || reinterpret_cast<uintptr_t>(scale) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale), out,
               din, dout, group_size, rows_per_block, seg_rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (
      x_is_bf16 ? gemv::dispatch<__nv_bfloat16, kMaxAcc, Launch>(batch, cols, a, warps, cluster, s)
                : gemv::dispatch<float, kMaxAcc, Launch>(batch, cols, a, warps, cluster, s));
}

// The blocks of a q4_gemv launch under a plan that the card holds at once
// (gemv::resident); the plan's arguments as q4_gemv's.
extern "C" int q4_gemv_resident(int batch, int cols, int warps, int cluster, int seg_rows,
                                int x_is_bf16) {
  if (batch < 1 || batch > gemv::kMaxBatch || (cols != 4 && cols != 8 && cols != 16) ||
      cols > gemv::max_cols(batch, kMaxAcc) || warps < 1 || warps > gemv::kMaxWarps ||
      cluster < 1 || cluster > gemv::kMaxCluster || seg_rows < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  return x_is_bf16 ? gemv::dispatch<__nv_bfloat16, kMaxAcc, Resident>(batch, cols, warps,
                                                                      cluster, seg_rows)
                   : gemv::dispatch<float, kMaxAcc, Resident>(batch, cols, warps, cluster,
                                                             seg_rows);
}
