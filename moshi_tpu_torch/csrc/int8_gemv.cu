// int8_gemv: per-output-channel int8 weight-only GEMV on the CUDA cores, for
// Hopper (sm_90a).
//
// Replaces, beside int8_mma.cu, the Pallas TPU kernel
// moshi_tpu/ops/qmatmul.py `qgemv`, and with it the dequantising dot that
// XLA fused for `wdot(x, QTensor)` on the TPU (moshi_tpu/utils/matmul.py:83).
// ops/qmatmul.py sends here what int8_mma does not take: f32 x, and widths
// that are not a multiple of 64 (the TTS heads: 32001 text columns, 2049
// audio ones, at B = 16 in bf16).
//
// Computes y[B, dout] = (x[B, din] @ q[din, dout]) * scale[1, dout]:
//   q     int8 [din, dout], dout-contiguous (QTensor layout), at any byte
//         offset (a member view of a stacked weight);
//   scale f32 [1, dout], applied once per output column after the whole f32
//         sum, as the TPU kernel does (qmatmul.py:41-44);
//   x     [B, din] bf16 or f32; y has x's dtype.
//
// What bounds it: 2*B flops per weight byte read, so device-memory bandwidth
// at B = 1, and the CUDA cores' FMAs at B = 16 (16 FFMA a byte: the 17 TTS
// heads' 0.1e9 bytes are ~1.7e9 FMAs, ~0.05 ms of an H100's issue against a
// ~0.03 ms memory bound); at 1-2 MB a call, one launch's fixed cost as much.
// The design is gemv_common.cuh's (a lane's `cols` columns, warps over din
// slices, a cluster over din, the sums added in distributed shared memory,
// one launch, no workspace).  Per weight byte: a byte permute under f32
// 2^23 and one FADD make it an exact f32 (int8_mma.cu's conversion), then B
// FFMAs with x read from shared memory four rows at a time.
//
// Rows at any byte offset.  Where dout is odd (or q is a view off a 4-byte
// boundary) a row starts anywhere in a word, and the offset moves from row
// to row.  With cols = 4 each lane copies the aligned word that holds the
// start of its window into the warp's stage, and lane 0 the one word past
// the warp's 128 bytes; a lane then reads its word and the next lane's from
// the stage and joins them with one funnel shift by the row's offset: a
// warp reads each row once in aligned words, plus one word.  Words wholly
// past the row's last column are not read; bytes past dout are never
// written.  cols = 8 and 16 copy 8- and 16-byte vectors and take only widths
// and views whose rows are aligned to them.

#include "gemv_common.cuh"

namespace {

using gemv::Args;
using gemv::kBatchRows;
using gemv::kInt8Bias;
using gemv::kTwo23;
using gemv::kTwo23Plus128;
using gemv::Vec;

// A warp's ring in shared memory: stages of kBatchRows rows; a row is the
// warp's 32 * C bytes, and with C = 4 the word past them (lane 31's next
// word) and padding to 16 bytes.
__host__ __device__ constexpr int row_bytes(int c) { return c == 4 ? 144 : 32 * c; }
__host__ __device__ constexpr int stage_bytes(int c) { return kBatchRows * row_bytes(c); }
__host__ __device__ constexpr int ring_bytes(int c) {
  return gemv::stages(stage_bytes(c)) * stage_bytes(c);
}

// Rows [row, row + n) (n <= kBatchRows) of the tile that starts at qt (row
// 0, the tile's first column) into the warp's stage at st (shared memory;
// row j at st + j row_bytes), one commit group's copies; tail = dout - the
// tile's first column.  With C = 4 a lane copies the aligned word that
// holds the start of its window, and lane 0 the word past the warp's 128
// bytes; words wholly past the row's last column are not copied (their
// bytes would only reach columns past dout).
template <int C>
__device__ __forceinline__ void fetch(uint32_t st, const int8_t* qt, size_t dout, int row, int n,
                                      int lane, int tail) {
#pragma unroll
  for (int j = 0; j < kBatchRows; ++j) {
    if (j < n) {
      const int8_t* rp = qt + static_cast<size_t>(row + j) * dout;
      const uint32_t dst = st + j * row_bytes(C);
      if constexpr (C == 4) {
        const int m = static_cast<int>(reinterpret_cast<uintptr_t>(rp) & 3);
        const int8_t* a0 = rp - m;  // the aligned word that holds the row's first byte
        if (4 * lane < tail + m) gemv::cp_async<4>(dst + 4 * lane, a0 + 4 * lane);
        if (lane == 0 && m != 0 && 128 < tail + m) gemv::cp_async<4>(dst + 128, a0 + 128);
      } else {
        if (C * lane < tail) gemv::cp_async<C>(dst + C * lane, rp + C * lane);
      }
    }
  }
}

// acc[b][c] += x[b, row + j] * w[row + j, col + c] over the batch's rows
// j < n, from the warp's stage st; xr is x's column of row `row` in the
// staged [NB, ld] x; qr the tile's first byte of row `row`.
template <int NB, int C>
__device__ __forceinline__ void compute(const unsigned char* st, float (&acc)[NB][C],
                                        const float* xr, int ld, const int8_t* qr, size_t dout,
                                        int n, int lane) {
#pragma unroll
  for (int j0 = 0; j0 < kBatchRows; j0 += 4) {
    float wf[4][C];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool live = j0 + j < n;  // rows past n hold an older batch's bytes
      const unsigned char* rp = st + (j0 + j) * row_bytes(C);
      uint32_t wd[C / 4];
      if constexpr (C == 4) {
        // this lane's word and the next lane's (lane 31: the word past them)
        const uint2 two = make_uint2(*reinterpret_cast<const uint32_t*>(rp + 4 * lane),
                                     *reinterpret_cast<const uint32_t*>(rp + 4 * lane + 4));
        const int m = static_cast<int>(
            reinterpret_cast<uintptr_t>(qr + static_cast<size_t>(j0 + j) * dout) & 3);
        wd[0] = live ? __funnelshift_r(two.x, two.y, 8 * m) : 0u;
      } else {
        const Vec<C> v = gemv::lds<C>(rp + C * lane);
#pragma unroll
        for (int k = 0; k < C / 4; ++k) wd[k] = live ? v.w[k] : 0u;
      }
#pragma unroll
      for (int k = 0; k < C / 4; ++k) {
        const uint32_t u = wd[k] ^ kInt8Bias;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wf[j][4 * k + t] = __uint_as_float(__byte_perm(u, kTwo23, 0x7440u | t)) - kTwo23Plus128;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + b * ld + j0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float s = acc[b][c];
        s = fmaf(xv.x, wf[0][c], s);
        s = fmaf(xv.y, wf[1][c], s);
        s = fmaf(xv.z, wf[2][c], s);
        acc[b][c] = fmaf(xv.w, wf[3][c], s);
      }
    }
  }
}

// grid: (column tiles, cluster ranks), clusters of (1, ranks, 1); see
// gemv_common.cuh.  Shared memory: the warps' sums, the slots, x f32 [NB,
// ld], then the warps' rings.
template <typename T, int NB, int C>
__global__ void __launch_bounds__(gemv::kMaxThreads, 1) int8_gemv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  gemv::cluster_arrive_relaxed();  // this block has started; waited on before the first remote store
  constexpr int S = gemv::stages(stage_bytes(C));
  const int rank = blockIdx.y, ranks = gridDim.y;
  const int warps = blockDim.x / 32, wk = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xs = smem + gemv::x_offset(NB, C, warps, ranks);
  const int ld = gemv::round_up(a.seg_rows, gemv::kXPad);
  const unsigned char* ring =
      reinterpret_cast<const unsigned char*>(xs + NB * ld) + wk * ring_bytes(C);
  const uint32_t ring_s = gemv::smem_addr(ring);
  const int tile0 = blockIdx.x * 32 * C, tail = a.dout - tile0;
  const size_t dout = a.dout;
  const int8_t* qt = a.q + tile0;
  const int blk0 = rank * a.rows_per_block, blk1 = min(a.din, blk0 + a.rows_per_block);

  float acc[NB][C] = {};
  for (int s0 = blk0; s0 < blk1; s0 += a.seg_rows) {
    const int s1 = min(blk1, s0 + a.seg_rows);
    // this warp's rows of the segment: a multiple of kBatchRows from s0
    const int per = gemv::round_up((s1 - s0 + warps - 1) / warps, kBatchRows);
    const int w0 = min(s1, s0 + wk * per), w1 = min(s1, w0 + per);
    const int nb = (w1 - w0 + kBatchRows - 1) / kBatchRows;
    if (s0 != blk0) __syncthreads();  // every warp is done with the last segment's x
    gemv::XStage<T, NB, false> xst;  // x's loads go out before the weights'
    xst.load(static_cast<const T*>(a.x), a.din, s0, s1);
    // stages 0 .. S - 2 requested ahead, one commit group each (empty past nb)
#pragma unroll
    for (int d = 0; d < S - 1; ++d) {
      const int r = w0 + d * kBatchRows;
      if (d < nb) fetch<C>(ring_s + d * stage_bytes(C), qt, dout, r, min(kBatchRows, w1 - r), lane, tail);
      gemv::cp_async_commit();
    }
    xst.store(static_cast<const T*>(a.x), xs, ld, a.din, s0, s1);
    for (int k = 0; k < nb; ++k) {
      const int r = w0 + k * kBatchRows, kn = k + S - 1, rn = w0 + kn * kBatchRows;
      __syncwarp();  // every lane is done with the stage batch k - 1 was summed from
      if (kn < nb)
        fetch<C>(ring_s + (kn % S) * stage_bytes(C), qt, dout, rn, min(kBatchRows, w1 - rn), lane,
                 tail);
      gemv::cp_async_commit();
      gemv::cp_async_wait<S - 1>();  // batch k's group has landed
      __syncwarp();                  // ... the other lanes' copies too
      compute<NB, C>(ring + (k % S) * stage_bytes(C), acc, xs + (r - s0), ld, qt + r * dout, dout,
                     min(kBatchRows, w1 - r), lane);
    }
    gemv::cp_async_wait<0>();
  }
  gemv::reduce_store<T, NB, C>(acc, smem, a.scale, static_cast<T*>(a.out), a.dout, tile0);
}

template <typename T, int NB, int C>
struct Resident {
  static int run(int warps, int cluster, int seg_rows) {
    return gemv::resident<NB, C>(int8_gemv_kernel<T, NB, C>, ring_bytes(C), warps, cluster, seg_rows);
  }
};

template <typename T, int NB, int C>
struct Launch {
  static cudaError_t run(Args a, int warps, int cluster, cudaStream_t stream) {
    return gemv::launch<NB, C>(int8_gemv_kernel<T, NB, C>, ring_bytes(C), a, warps, cluster,
                               stream);
  }
};

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/qmatmul.py.  The
// plan (ops/q4matmul.py `gemv_plan`): `cols` columns a lane (4: any dout
// and any q; 8 or 16: dout and q aligned to it; at most
// gemv::max_cols(batch)), `warps` warps a block (1..8), `cluster` blocks a
// column tile (1..8), rank r taking din rows [r * rows_per_block, ...),
// which must cover din, x staged seg_rows rows at a time (at most
// rows_per_block).  Anything else returns cudaErrorInvalidValue; otherwise
// the launch's error code.
extern "C" int int8_gemv(const void* x, const void* q, const void* scale, void* out, int batch,
                         int din, int dout, int cols, int warps, int cluster, int rows_per_block,
                         int seg_rows, int x_is_bf16, void* stream) {
  if (!gemv::plan_ok(batch, din, dout, cols, warps, cluster, rows_per_block, seg_rows,
                     gemv::kMaxAcc) ||
      (cols != 4 && (dout % cols != 0 || reinterpret_cast<uintptr_t>(q) % cols != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale), out,
               din, dout, 1, rows_per_block, seg_rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (
      x_is_bf16
          ? gemv::dispatch<__nv_bfloat16, gemv::kMaxAcc, Launch>(batch, cols, a, warps, cluster, s)
          : gemv::dispatch<float, gemv::kMaxAcc, Launch>(batch, cols, a, warps, cluster, s));
}

// The blocks of an int8_gemv launch under a plan that the card holds at
// once (gemv::resident); the plan's arguments as int8_gemv's.
extern "C" int int8_gemv_resident(int batch, int cols, int warps, int cluster, int seg_rows,
                                  int x_is_bf16) {
  if (batch < 1 || batch > gemv::kMaxBatch || (cols != 4 && cols != 8 && cols != 16) ||
      cols > gemv::max_cols(batch, gemv::kMaxAcc) || warps < 1 || warps > gemv::kMaxWarps ||
      cluster < 1 || cluster > gemv::kMaxCluster || seg_rows < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  return x_is_bf16 ? gemv::dispatch<__nv_bfloat16, gemv::kMaxAcc, Resident>(batch, cols, warps,
                                                                      cluster, seg_rows)
                   : gemv::dispatch<float, gemv::kMaxAcc, Resident>(batch, cols, warps, cluster,
                                                             seg_rows);
}
