// q4_gemv: group-wise 4-bit weight-only GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels moshi_tpu/ops/q4matmul.py `q4gemm` and
// `q4gemm_stacked`.  The stacked variant existed because XLA copies a
// dynamic slice of a stacked weight before a Pallas call; here member l of a
// contiguous [L, din/2, dout] stack is a pointer offset, so one kernel
// serves both.
//
// Computes y[B, dout] = sum_g (x[:, g*gs:(g+1)*gs] @ w_g) * scale[g, :]:
//   q     int8 [din/2, dout], sequential-pair nibbles: byte (i, n) holds din
//         position 2i in the low nibble and 2i+1 in the high nibble, each a
//         signed value in [-7, 7] (moshi_tpu/utils/quantize.py:225-239);
//   scale f32 [din/gs, 1, dout]; group g covers din [g*gs, (g+1)*gs);
//   x     [B, din] bf16 or f32; y has x's dtype.
// Each group is accumulated in f32 and then multiplied by its scale, as the
// TPU kernel does (q4matmul.py:70-75).
//
// What bounds it: at the batch sizes of decoding (B = 1..8) the kernel does
// 2*B flops per weight and reads 0.5 byte of packed weight plus 4/gs bytes
// of scale per weight, i.e. 0.625 * din bytes per output column at gs = 32.
// It is bound by device-memory bandwidth.  The design therefore reads every
// packed byte once, in coalesced 32-bit words (four neighbouring columns per
// thread, 128 contiguous bytes per warp per row), unpacks the nibbles in
// registers with integer ops, and splits din across blocks so that even a
// 4096-column layer puts several blocks on each of the 132 SMs.

#include "gemv_common.cuh"

namespace {

using gemv::kCols;
using gemv::kThreads;

__device__ __forceinline__ int sign_nibble(int v) { return ((v & 0xF) ^ 8) - 8; }

// grid: (ceil(dout / (kCols * kThreads)), splits); split s covers groups
// [s * groups_per_split, ...).  With one split the block writes y; else it
// writes its partial sums to partial[s, b, col].
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads) q4_gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, T* __restrict__ out,
    float* __restrict__ partial, int din, int dout, int gs,
    int groups_per_split) {
  extern __shared__ float xs[];  // [NB, rows]
  const int num_groups = din / gs;
  const int g0 = blockIdx.y * groups_per_split;
  const int ng = min(groups_per_split, num_groups - g0);
  const int rows = ng * gs;
  gemv::stage_x<T, NB>(x, xs, din, g0 * gs, rows);

  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col >= dout) return;
  const int half = gs / 2;

  float acc[NB][kCols];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  for (int g = 0; g < ng; ++g) {
    float gacc[NB][kCols];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c) gacc[b][c] = 0.f;
    const int8_t* qg = q + static_cast<size_t>(g0 + g) * half * dout + col;
    const float* xg = xs + g * gs;
#pragma unroll 8
    for (int i = 0; i < half; ++i) {
      const unsigned int word =
          __ldg(reinterpret_cast<const unsigned int*>(qg + static_cast<size_t>(i) * dout));
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int byte = static_cast<int>((word >> (8 * c)) & 0xFFu);
        const float lo = static_cast<float>(sign_nibble(byte));
        const float hi = static_cast<float>(sign_nibble(byte >> 4));
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          gacc[b][c] = fmaf(lo, xg[b * rows + 2 * i], gacc[b][c]);
          gacc[b][c] = fmaf(hi, xg[b * rows + 2 * i + 1], gacc[b][c]);
        }
      }
    }
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(
        scale + static_cast<size_t>(g0 + g) * dout + col));
    const float s[kCols] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(gacc[b][c], s[c], acc[b][c]);
  }

  if (gridDim.y == 1) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        gemv::store(out + static_cast<size_t>(b) * dout + col + c, acc[b][c]);
  } else {
    float* p = partial + static_cast<size_t>(blockIdx.y) * NB * dout;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c) p[static_cast<size_t>(b) * dout + col + c] = acc[b][c];
  }
}

template <typename T, int NB>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out,
                   void* partial, int din, int dout, int gs,
                   int groups_per_split, int splits, cudaStream_t stream) {
  const dim3 grid((dout + kCols * kThreads - 1) / (kCols * kThreads), splits);
  const size_t smem = sizeof(float) * NB * groups_per_split * gs;
  q4_gemv_kernel<T, NB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), din, dout, gs, groups_per_split);
  if (splits > 1) {
    gemv::launch_reduce<T>(static_cast<const float*>(partial), nullptr,
                           static_cast<T*>(out), splits, NB * dout, dout, stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int batch, const void* x, const void* q, const void* scale,
                     void* out, void* partial, int din, int dout, int gs,
                     int groups_per_split, int splits, cudaStream_t stream) {
  GEMV_DISPATCH_BATCH(batch, launch, T, x, q, scale, out, partial, din, dout,
                      gs, groups_per_split, splits, stream)
}

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/q4matmul.py.
// `partial` is an f32 workspace of splits * batch * dout elements (unused
// when splits == 1).  Returns cudaGetLastError() after the launches.
extern "C" int q4_gemv(const void* x, const void* q, const void* scale,
                       void* out, void* partial, int batch, int din, int dout,
                       int group_size, int groups_per_split, int splits,
                       int x_is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return static_cast<int>(dispatch<__nv_bfloat16>(
        batch, x, q, scale, out, partial, din, dout, group_size,
        groups_per_split, splits, s));
  }
  return static_cast<int>(dispatch<float>(batch, x, q, scale, out, partial, din,
                                          dout, group_size, groups_per_split,
                                          splits, s));
}
