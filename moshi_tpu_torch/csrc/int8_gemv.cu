// int8_gemv: per-output-channel int8 weight-only GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel moshi_tpu/ops/qmatmul.py `qgemv`, and with
// it the dequantising dot that XLA fused for `wdot(x, QTensor)` on the TPU
// (moshi_tpu/utils/matmul.py:83).  Eager PyTorch has no such fusion: without
// this kernel every depformer linear would first write its weights out in
// bf16.
//
// Computes y[B, dout] = (x[B, din] @ q[din, dout]) * scale[1, dout]:
//   q     int8 [din, dout], dout-contiguous (QTensor layout);
//   scale f32 [1, dout], applied once per output column after the f32 sum;
//   x     [B, din] bf16 or f32; y has x's dtype.
//
// What bounds it: 2*B flops per weight against one byte of weight read,
// i.e. din bytes per output column at B = 1..16.  It is bound by
// device-memory bandwidth, and at the depformer's sizes (1-6 MB per call)
// by launch latency as much.  The design reads every weight byte once, in
// coalesced 32-bit words (four neighbouring columns per thread, 128
// contiguous bytes per warp per row), converts in registers, and splits din
// across blocks so that a 1024-column layer still spreads over the SMs.

#include "gemv_common.cuh"

namespace {

using gemv::kCols;
using gemv::kThreads;

// grid: (ceil(dout / (kCols * kThreads)), splits); split s covers rows
// [s * rows_per_split, ...).  With one split the block writes y; else it
// writes its unscaled partial sums to partial[s, b, col].
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads) int8_gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, T* __restrict__ out,
    float* __restrict__ partial, int din, int dout, int rows_per_split) {
  extern __shared__ float xs[];  // [NB, rows]
  const int row0 = blockIdx.y * rows_per_split;
  const int rows = min(rows_per_split, din - row0);
  gemv::stage_x<T, NB>(x, xs, din, row0, rows);

  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col >= dout) return;

  float acc[NB][kCols];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  const int8_t* qp = q + static_cast<size_t>(row0) * dout + col;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    const unsigned int word =
        __ldg(reinterpret_cast<const unsigned int*>(qp + static_cast<size_t>(r) * dout));
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float w = static_cast<float>(static_cast<int8_t>((word >> (8 * c)) & 0xFFu));
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b][c] = fmaf(xs[b * rows + r], w, acc[b][c]);
    }
  }

  if (gridDim.y == 1) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float s = scale[col + c];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        gemv::store(out + static_cast<size_t>(b) * dout + col + c, acc[b][c] * s);
    }
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
                   void* partial, int din, int dout, int rows_per_split,
                   int splits, cudaStream_t stream) {
  const dim3 grid((dout + kCols * kThreads - 1) / (kCols * kThreads), splits);
  const size_t smem = sizeof(float) * NB * rows_per_split;
  if (smem > sizeof(float) * gemv::kStageFloats) return cudaErrorInvalidValue;
  int8_gemv_kernel<T, NB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), din, dout, rows_per_split);
  if (splits > 1) {
    gemv::launch_reduce<T>(static_cast<const float*>(partial),
                           static_cast<const float*>(scale),
                           static_cast<T*>(out), splits, NB * dout, dout, stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int batch, const void* x, const void* q, const void* scale,
                     void* out, void* partial, int din, int dout,
                     int rows_per_split, int splits, cudaStream_t stream) {
  GEMV_DISPATCH_BATCH(batch, launch, T, x, q, scale, out, partial, din, dout,
                      rows_per_split, splits, stream)
}

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/qmatmul.py.
// `partial` is an f32 workspace of splits * batch * dout elements (unused
// when splits == 1).  Returns cudaGetLastError() after the launches.
extern "C" int int8_gemv(const void* x, const void* q, const void* scale,
                         void* out, void* partial, int batch, int din, int dout,
                         int rows_per_split, int splits, int x_is_bf16,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return static_cast<int>(dispatch<__nv_bfloat16>(
        batch, x, q, scale, out, partial, din, dout, rows_per_split, splits, s));
  }
  return static_cast<int>(dispatch<float>(batch, x, q, scale, out, partial, din,
                                          dout, rows_per_split, splits, s));
}
