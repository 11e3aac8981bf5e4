// Shared pieces of the weight-only GEMV kernels: the CUDA-core ones
// (q4_gemv.cu, int8_gemv.cu) and the mma.sync of the tensor-core ones
// (q4_mma.cu, int8_mma.cu).
//
// The CUDA-core kernels compute y[B, dout] = x[B, din] @ W[din, dout] for a small
// batch B (1..kMaxBatch) over weights stored dout-contiguous, the layout of
// moshi_tpu's QTensor / QTensor4.  Each thread owns kCols neighbouring output
// columns and reads their packed bytes as one 32-bit word per weight row, so
// a warp reads 128 contiguous bytes per row.  A block covers
// kCols * kThreads columns; blockIdx.y splits din so that a narrow dout still
// fills the card.  Split partial sums go to an f32 workspace [splits, B, dout]
// and a second pass (reduce_splits) adds them in split order: no atomics, so
// a result does not change from run to run.
//
// No bf16 arithmetic happens in device code: activations are converted to
// f32 with __bfloat162float when they are staged in shared memory, and the
// output is converted back with __float2bfloat16.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gemv {

constexpr int kCols = 4;       // output columns per thread (one 32-bit load)
constexpr int kThreads = 128;  // threads per block
constexpr int kMaxBatch = 16;  // batch rows a launch takes
// Shared memory a block stages x in without opting in to more: f32 [NB,
// rows], so the host caps rows per split at kStageFloats / NB and a launch
// that asks for more is refused.
constexpr int kStageFloats = 48 * 1024 / 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Stage rows [row0, row0 + rows) of x[NB, din] into shared memory as f32,
// laid out [NB, rows].
template <typename T, int NB>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* xs,
                                        int din, int row0, int rows) {
  for (int i = threadIdx.x; i < NB * rows; i += blockDim.x) {
    const int b = i / rows;
    const int r = i - b * rows;
    xs[i] = to_f32(x[static_cast<size_t>(b) * din + row0 + r]);
  }
  __syncthreads();
}

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

// Expands to a switch over the batch size that calls FN<T, NB>(args...) for
// NB in 1..kMaxBatch, returning cudaErrorInvalidValue for anything else.
#define GEMV_DISPATCH_BATCH(batch, FN, T, ...)              \
  switch (batch) {                                          \
    case 1: return FN<T, 1>(__VA_ARGS__);                   \
    case 2: return FN<T, 2>(__VA_ARGS__);                   \
    case 3: return FN<T, 3>(__VA_ARGS__);                   \
    case 4: return FN<T, 4>(__VA_ARGS__);                   \
    case 5: return FN<T, 5>(__VA_ARGS__);                   \
    case 6: return FN<T, 6>(__VA_ARGS__);                   \
    case 7: return FN<T, 7>(__VA_ARGS__);                   \
    case 8: return FN<T, 8>(__VA_ARGS__);                   \
    case 9: return FN<T, 9>(__VA_ARGS__);                   \
    case 10: return FN<T, 10>(__VA_ARGS__);                 \
    case 11: return FN<T, 11>(__VA_ARGS__);                 \
    case 12: return FN<T, 12>(__VA_ARGS__);                 \
    case 13: return FN<T, 13>(__VA_ARGS__);                 \
    case 14: return FN<T, 14>(__VA_ARGS__);                 \
    case 15: return FN<T, 15>(__VA_ARGS__);                 \
    case 16: return FN<T, 16>(__VA_ARGS__);                 \
    default: return cudaErrorInvalidValue;                  \
  }
