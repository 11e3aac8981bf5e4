// decode_attention_int8: T = 1 flash decode over the int8 ring KV cache,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel moshi_tpu/ops/decode_attention.py
// `decode_attention_int8` (`_kernel`).  That kernel read an experiment's
// head-major [B, H, S, D] layout; this one reads the ring cache of the
// int8 KV path in place:
//   k_all, v_all int8 [L, B, cap, Hkv, D]: position s of KV head g of slot b
//       in layer l is one contiguous row of D bytes;
//   k_scale, v_scale bf16 [L, B, cap, Hkv, 1]: its dequantization scale;
//   mask bool [B, cap]; q [B, H, D] bf16, rope'd, not yet scaled.
// Returns out [B, H, D] bf16, normalized.
//
// Arithmetic per (slot b, query head h), KV head g = h / (H / Hkv), all in
// f32: s = (q . k_int) * k_scale / sqrt(D); an online softmax over the
// masked-in positions; acc += (p * v_scale) * v_int; out = acc / max(l,
// 1e-20).  A slot with every position masked (a frozen slot before its
// first executed frame) gives 0, as the TPU kernel's max(l, 1e-20) does.
//
// What bounds it: every cache byte feeds 2 multiply-adds per query head
// sharing it, ~4 flops per byte, far below the card's ~295 flop/byte
// balance point, so it is bound by device-memory bandwidth.  At the ASR
// path's B = 256, H = 8, cap 750, D = 128 (and at Moshi's B = 16, H = 32,
// cap 3000) one launch must read ~393 MB of K/V and ~6 MB of scales
// (~0.12 ms at 3.35 TB/s).
//
// Design: one block per (head h, slot b), 256 threads, walking the ring in
// chunks of 256 positions (the loop takes the place of the TPU's sequential
// position grid axis).  Thread t owns 16 channels (channel group t % (D/16))
// of the positions p == t / (D/16) modulo 256 / (D/16), and reads them as
// one 16-byte load, so the D/16 neighbouring lanes that share a position
// read its D bytes as one coalesced row.  Scores: a 16-channel partial dot
// product, summed over those lanes with shuffles, into shared memory; one
// thread per position then takes the chunk's block max, and writes p *
// v_scale back.  PV: the same mapping; each thread keeps 16 partial
// accumulators rescaled by the online-softmax factor once per chunk, and
// the partials are summed over position lanes through shared memory at the
// end.  The layer is a pointer offset into the [L, ...] stack and grouped
// KV heads cost nothing.  The scales lie Hkv * 2 bytes apart: each is its
// own 32-byte sector read (noted in PERF.md, not redesigned here).
// No tensor cores: at ~4 flops per byte the CUDA cores keep up.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;       // positions per chunk: one per thread in the softmax
constexpr int kVec = 16;          // channels (bytes) per thread per position

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reduce one value per thread over the block; `red` holds kWarps floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

// 16 signed bytes as floats.
__device__ __forceinline__ void unpack16(const int4& raw, float* out) {
  const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * w + j] = static_cast<float>(static_cast<int8_t>(words[w] >> (8 * j)));
  }
}

// grid (H, B), kThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_attention_int8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_all,
    const int8_t* __restrict__ v_all, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const bool* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int layer, int B, int H, int Hkv, int cap) {
  constexpr int kGroups = D / kVec;               // lanes that share one position
  constexpr int kLanes = kThreads / kGroups;      // positions in flight per pass
  constexpr int kSteps = kChunk / kLanes;         // passes per chunk
  static_assert(D % kVec == 0 && 32 % kGroups == 0, "D must be 64 or 128");
  __shared__ float sc[kChunk];                    // scores, then p * v_scale
  __shared__ float red[kWarps];
  __shared__ float part[kLanes][D + 1];           // +1: no bank conflicts in the sum

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / Hkv);
  const int tid = threadIdx.x, cg = tid % kGroups, pl = tid / kGroups;
  const size_t row = static_cast<size_t>(Hkv) * D;        // bytes between positions
  const size_t slot = static_cast<size_t>(layer) * B + b;
  const int8_t* kp = k_all + slot * cap * row + static_cast<size_t>(g) * D + cg * kVec;
  const int8_t* vp = v_all + slot * cap * row + static_cast<size_t>(g) * D + cg * kVec;
  const __nv_bfloat16* ksp = k_scale + slot * cap * Hkv + g;
  const __nv_bfloat16* vsp = v_scale + slot * cap * Hkv + g;
  const bool* mp = mask + static_cast<size_t>(b) * cap;
  const float inv_sqrt_d = rsqrtf(static_cast<float>(D));

  float qv[kVec], acc[kVec];
  const __nv_bfloat16* qp = q + (static_cast<size_t>(b) * H + h) * D + cg * kVec;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    qv[j] = __bfloat162float(qp[j]);
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int c0 = 0; c0 < cap; c0 += kChunk) {
    // ---- scores of the chunk: issue every load of the pass first
    int4 raw[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int s = c0 + pl + i * kLanes;
      raw[i] = s < cap ? __ldg(reinterpret_cast<const int4*>(kp + s * row))
                       : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      float kv[kVec];
      unpack16(raw[i], kv);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) dot = fmaf(qv[j], kv[j], dot);
#pragma unroll
      for (int o = kGroups / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (cg == 0) sc[pl + i * kLanes] = dot;
    }
    __syncthreads();
    // ---- online softmax: thread tid owns position c0 + tid
    const int s = c0 + tid;
    const bool valid = s < cap && mp[s];
    const float score = valid ? sc[tid] * __bfloat162float(ksp[s * Hkv]) * inv_sqrt_d
                              : -INFINITY;
    const float m_new = fmaxf(m, block_reduce<true>(score, red));
    const float p = valid ? __expf(score - m_new) : 0.f;   // m_new finite when valid
    const float alpha = m == -INFINITY ? 0.f : __expf(m - m_new);
    sc[tid] = valid ? p * __bfloat162float(vsp[s * Hkv]) : 0.f;
    l = l * alpha + block_reduce<false>(p, red);          // its barrier publishes sc
    m = m_new;
    // ---- acc += (p * v_scale) . v over the chunk
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int si = c0 + pl + i * kLanes;
      raw[i] = si < cap ? __ldg(reinterpret_cast<const int4*>(vp + si * row))
                        : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] *= alpha;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      float vv[kVec];
      unpack16(raw[i], vv);
      const float pw = sc[pl + i * kLanes];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = fmaf(pw, vv[j], acc[j]);
    }
    __syncthreads();  // sc is rewritten by the next chunk
  }

  // ---- sum the partials over the position lanes, normalize, write bf16
#pragma unroll
  for (int j = 0; j < kVec; ++j) part[pl][cg * kVec + j] = acc[j];
  __syncthreads();
  const float inv_l = 1.f / fmaxf(l, 1e-20f);
  for (int d = tid; d < D; d += kThreads) {
    float sum = 0.f;
    for (int i = 0; i < kLanes; ++i) sum += part[i][d];
    out[(static_cast<size_t>(b) * H + h) * D + d] = __float2bfloat16(sum * inv_l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_all, const void* v_all,
                   const void* k_scale, const void* v_scale, const void* mask, void* out,
                   int layer, int B, int H, int Hkv, int cap, cudaStream_t stream) {
  decode_attention_int8_kernel<D><<<dim3(H, B), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_all),
      static_cast<const int8_t*>(v_all), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const bool*>(mask),
      static_cast<__nv_bfloat16*>(out), layer, B, H, Hkv, cap);
  return cudaGetLastError();
}

}  // namespace

// Message for an error code returned by the entry point.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C interface, loaded with ctypes by moshi_tpu_torch/ops/decode_attention.py.
// out is a bf16 output of B*H*D elements.  Returns cudaGetLastError() after
// the launch.
extern "C" int decode_attention_int8(const void* q, const void* k_all, const void* v_all,
                                     const void* k_scale, const void* v_scale,
                                     const void* mask, void* out, int layer, int B, int H,
                                     int Hkv, int D, int cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k_all, v_all, k_scale, v_scale, mask, out, layer,
                                         B, H, Hkv, cap, s));
    case 128:
      return static_cast<int>(launch<128>(q, k_all, v_all, k_scale, v_scale, mask, out,
                                          layer, B, H, Hkv, cap, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
