// decode_attention_int4: T = 1 flash decode over the int4-packed KV cache,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel moshi_tpu/ops/int4_attention.py
// `decode_attention_int4_stats` (`_kernel` for D = 128, `_kernel_folded` for
// D < 128): one template covers both head dims here.
//
// Layout (the JAX package's, kept so the caches compare byte for byte):
//   k_all, v_all int8 [L, B, Hkv*D/2, cap_pad]: byte (row r, lane s) holds
//       channels 2r (low nibble) and 2r+1 (high nibble) of position s, each
//       a signed value in [-7, 7]; KV head g owns rows [g*D/2, (g+1)*D/2);
//   k_scale, v_scale bf16 [L, B, Hkv, cap_pad];
//   mask bool [B, cap], cap <= cap_pad the logical capacity;
//   q [B, H, 1, D] bf16, rope'd, not yet scaled.
// Returns the UNNORMALIZED flash state in f32: acc [B, H, D], m [B, H, 1],
// l [B, H, 1]; the caller merges the current row and divides by l.
//
// Arithmetic, in the TPU kernel's order: q is scaled by 1/sqrt(D) in f32 and
// rounded to bf16; score = (q . k_int) * k_scale + bias, with bias -1e30 on
// masked lanes; online softmax over chunks; acc += (p * v_scale) . v_int.
// Lanes at or past cap do not exist for the softmax (p = 0), as in the dense
// version, so m, l and acc equal the dense version's even when every lane
// is masked.
//
// What bounds it: every cache byte is used for 2 multiply-adds per query
// head, i.e. ~4 flops per byte at kv_repeat 1, far below the card's ~295
// flop/byte balance point.  It is bound by device-memory bandwidth: at B =
// 16, H = 32, D = 128, cap 3000 one launch must read ~197 MB of packed K/V
// and 6 MB of scales (~60 us at 3.35 TB/s).
//
// Design: one block per (head h, slot b), 256 threads; the loop over
// 1024-position chunks inside the block takes the place of the TPU's
// sequential chunk grid axis.  Positions lie along lanes, so in the score
// pass each thread owns 4 neighbouring positions and reads them as one
// 32-bit word per row (a warp reads 128 contiguous bytes per row); in the
// PV pass each warp owns D/16 rows and its lanes walk the chunk's words of
// those rows, keeping per-lane partial sums that are rescaled by the
// online-softmax factor and reduced across the warp once at the end.  The
// layer is a pointer offset into the full [L, ...] stack (nothing is
// copied, the role of scalar prefetch on the TPU), and query head h reads
// KV head h / (H / Hkv), so grouped KV heads cost nothing.  No tensor
// cores: at ~4 flops per byte the CUDA cores keep up.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                     // positions per thread (one word, one float4)
constexpr int kChunk = kThreads * kPerThread;     // positions per chunk
constexpr float kMasked = -1e30f;

__device__ __forceinline__ int sign_nibble(int v) { return ((v & 0xF) ^ 8) - 8; }

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

// grid (H, B), kThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_attention_int4_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_all,
    const int8_t* __restrict__ v_all, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const bool* __restrict__ mask,
    float* __restrict__ acc_out, float* __restrict__ m_out, float* __restrict__ l_out,
    int layer, int B, int H, int Hkv, int cap, int cap_pad) {
  constexpr int kRows = D / 2;                // packed rows of one KV head
  constexpr int kRowsPerWarp = kRows / kWarps;
  static_assert(kRows % kWarps == 0, "D/2 must be a multiple of the warp count");
  __shared__ float qs[D];
  __shared__ __align__(16) float pw[kChunk];  // p * v_scale of the chunk
  __shared__ float red[kWarps];

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t slot = static_cast<size_t>(layer) * B + b;
  const size_t hd2 = static_cast<size_t>(Hkv) * kRows;
  const int8_t* kp = k_all + (slot * hd2 + static_cast<size_t>(g) * kRows) * cap_pad;
  const int8_t* vp = v_all + (slot * hd2 + static_cast<size_t>(g) * kRows) * cap_pad;
  const __nv_bfloat16* ksp = k_scale + (slot * Hkv + g) * cap_pad;
  const __nv_bfloat16* vsp = v_scale + (slot * Hkv + g) * cap_pad;
  const bool* mp = mask + static_cast<size_t>(b) * cap;

  const float sqrt_d = sqrtf(static_cast<float>(D));
  for (int d = tid; d < D; d += kThreads) {
    const float v = __bfloat162float(q[(static_cast<size_t>(b) * H + h) * D + d]) / sqrt_d;
    qs[d] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();

  float m = kMasked, l = 0.f;
  float part[kRowsPerWarp][2];                // this lane's share of acc
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) part[i][0] = part[i][1] = 0.f;

  for (int c0 = 0; c0 < cap; c0 += kChunk) {
    // ---- scores of this thread's 4 positions
    const int s0 = c0 + kPerThread * tid;
    float sc[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) sc[j] = 0.f;
    if (s0 < cap) {  // cap_pad % 4 == 0, so the word lies inside the row
#pragma unroll 8
      for (int r = 0; r < kRows; ++r) {
        const unsigned int word = __ldg(reinterpret_cast<const unsigned int*>(
            kp + static_cast<size_t>(r) * cap_pad + s0));
        const float q0 = qs[2 * r], q1 = qs[2 * r + 1];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int byte = static_cast<int>((word >> (8 * j)) & 0xFFu);
          sc[j] = fmaf(q0, static_cast<float>(sign_nibble(byte)), sc[j]);
          sc[j] = fmaf(q1, static_cast<float>(sign_nibble(byte >> 4)), sc[j]);
        }
      }
    }
    float cmax = kMasked;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int s = s0 + j;
      if (s < cap) {
        sc[j] = mp[s] ? sc[j] * __bfloat162float(ksp[s]) : kMasked;
        cmax = fmaxf(cmax, sc[j]);
      }
    }
    // ---- online softmax
    const float m_new = fmaxf(m, block_reduce<true>(cmax, red));
    const float alpha = expf(m - m_new);
    float psum = 0.f, pv[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int s = s0 + j;
      const float p = s < cap ? expf(sc[j] - m_new) : 0.f;
      psum += p;
      pv[j] = s < cap ? p * __bfloat162float(vsp[s]) : 0.f;
    }
    reinterpret_cast<float4*>(pw)[tid] = make_float4(pv[0], pv[1], pv[2], pv[3]);
    l = l * alpha + block_reduce<false>(psum, red);  // its barrier publishes pw
    m = m_new;
    // ---- acc += pw . v over the chunk: warp `warp` owns rows warp*kRowsPerWarp..
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int8_t* row = vp + static_cast<size_t>(warp * kRowsPerWarp + i) * cap_pad;
      float lo = 0.f, hi = 0.f;
      for (int w = lane; w < kThreads; w += 32) {
        const int s = c0 + kPerThread * w;
        if (s >= cap) break;
        const unsigned int word = __ldg(reinterpret_cast<const unsigned int*>(row + s));
        const float4 p4 = reinterpret_cast<const float4*>(pw)[w];
        const float pj[kPerThread] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int byte = static_cast<int>((word >> (8 * j)) & 0xFFu);
          const float p = pj[j];
          lo = fmaf(p, static_cast<float>(sign_nibble(byte)), lo);
          hi = fmaf(p, static_cast<float>(sign_nibble(byte >> 4)), hi);
        }
      }
      part[i][0] = fmaf(part[i][0], alpha, lo);
      part[i][1] = fmaf(part[i][1], alpha, hi);
    }
    __syncthreads();  // pw is rewritten by the next chunk
  }

  const size_t bh = static_cast<size_t>(b) * H + h;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float lo = warp_sum(part[i][0]), hi = warp_sum(part[i][1]);
    if (lane == 0) {
      const int r = warp * kRowsPerWarp + i;
      acc_out[bh * D + 2 * r] = lo;
      acc_out[bh * D + 2 * r + 1] = hi;
    }
  }
  if (tid == 0) {
    m_out[bh] = m;
    l_out[bh] = l;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_all, const void* v_all,
                   const void* k_scale, const void* v_scale, const void* mask,
                   void* acc, void* m, void* l, int layer, int B, int H, int Hkv,
                   int cap, int cap_pad, cudaStream_t stream) {
  decode_attention_int4_kernel<D><<<dim3(H, B), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_all),
      static_cast<const int8_t*>(v_all), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const bool*>(mask),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      layer, B, H, Hkv, cap, cap_pad);
  return cudaGetLastError();
}

}  // namespace

// Message for an error code returned by the entry point.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C interface, loaded with ctypes by moshi_tpu_torch/ops/int4_attention.py.
// acc, m, l are f32 outputs of B*H*D, B*H and B*H elements.  Returns
// cudaGetLastError() after the launch.
extern "C" int decode_attention_int4(const void* q, const void* k_all, const void* v_all,
                                     const void* k_scale, const void* v_scale,
                                     const void* mask, void* acc, void* m, void* l,
                                     int layer, int B, int H, int Hkv, int D, int cap,
                                     int cap_pad, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || cap > cap_pad || cap_pad % 4 != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k_all, v_all, k_scale, v_scale, mask, acc, m,
                                         l, layer, B, H, Hkv, cap, cap_pad, s));
    case 128:
      return static_cast<int>(launch<128>(q, k_all, v_all, k_scale, v_scale, mask, acc, m,
                                          l, layer, B, H, Hkv, cap, cap_pad, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
