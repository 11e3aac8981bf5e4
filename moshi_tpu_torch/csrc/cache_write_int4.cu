// cache_write_int4: write one frame's packed K/V columns and scales into the
// int4 KV cache, in place, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel moshi_tpu/ops/int4_attention.py
// `cache_write_int4` (`_write_kernel`), which rewrote the 128-lane tile
// holding each slot's ring lane because a TPU block cannot address one lane.
// Here a thread writes its byte where it belongs.
//
// For every layer l and slot b, at lane pos[b] (frozen slots too, as in the
// JAX package: their offset does not advance, so their next executed step
// overwrites the lane):
//   k_all[l, b, :, pos[b]]  = kcols[l, b, :]    int8, Hkv*D/2 rows
//   v_all[l, b, :, pos[b]]  = vcols[l, b, :]
//   ks_all[l, b, :, pos[b]] = kscols[l, b, :]   bf16, Hkv rows
//   vs_all[l, b, :, pos[b]] = vscols[l, b, :]
// A position outside [0, cap_pad) writes nothing.
//
// What bounds it: it reads and writes ~2.2 MB each per frame at Moshi-7B
// shapes and B = 16 (32 layers x 16 slots x (2 x 2048 bytes + 2 x 32 bf16
// scales)): ~1.3 us at 3.35 TB/s, below the latency of one launch, which is
// what it costs.  In this layout each byte of a column lies cap_pad bytes
// from the next, so every byte is a 32-byte sector of its own (~67 MB of
// sector traffic per frame); a layout with positions outside the rows is
// for the kernel's redesign.
//
// Design: grid (L, B), one block per (layer, slot); its threads stride over
// the column's rows.  One launch per frame replaces the 4 x B x L scattered
// copies of the plain version.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) cache_write_int4_kernel(
    const int64_t* __restrict__ pos, const int8_t* __restrict__ kcols,
    const int8_t* __restrict__ vcols, const __nv_bfloat16* __restrict__ kscols,
    const __nv_bfloat16* __restrict__ vscols, int8_t* __restrict__ k_all,
    int8_t* __restrict__ v_all, __nv_bfloat16* __restrict__ ks_all,
    __nv_bfloat16* __restrict__ vs_all, int hd2, int Hkv, int cap_pad) {
  const int l = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int64_t p = pos[b];
  if (p < 0 || p >= cap_pad) return;
  const size_t slot = static_cast<size_t>(l) * B + b;
  for (int r = threadIdx.x; r < hd2; r += kThreads) {
    const size_t dst = (slot * hd2 + r) * cap_pad + p;
    k_all[dst] = kcols[slot * hd2 + r];
    v_all[dst] = vcols[slot * hd2 + r];
  }
  for (int r = threadIdx.x; r < Hkv; r += kThreads) {
    const size_t dst = (slot * Hkv + r) * cap_pad + p;
    ks_all[dst] = kscols[slot * Hkv + r];
    vs_all[dst] = vscols[slot * Hkv + r];
  }
}

}  // namespace

// Message for an error code returned by the entry point.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C interface, loaded with ctypes by moshi_tpu_torch/ops/int4_attention.py.
// pos int64 [B]; kcols, vcols int8 [L, B, hd2]; kscols, vscols bf16 [L, B,
// Hkv]; the caches as above.  Returns cudaGetLastError() after the launch.
extern "C" int cache_write_int4(const void* pos, const void* kcols, const void* vcols,
                                const void* kscols, const void* vscols, void* k_all,
                                void* v_all, void* ks_all, void* vs_all, int L, int B,
                                int hd2, int Hkv, int cap_pad, void* stream) {
  cache_write_int4_kernel<<<dim3(L, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(pos), static_cast<const int8_t*>(kcols),
      static_cast<const int8_t*>(vcols), static_cast<const __nv_bfloat16*>(kscols),
      static_cast<const __nv_bfloat16*>(vscols), static_cast<int8_t*>(k_all),
      static_cast<int8_t*>(v_all), static_cast<__nv_bfloat16*>(ks_all),
      static_cast<__nv_bfloat16*>(vs_all), hd2, Hkv, cap_pad);
  return static_cast<int>(cudaGetLastError());
}
