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
// f32: s = (q . k_int) * k_scale / sqrt(D); a softmax over the masked-in
// positions; out = sum_s p_s * v_scale_s * v_int_s / max(l, 1e-20).  A slot
// with every position masked (a frozen slot before its first executed
// frame) gives 0, as the TPU kernel's max(l, 1e-20) does.
//
// What bounds it: every cache byte feeds 2 multiply-adds per query head
// sharing it, ~4 flops per byte, far below the card's ~295 flop/byte
// balance point, so it is bound by device-memory bandwidth: at the ASR
// path's B = 256, H = 8, cap 750, D = 128 and at Moshi's B = 16, H = 32,
// cap 3000 one launch reads ~393 MB of K/V and ~6 MB of scales (~0.12 ms at
// 3.35 TB/s).  Every position is read, masked or not.
//
// Design (flash-decoding):
//  - a block takes 512 / D query heads of one slot (4 at D = 128, 8 at 64):
//    inside each warp, group j of kGroup = D / 16 lanes walks head j, and
//    lane c of a group owns channels 16c .. 16c + 15.  So one 16-byte load
//    per lane reads one position's rows of all the block's heads, side by
//    side in the ring, and one 2-byte load per lane reads their scales from
//    one 32-byte sector (one head per block took a sector per scale, and
//    the scale reads cost 6-12% of the time: PERF.md);
//  - the block's warps split the positions (warp w takes tiles w, w +
//    warps, .. of kLoads positions), and every group of every warp keeps
//    its own online softmax (m, l, acc[16]): no barrier of any kind is in
//    the position loop.  A score is the group's 16-channel partial dots
//    summed with log2(kGroup) shuffles;
//  - each lane loads the K and V rows, both scales and the mask byte of
//    its next tile before the current tile's arithmetic (in registers):
//    V and the scales do not wait for the scores;
//  - int8 -> f32 with no convert instruction: a byte permute puts the
//    biased byte u = v ^ 0x80 = v + 128 under the exponent of 2^23 (f32
//    bits 0x4B0000uu = 2^23 + u) and one FADD takes 2^23 + 128 off, giving
//    v exactly (int8_mma.cu does the same);
//  - where B * H is too small to fill the card (ops/decode_attention.py
//    plan_splits), the positions are also split over `splits` blocks of
//    contiguous ranges that form a thread block cluster; the main paths'
//    grids fill the card unsplit (the clusters were slower there);
//  - the partials merge once, at the end, in a fixed order: each (m, l,
//    acc) is rescaled by exp2(m - max m) (0 where m = -inf, a walker that
//    saw no masked-in position, so an empty split gives no NaN) and summed.
//    The warps' partials go through shared memory (one barrier); with
//    splits, each block's merged partial is stored into rank 0's shared
//    memory (distributed shared memory) and after one cluster barrier rank
//    0 adds them in rank order.  One launch, no workspace, the same bits
//    every run.
// Scores are kept in the log2 domain (the 1/sqrt(D) scale folded with
// log2(e)), so every exponential is one ex2.approx.
// No tensor cores: at ~4 flops per byte the CUDA cores keep up.
// Chosen by timing variants on the H100 (PERF.md): one tile loaded ahead
// beat two (128 registers), three (spills) and a cp.async ring in shared
// memory; blocks of the plan's warps beat split clusters at the main
// paths' shapes.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 16;            // warps of a block (ops/decode_attention.py MAX_WARPS)
constexpr int kLoads = 2;                // 16-byte K (and V) loads per lane per tile
constexpr int kVec = 16;                 // channels (bytes) a lane owns
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr uint32_t kBias = 0x80808080u;  // byte v -> v ^ 0x80 = v + 128
constexpr uint32_t kTwo23 = 0x4B000000u;  // f32 2^23
constexpr float kTwo23Plus128 = 8388736.0f;  // 2^23 + 128
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 16-byte row piece read once: not kept in L1.
__device__ __forceinline__ int4 load16(const int8_t* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// Byte t of a biased word as f32, exactly (see the note at the top).
__device__ __forceinline__ float byte_f32(uint32_t biased, int t) {
  return __uint_as_float(__byte_perm(biased, kTwo23, 0x7440u | t)) - kTwo23Plus128;
}

// What a lane holds of one tile: its 16 bytes of K and V at each of the
// tile's kLoads positions, their scales (bf16 bits) and whether each is
// masked in.
struct Tile {
  int4 k[kLoads], v[kLoads];
  uint32_t ks[kLoads], vs[kLoads];
  bool valid[kLoads];
};

// Query heads of a block: one per group of D / 16 lanes of a warp.
__host__ __device__ constexpr int heads_per_block(int D) { return 32 / (D / kVec); }

// Floats of a block's own shared memory: the warps' partials [warps][heads]
// (acc[D], then m and l).
__host__ __device__ __forceinline__ size_t local_floats(int D, int warps) {
  return static_cast<size_t>(warps) * heads_per_block(D) * (D + 2);
}

// Shared memory of a block, in floats: its own, then, with splits > 1, the
// ranks' partials [splits][heads] (used in rank 0).
__host__ __device__ __forceinline__ size_t smem_floats(int D, int warps, int splits) {
  return local_floats(D, warps) +
         static_cast<size_t>(splits > 1 ? splits : 0) * heads_per_block(D) * (D + 2);
}
constexpr size_t kSmemLimit = 48 * 1024;  // bytes a launch takes without opting in

// The cluster barrier in two halves (every thread of every block arrives).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (splits, ceil(H / heads), B) of `warps`-warp blocks, clusters of
// (splits, 1, 1).  Block (r, hb, b) takes query heads hb * heads .. of slot
// b (heads = heads_per_block(D)) over positions [r * per_split, min(cap,
// (r + 1) * per_split)); its warp w walks the tiles w, w + warps, .. of
// kLoads positions, and the group of lanes j of every warp walks head
// hb * heads + j.
template <int D>
__global__ void __launch_bounds__(32 * kMaxWarps) decode_attention_int8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_all,
    const int8_t* __restrict__ v_all, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const bool* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int layer, int B, int H, int Hkv, int cap,
    int per_split) {
  constexpr int kGroup = D / kVec;          // lanes of one walker
  constexpr int kHeads = heads_per_block(D);
  constexpr int kPart = kHeads * (D + 2);   // floats of one partial of the block's heads
  static_assert(D % kVec == 0 && 32 % kGroup == 0, "D must be 64 or 128");
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.x, splits = gridDim.x, b = blockIdx.z;
  const int warps = blockDim.x / 32;
  // this block has started; waited on before the first remote store
  if (splits > 1) cluster_arrive_relaxed();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cgp = lane % kGroup, j = lane / kGroup;
  const int h0 = blockIdx.y * kHeads;
  const int h = min(h0 + j, H - 1);         // a group past the last head repeats it
  const int g = h / (H / Hkv);
  const int s0 = rank * per_split, s1 = min(cap, s0 + per_split);
  const size_t stride = static_cast<size_t>(Hkv) * D;         // bytes between positions
  const size_t slot = static_cast<size_t>(layer) * B + b;
  const int8_t* kp = k_all + slot * cap * stride + static_cast<size_t>(g) * D + cgp * kVec;
  const int8_t* vp = v_all + slot * cap * stride + static_cast<size_t>(g) * D + cgp * kVec;
  const unsigned short* ksp =
      reinterpret_cast<const unsigned short*>(k_scale) + slot * cap * Hkv + g;
  const unsigned short* vsp =
      reinterpret_cast<const unsigned short*>(v_scale) + slot * cap * Hkv + g;
  const unsigned char* mp =
      reinterpret_cast<const unsigned char*>(mask) + static_cast<size_t>(b) * cap;
  const float score_scale = kLog2e * rsqrtf(static_cast<float>(D));

  float qv[kVec], acc[kVec];
  const __nv_bfloat16* qp = q + (static_cast<size_t>(b) * H + h) * D + cgp * kVec;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    qv[i] = __bfloat162float(qp[i]);
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // Tile t of the split is positions s0 + t * kLoads + i (i < kLoads), read
  // by every group for its own head: the warp's loads of one position take
  // the block's heads' D-byte rows side by side, and its scale loads one
  // sector.  Positions at or past s1 load nothing and are masked out.
  auto load_tile = [&](int t, Tile& tl) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int s = s0 + t * kLoads + i;
      const bool in = s < s1;
      tl.k[i] = in ? load16(kp + s * stride) : make_int4(0, 0, 0, 0);
      tl.v[i] = in ? load16(vp + s * stride) : make_int4(0, 0, 0, 0);
      tl.ks[i] = in ? __ldg(ksp + static_cast<size_t>(s) * Hkv) : 0u;
      tl.vs[i] = in ? __ldg(vsp + static_cast<size_t>(s) * Hkv) : 0u;
      tl.valid[i] = in && __ldg(mp + s) != 0;
    }
  };

  // the online softmax of the lane's head over one tile
  auto step = [&](const Tile& cur) {
    float sc[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const uint32_t w[4] = {cur.k[i].x ^ kBias, cur.k[i].y ^ kBias, cur.k[i].z ^ kBias,
                             cur.k[i].w ^ kBias};
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kVec; ++c) d[c % 4] = fmaf(qv[c], byte_f32(w[c / 4], c % 4), d[c % 4]);
      float dot = (d[0] + d[1]) + (d[2] + d[3]);
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sc[i] = cur.valid[i] ? dot * __uint_as_float(cur.ks[i] << 16) * score_scale : -INFINITY;
    }
    float m_new = m;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) m_new = fmaxf(m_new, sc[i]);
    // m = -inf and m_new finite: alpha = 0 (acc and l are 0 anyway); both
    // -inf: 1, and every p is 0 below, so nothing turns into NaN
    const float alpha = m_new == m ? 1.f : ex2(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] *= alpha;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const float p = cur.valid[i] ? ex2(sc[i] - m_new) : 0.f;
      l += p;
      const float pw = p * __uint_as_float(cur.vs[i] << 16);
      const uint32_t w[4] = {cur.v[i].x ^ kBias, cur.v[i].y ^ kBias, cur.v[i].z ^ kBias,
                             cur.v[i].w ^ kBias};
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[c] = fmaf(pw, byte_f32(w[c / 4], c % 4), acc[c]);
    }
    m = m_new;
  };

  const int ntiles = s1 > s0 ? (s1 - s0 + kLoads - 1) / kLoads : 0;
  // each tile's loads are issued one tile before its arithmetic
  Tile nxt;
  load_tile(warp, nxt);
  for (int t = warp; t < ntiles; t += warps) {
    const Tile cur = nxt;
    load_tile(t + warps, nxt);
    step(cur);
  }

  // ---- the warps' partials of each head, in shared memory
  float* part = smem + warp * kPart;        // [heads][D], then m, l [heads]
  float4* a4 = reinterpret_cast<float4*>(part + j * D + cgp * kVec);
#pragma unroll
  for (int c = 0; c < kVec / 4; ++c)
    a4[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
  if (cgp == 0) {
    part[kHeads * D + j] = m;
    part[kHeads * D + kHeads + j] = l;
  }
  __syncthreads();

  // ---- the block's partial of element e = (head e / D, channel e % D):
  // the warps' partials in warp order, each rescaled by exp2(m_w - max m)
  // (0 where m_w = -inf: a walker that saw no masked-in position)
  constexpr int kElems = kHeads * D;
  float* remote = nullptr;
  if (splits > 1) {
    cluster_wait();  // every block of the cluster has started
    remote = cg::this_cluster().map_shared_rank(smem, 0) + local_floats(D, warps) +
             static_cast<size_t>(rank) * kPart;
  }
  for (int e = threadIdx.x; e < kElems; e += blockDim.x) {
    const int hj = e / D, d = e % D;
    float mx = -INFINITY;
    for (int w = 0; w < warps; ++w) mx = fmaxf(mx, smem[w * kPart + kHeads * D + hj]);
    float a = 0.f, lt = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float* pw = smem + w * kPart;
      const float mw = pw[kHeads * D + hj];
      const float f = mw == -INFINITY ? 0.f : ex2(mw - mx);
      a = fmaf(f, pw[e], a);
      lt = fmaf(f, pw[kHeads * D + kHeads + hj], lt);
    }
    if (splits == 1) {
      if (h0 + hj < H)
        out[(static_cast<size_t>(b) * H + h0 + hj) * D + d] =
            __float2bfloat16(a / fmaxf(lt, 1e-20f));
    } else {  // into rank 0's slot of this rank
      remote[e] = a;
      if (d == 0) {
        remote[kElems + hj] = mx;
        remote[kElems + kHeads + hj] = lt;
      }
    }
  }
  if (splits == 1) return;
  cluster_arrive_release();
  cluster_wait();  // every rank's partial is in rank 0's shared memory
  if (rank != 0) return;

  // ---- rank 0: the ranks' partials in rank order, normalized
  const float* ranks = smem + local_floats(D, warps);
  for (int e = threadIdx.x; e < kElems; e += blockDim.x) {
    const int hj = e / D, d = e % D;
    if (h0 + hj >= H) break;
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r) mx = fmaxf(mx, ranks[r * kPart + kElems + hj]);
    float a = 0.f, lt = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* pr = ranks + r * kPart;
      const float mr = pr[kElems + hj];
      const float f = mr == -INFINITY ? 0.f : ex2(mr - mx);
      a = fmaf(f, pr[e], a);
      lt = fmaf(f, pr[kElems + kHeads + hj], lt);
    }
    out[(static_cast<size_t>(b) * H + h0 + hj) * D + d] = __float2bfloat16(a / fmaxf(lt, 1e-20f));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_all, const void* v_all,
                   const void* k_scale, const void* v_scale, const void* mask, void* out,
                   int layer, int B, int H, int Hkv, int cap, int per_split, int splits,
                   int warps, cudaStream_t stream) {
  constexpr int heads = heads_per_block(D);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (H + heads - 1) / heads, B);
  config.blockDim = dim3(32 * warps, 1, 1);
  config.dynamicSmemBytes = sizeof(float) * smem_floats(D, warps, splits);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, decode_attention_int8_kernel<D>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(k_all), static_cast<const int8_t*>(v_all),
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const bool*>(mask), static_cast<__nv_bfloat16*>(out), layer, B, H, Hkv,
      cap, per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Message for an error code returned by the entry point.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C interface, loaded with ctypes by moshi_tpu_torch/ops/decode_attention.py.
// out is a bf16 output of B*H*D elements.  Blocks of `warps` warps (1..16)
// take 512 / D query heads each; the positions of each block's heads are
// split over a cluster of `splits` blocks (1..8) of per_split positions
// each, and every split must hold at least one position ((splits - 1) *
// per_split < cap <= splits * per_split).  Anything else (or more than 48 KB
// of shared memory) returns cudaErrorInvalidValue and launches nothing.
// Returns the launch's error code.
extern "C" int decode_attention_int8(const void* q, const void* k_all, const void* v_all,
                                     const void* k_scale, const void* v_scale,
                                     const void* mask, void* out, int layer, int B, int H,
                                     int Hkv, int D, int cap, int per_split, int splits,
                                     int warps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || cap <= 0 || layer < 0 ||
      splits < 1 || splits > kMaxCluster || per_split <= 0 || warps < 1 ||
      warps > kMaxWarps || static_cast<long long>(splits - 1) * per_split >= cap ||
      static_cast<long long>(splits) * per_split < cap ||
      reinterpret_cast<uintptr_t>(k_all) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_all) % 16 != 0 ||
      (D != 64 && D != 128) || sizeof(float) * smem_floats(D, warps, splits) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      D == 64 ? launch<64>(q, k_all, v_all, k_scale, v_scale, mask, out, layer, B, H, Hkv, cap,
                           per_split, splits, warps, s)
              : launch<128>(q, k_all, v_all, k_scale, v_scale, mask, out, layer, B, H, Hkv,
                            cap, per_split, splits, warps, s));
}
