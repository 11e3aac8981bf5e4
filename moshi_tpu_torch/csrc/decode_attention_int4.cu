// decode_attention_int4: T = 1 flash decode over the int4-packed KV cache,
// for Hopper (sm_90a), and the in-place write of the layer's new column.
//
// Replaces two Pallas TPU kernels of moshi_tpu/ops/int4_attention.py:
// `decode_attention_int4_stats` (`_kernel` for D = 128, `_kernel_folded` for
// D < 128; one template covers both head dims here) and `cache_write_int4`
// (`_write_kernel`), which the JAX package runs once after the layer scan
// for every layer.  Here each layer's launch also quantizes the layer's
// current K and V rows and stores them at lane pos[b] (see "The write").
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
// Arithmetic, the TPU kernel's: q is scaled by 1/sqrt(D) in f32 and rounded
// to bf16; score = (q . k_int) * k_scale in f32, exactly -1e30 on masked
// positions; an online softmax; acc += bf16(p * v_scale) . v_int, both dots
// in bf16 with f32 sums.  Positions at or past cap do not exist for the
// softmax (p = 0), as in the dense version, so a slot with every position
// masked gives m = -1e30 and l = cap.
//
// What bounds it: every cache byte feeds 2 multiply-adds per query head
// sharing it, ~4 flops per byte at kv_repeat 1, far below the card's ~295
// flop/byte balance point, so device-memory bandwidth: at B = 16, H = 32,
// D = 128, cap 3000 a launch reads ~197 MB of packed K/V and ~6 MB of
// scales (~61 us at 3.35 TB/s).  The design this replaces did both dots on
// the CUDA cores, a few integer ops, an I2F and an FFMA per nibble, and
// read each row 32 bytes at a time: 0.157 ms (PERF.md).
//
// Design:
//  - both products on the tensor cores, mma.sync.m16n8k16 bf16 -> f32.  A
//    nibble becomes an exact bf16 in registers with no convert instruction:
//    the biased nibble u = v ^ 8 = v + 8 goes into the mantissa of bf16 128
//    (one LOP3 with a mask and the bits of 128), and one HSUB2 takes 136
//    off both halves, leaving v (q4_mma.cu does the same);
//  - scores: positions on the m16 side, channels on k16, the query heads
//    that share the KV head (up to 8) on n8.  One cache byte is a channel
//    pair of one position, i.e. exactly one bf16x2 register of the A
//    fragment;
//  - PV: channels on m16 (row 8t + i of a tile's rows gives the low nibble
//    to m-row i and the high one to m-row i + 8), positions on k16, heads on
//    n8.  Two positions of one channel are the same nibble of two bytes, so
//    a byte permute and masks of a word and its shifts give the A registers;
//  - the score tile's C fragment becomes PV's B fragment with one
//    movmatrix.trans per 8 x 8 half (the positions of a score tile are
//    ordered so that the transposed fragment lists PV's k slots), and the
//    PV accumulators hold the same heads per lane as the score C fragment,
//    so the online-softmax rescale needs no shuffle;
//  - chunks of kChunk = 64 positions: in the score pass lane (gid, tig)
//    reads the 8 bytes at 8*gid of rows tig + 4i (a warp: 64 contiguous
//    bytes of each of 4 rows per load), in the PV pass the 16 bytes at
//    16*tig of rows gid + 8i (64 contiguous bytes of each of 8 rows), and
//    the scales and mask of positions 8*gid .. 8*gid + 7.  With 32 bytes
//    of a row per warp load the kernel ran 9% slower, with 128 it spilled
//    registers and ran 18% slower (scripts/time_k4_variants.py, PERF.md);
//  - the block's warps split the chunks (warp w takes w, w + warps, ..),
//    each with its own online softmax, so no barrier sits in the position
//    loop.  A warp loads a chunk's K and V bytes, scales and mask together
//    and then works on them; loads read once bypass L1 and prefetch 256
//    bytes of the row into L2 for the block's other warps.  Loading the
//    next chunk into registers before this one's arithmetic spilled and
//    ran 2.7x slower; the kernel's loads alone take ~80% of its time;
//  - the warps' partials merge once at the end through shared memory in
//    warp order, each weighted by exp(m_w - max m): a warp whose positions
//    were all masked (m_w = -1e30 below a finite max) weighs 0, so nothing
//    becomes NaN and a call gives the same bits every run;
//  - one block per (slot, KV head, group of 8 query heads), its warp count
//    from ops/int4_attention.py `plan_warps` so the grid fits on the card at
//    once.  The layer is a pointer offset into the [L, ...] stack.
//
// The write (pos non-null): kk, vv bf16 [B, Hkv, D] are the layer's current
// rows (rope'd; a slot's heads D apart, slots kk_stride / vv_stride
// elements apart).  For each slot b with pos[b] in [0, cap_pad), frozen
// slots too, block (g, b) quantizes KV head g's two rows as the JAX
// package's `_quant_rows_int4` does, in IEEE f32 (no fast math, so the
// bytes equal the plain version's): amax over D by warp shuffles, scale =
// max(amax, 1e-6) / 7, values rint(x / scale) (half to even) clamped to
// [-7, 7], channel 2r in the low nibble of row r's byte and 2r + 1 in the
// high one.  It stores the D/2 bytes of each at lane pos[b] of layer
// `layer` (one byte per row) and the scales rounded to bf16.  The JAX
// package writes every layer's column after the scan; writing layer l's
// inside layer l's pass gives the same cache, because layer l's cache is
// read only by layer l's pass within a step and the pass masks lane pos[b].
//  - Who writes, and when: after the position loop and the block's
//    barrier, warp w* = (pos[b] / kChunk) % warps, the warp that loaded the
//    chunk holding the lane.  Nothing of the write is live across the loop
//    (123 registers at D = 128, as without it).
//  - What it costs: one byte store per row, and in this layout a column's
//    bytes lie cap_pad apart, so a launch dirties ~65K lone 32-byte sectors
//    at Moshi's B = 16 that go back to device memory one by one: ~8 us per
//    launch beside the ~0.09 ms attention.  The loads and quantization
//    alone cost ~0.3 us; storing right after w*'s step on that chunk, when
//    its sectors were just brought into L2, or with streaming (.cs) or
//    write-through (.wt) stores, cost the same (scripts/time_k4_variants.py,
//    PERF.md).
//  - Why nothing reads a stored address after the store: the bytes and
//    scales of (slot b, head g) at lane pos[b] are read only by block
//    (g, b), and in it only by warp w*'s loads of that chunk (the mask
//    hides the lane, but a slot with every position masked still weighs
//    it: p = 1, l = cap, as the plain order of attend, then write).  Every
//    load of the block feeds the partials it puts in shared memory before
//    the barrier (the K and V bytes through mma.sync, which no lane passes
//    before every lane's operands have arrived), and each scale is stored
//    by a lane that loaded it.  So the reads keep the read-only path
//    (`__restrict__ const`, ld.global.nc, no L1 allocation) and the stores
//    go through separate non-const pointers.  The next launch that reads
//    the lane sees the stored bytes: the non-coherent caches do not
//    outlive a launch.
//  - Only when one block reads a KV head (H / Hkv <= kHeads): with more,
//    blocks of other head groups read the lane while it is written, so the
//    C entry refuses a write there (no configuration of the repo has one).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemv_common.cuh"

namespace {

using gemv::mma_bf16;

constexpr int kMaxWarps = 8;             // ops/int4_attention.py MAX_WARPS
constexpr int kW = 8;                    // bytes of a K row a lane reads per chunk
constexpr int kChunk = 8 * kW;           // positions of a warp's step (CHUNK)
constexpr int kTiles = kW / 2;           // m16 score tiles (k16 PV steps) of a chunk
constexpr int kHeads = 8;                // query heads of a block: the n8 side
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kBias = 0x88888888u;         // nibble v -> v ^ 8 = v + 8
constexpr uint32_t kNibbles = 0x000F000Fu;      // the low nibble of each half
constexpr uint32_t kBf16Pair128 = 0x43004300u;  // bf16 (128, 128)
constexpr uint32_t kBf16Pair136 = 0x43084308u;  // bf16 (136, 136)

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// N bytes read once: not kept in L1, with a 256-byte L2 prefetch (the other
// warps of the block read the rest of the row's 256 bytes next).
template <int N>
__device__ __forceinline__ void load_bytes(const void* p, uint32_t (&w)[N / 4]) {
  static_assert(N == 4 || N == 8 || N % 16 == 0, "4, 8 or a multiple of 16 bytes");
  if constexpr (N == 4) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];" : "=r"(w[0]) : "l"(p));
  } else if constexpr (N == 8) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
        : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  } else {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
      asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
          : "=r"(w[4 * i]), "=r"(w[4 * i + 1]), "=r"(w[4 * i + 2]), "=r"(w[4 * i + 3])
          : "l"(static_cast<const char*>(p) + 16 * i));
  }
}

// Biased nibbles u in bits 0-3 and 16-19 of x (other bits anything) -> the
// bf16 pair (u_lo - 8, u_hi - 8), exactly.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t x) {
  uint32_t v = (x & kNibbles) | kBf16Pair128;
  uint32_t k = kBf16Pair136;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<__nv_bfloat162*>(&k));
  return *reinterpret_cast<uint32_t*>(&r);
}

// The 8 x 8 b16 fragment a lane holds (row lane / 4, columns 2 (lane % 4),
// + 1), transposed across the warp.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// One head's current row (D bf16 values, a warp's lanes taking D/32 channels
// each) quantized to int4 and stored at one lane of the packed cache: byte
// r of the column at dst + r * cap_pad, the bf16 scale at *scale_dst, by
// lane scale_lane.
template <int D>
__device__ __forceinline__ void store_column(const __nv_bfloat16* row, int8_t* dst,
                                             __nv_bfloat16* scale_dst, int cap_pad,
                                             int lane, int scale_lane) {
  constexpr int kC = D / 32;  // channels of a lane
  float x[kC];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    x[i] = __bfloat162float(row[kC * lane + i]);
    amax = fmaxf(amax, fabsf(x[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(amax, 1e-6f) / 7.0f;
#pragma unroll
  for (int r = 0; r < kC / 2; ++r) {
    const int lo = static_cast<int>(fminf(fmaxf(rintf(x[2 * r] / scale), -7.f), 7.f));
    const int hi = static_cast<int>(fminf(fmaxf(rintf(x[2 * r + 1] / scale), -7.f), 7.f));
    dst[static_cast<size_t>(kC / 2 * lane + r) * cap_pad] =
        static_cast<int8_t>(((hi & 15) << 4) | (lo & 15));
  }
  if (lane == scale_lane) *scale_dst = __float2bfloat16_rn(scale);
}

// What a lane (gid, tig) = (lane / 4, lane % 4) holds of one chunk, in two
// parts, each loaded just before it is used:
//  - Scores: k[i], bytes kW*gid .. kW*gid + kW - 1 of packed K row
//    8 (i / 2) + tig + 4 (i % 2); ks, vs, the bf16 scales of the same
//    kW positions (word w: positions 2w, 2w + 1); valid, exists, bit p for
//    position kW*gid + p: masked in / below cap;
//  - Values: v[i], bytes 2kW*tig .. 2kW*tig + 2kW - 1 of packed V row
//    8 i + gid.
// Tile j of the chunk orders its 16 positions so that m-row gid of the
// score tile is position kW*gid + 2j and m-row gid + 8 is kW*gid + 2j + 1
// (halfword j of the lane's K bytes).  Then k slots 2t and 2t + 8 of the PV
// tile are halfword j of the V bytes at kW*2t, and k slots 2t + 1 and
// 2t + 9 halfword j of those at kW*(2t + 1): the two halves of lane t's V
// load.
template <int D>
struct Scores {
  uint32_t k[D / 8][kW / 4];
  uint32_t ks[kW / 2], vs[kW / 2];
  uint32_t valid, exists;
};
template <int D>
struct Values {
  uint32_t v[D / 16][kW / 2];
};

// grid (Hkv * ceil(rep / kHeads), B) of `warps`-warp blocks, rep = H / Hkv.
// Block (x, b) takes query heads g * rep + hg * kHeads .. (up to kHeads of
// them, g = x / hgroups, hg = x % hgroups) of slot b, KV head g.  With pos
// non-null (and hgroups = 1) it also writes KV head g's column of slot b
// through k_w, v_w, ks_w, vs_w, the caches' addresses as stores see them.
template <int D>
__global__ void __launch_bounds__(32 * kMaxWarps, 2) decode_attention_int4_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_all,
    const int8_t* __restrict__ v_all, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const bool* __restrict__ mask,
    float* __restrict__ acc_out, float* __restrict__ m_out, float* __restrict__ l_out,
    const __nv_bfloat16* __restrict__ kk, const __nv_bfloat16* __restrict__ vv,
    const int64_t* __restrict__ pos, int8_t* k_w, int8_t* v_w, __nv_bfloat16* ks_w,
    __nv_bfloat16* vs_w, int layer, int B, int H, int Hkv, int cap, int cap_pad,
    int kk_stride, int vv_stride) {
  constexpr int kRows = D / 2;      // packed rows of one KV head
  constexpr int kSteps = D / 16;    // k16 steps of a score tile, m16 tiles of PV
  constexpr int kPart = kHeads * (D + 2);  // floats of a warp's partial
  extern __shared__ __align__(16) float smem[];

  const int rep = H / Hkv;
  const int hgroups = (rep + kHeads - 1) / kHeads;
  const int g = blockIdx.x / hgroups, hg = blockIdx.x % hgroups;
  const int b = blockIdx.y;
  const int h0 = g * rep + hg * kHeads;
  const int nh = min(kHeads, rep - hg * kHeads);   // heads of this block
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  const size_t slot = static_cast<size_t>(layer) * B + b;
  const size_t head_rows = (slot * Hkv + g) * kRows;
  const int8_t* kp = k_all + (head_rows + tig) * cap_pad + kW * gid;
  const int8_t* vp = v_all + (head_rows + gid) * cap_pad + 2 * kW * tig;
  const __nv_bfloat16* ksp = k_scale + (slot * Hkv + g) * cap_pad + kW * gid;
  const __nv_bfloat16* vsp = v_scale + (slot * Hkv + g) * cap_pad + kW * gid;
  const unsigned char* mp =
      reinterpret_cast<const unsigned char*>(mask) + static_cast<size_t>(b) * cap + kW * gid;
  // the mask read as 32-bit words where every slot's row is aligned
  const bool mask_words = cap % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;

  // The score tiles' B fragments: q of head h0 + gid at channels 16s + 2tig,
  // + 1 (b0) and 16s + 8 + 2tig, + 1 (b1); zero for a column past the heads.
  uint32_t qb[kSteps][2];
  {
    const float sqrt_d = sqrtf(static_cast<float>(D));
    const __nv_bfloat16* qp = q + (static_cast<size_t>(b) * H + h0 + gid) * D + 2 * tig;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float lo = 0.f, hi = 0.f;
        if (gid < nh) {  // q / sqrt(D) in f32, rounded to bf16 (the TPU kernel's qf)
          lo = __bfloat162float(qp[16 * s + 8 * half]) / sqrt_d;
          hi = __bfloat162float(qp[16 * s + 8 * half + 1]) / sqrt_d;
        }
        qb[s][half] = pack_bf16(lo, hi);
      }
  }

  const int nchunks = (cap + kChunk - 1) / kChunk;
  auto load_scores = [&](int base, Scores<D>& ch) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      load_bytes<kW>(kp + static_cast<size_t>(8 * (i / 2) + 4 * (i % 2)) * cap_pad + base,
                     ch.k[i]);
    load_bytes<2 * kW>(ksp + base, ch.ks);
    load_bytes<2 * kW>(vsp + base, ch.vs);
    const int n = min(max(cap - base - kW * gid, 0), kW);  // positions below cap
    uint32_t valid = 0;
    if (mask_words && n == kW) {
      // kW bools (bytes 0 or 1) -> kW bits: byte i of a word times 0x01020408
      // puts bit i of the sum in its top byte, with no carries
      const uint32_t* mw = reinterpret_cast<const uint32_t*>(mp + base);
#pragma unroll
      for (int w = 0; w < kW / 4; ++w) valid |= ((__ldg(mw + w) * 0x01020408u) >> 24) << (4 * w);
    } else {
      for (int p = 0; p < n; ++p)
        if (__ldg(mp + base + p)) valid |= 1u << p;
    }
    ch.valid = valid;
    ch.exists = (1u << n) - 1u;
  };
  auto load_values = [&](int base, Values<D>& ch) {
#pragma unroll
    for (int i = 0; i < D / 16; ++i)
      load_bytes<2 * kW>(vp + static_cast<size_t>(8 * i) * cap_pad + base, ch.v[i]);
  };

  // per lane: heads 2tig (index 0) and 2tig + 1 (index 1) of the block
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[kSteps][4];
#pragma unroll
  for (int t = 0; t < kSteps; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // The online softmax over one chunk; returns PV's B fragments in pb.
  auto softmax = [&](const Scores<D>& ch, uint32_t (&pb)[kTiles][2]) {
    // ---- scores of the chunk's tiles: sc[j][e], the C fragment of tile j
    float sc[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      // rows 8s + tig (channels 16s + 2tig, + 1) and 8s + tig + 4 (+ 8)
      uint32_t ku[2][kW / 4], kus[2][kW / 4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int w = 0; w < kW / 4; ++w) {
          ku[r][w] = ch.k[2 * s + r][w] ^ kBias;
          kus[r][w] = ku[r][w] >> 4;
        }
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        // byte 2j (m-row gid) and 2j + 1 (m-row gid + 8) of the rows
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t bt = 2 * (j % 2) + e;
            const uint32_t sel = bt | (bt << 4) | ((bt + 4) << 8) | ((bt + 4) << 12);
            a[2 * r + e] = nibbles_bf16(__byte_perm(ku[r][j / 2], kus[r][j / 2], sel));
          }
        mma_bf16(sc[j], a, qb[s][0], qb[s][1]);
      }
    }
    // ---- scale and mask: c0, c1 are position 2j, c2, c3 2j + 1 of the lane's
    float cmax[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = 2 * j + e / 2;
        const float ks = e < 2 ? bf16_lo(ch.ks[j]) : bf16_hi(ch.ks[j]);
        const float s = (ch.valid >> pos) & 1u ? sc[j][e] * ks : kMasked;
        sc[j][e] = s;
        if ((ch.exists >> pos) & 1u) cmax[e % 2] = fmaxf(cmax[e % 2], s);
      }
    float alpha[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        cmax[n] = fmaxf(cmax[n], __shfl_xor_sync(0xffffffffu, cmax[n], o));
      const float m_new = fmaxf(m[n], cmax[n]);
      alpha[n] = ex2((m[n] - m_new) * kLog2e);
      m[n] = m_new;
      l[n] *= alpha[n];
    }
#pragma unroll
    for (int t = 0; t < kSteps; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] *= alpha[e % 2];
    // ---- p, pw = bf16(p * v_scale), and PV's B fragments by transposition
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      float pw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = 2 * j + e / 2;
        const float p = (ch.exists >> pos) & 1u ? ex2((sc[j][e] - m[e % 2]) * kLog2e) : 0.f;
        l[e % 2] += p;
        pw[e] = p * (e < 2 ? bf16_lo(ch.vs[j]) : bf16_hi(ch.vs[j]));
      }
      pb[j][0] = transpose8x8(pack_bf16(pw[0], pw[1]));
      pb[j][1] = transpose8x8(pack_bf16(pw[2], pw[3]));
    }
  };

  // acc += V . pw: m16 tile t is channels 16t .. 16t + 15 (rows 8t + gid)
  auto pv = [&](const Values<D>& ch, const uint32_t (&pb)[kTiles][2]) {
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        // halfword j of both halves: k slots (2tig, 2tig + 8) and (2tig + 1,
        // 2tig + 9)
        const uint32_t w0 = ch.v[t][j / 2] ^ kBias, w1 = ch.v[t][kW / 4 + j / 2] ^ kBias;
        const uint32_t x = __byte_perm(w0, w1, j % 2 == 0 ? 0x5410u : 0x7632u);
        const uint32_t a[4] = {nibbles_bf16(x), nibbles_bf16(x >> 4), nibbles_bf16(x >> 8),
                               nibbles_bf16(x >> 12)};
        mma_bf16(acc[t], a, pb[j][0], pb[j][1]);
      }
    }
  };

  // The write of KV head g's column at lane p (see the header): from the
  // rows' addresses, the lane and blockIdx (g = blockIdx.x: one head group).
  // The lane of the warp that loaded the scales of p stores them.
  auto write_lane = [&](int p) {
    const size_t col = (static_cast<size_t>(layer) * B + blockIdx.y) * Hkv + blockIdx.x;
    const size_t rows_off = col * kRows * cap_pad + p, scale_off = col * cap_pad + p;
    const int scale_lane = 4 * ((p % kChunk) / kW);
    store_column<D>(kk + static_cast<size_t>(blockIdx.y) * kk_stride + blockIdx.x * D,
                    k_w + rows_off, ks_w + scale_off, cap_pad, lane, scale_lane);
    store_column<D>(vv + static_cast<size_t>(blockIdx.y) * vv_stride + blockIdx.x * D,
                    v_w + rows_off, vs_w + scale_off, cap_pad, lane, scale_lane);
  };

  for (int c = warp; c < nchunks; c += warps) {
    Scores<D> kpart;
    Values<D> vpart;
    load_scores(c * kChunk, kpart);
    load_values(c * kChunk, vpart);
    uint32_t pb[kTiles][2];
    softmax(kpart, pb);
    pv(vpart, pb);
  }

  // ---- this warp's partial: l summed over the lanes of a column
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l[n] += __shfl_xor_sync(0xffffffffu, l[n], o);
  float* part = smem + warp * kPart;   // acc [kHeads][D], then m, l [kHeads]
#pragma unroll
  for (int t = 0; t < kSteps; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(2 * tig + e % 2) * D + 16 * t + 2 * gid + e / 2] = acc[t][e];
  if (gid == 0) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      part[kHeads * D + 2 * tig + n] = m[n];
      part[kHeads * D + kHeads + 2 * tig + n] = l[n];
    }
  }
  __syncthreads();

  // ---- the write: every load of the block has fed the partials above
  if (pos != nullptr) {
    const int64_t p = pos[blockIdx.y];
    if (p >= 0 && p < cap_pad && warp == static_cast<int>(p / kChunk) % warps)
      write_lane(static_cast<int>(p));
  }

  // ---- the warps' partials in warp order, weighted by exp(m_w - max m)
  for (int e = threadIdx.x; e < nh * D; e += blockDim.x) {
    const int n = e / D, d = e % D;
    float mx = kMasked;
    for (int w = 0; w < warps; ++w) mx = fmaxf(mx, smem[w * kPart + kHeads * D + n]);
    float a = 0.f, lt = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float* pw = smem + w * kPart;
      const float f = ex2((pw[kHeads * D + n] - mx) * kLog2e);
      a = fmaf(f, pw[e], a);
      lt = fmaf(f, pw[kHeads * D + kHeads + n], lt);
    }
    const size_t bh = static_cast<size_t>(b) * H + h0 + n;
    acc_out[bh * D + d] = a;
    if (d == 0) {
      m_out[bh] = mx;
      l_out[bh] = lt;
    }
  }
}

// Shared memory of a block: the warps' partials.
__host__ __device__ constexpr size_t smem_bytes(int D, int warps) {
  return sizeof(float) * static_cast<size_t>(warps) * kHeads * (D + 2);
}

template <int D>
cudaError_t launch(const void* q, void* k_all, void* v_all, void* k_scale, void* v_scale,
                   const void* mask, const void* kk, const void* vv, const void* pos,
                   void* acc, void* m, void* l, int layer, int B, int H, int Hkv, int cap,
                   int cap_pad, int warps, int kk_stride, int vv_stride, cudaStream_t stream) {
  const int hgroups = (H / Hkv + kHeads - 1) / kHeads;
  decode_attention_int4_kernel<D><<<dim3(Hkv * hgroups, B), 32 * warps, smem_bytes(D, warps),
                                    stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_all),
      static_cast<const int8_t*>(v_all), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const bool*>(mask),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<const __nv_bfloat16*>(kk), static_cast<const __nv_bfloat16*>(vv),
      static_cast<const int64_t*>(pos), static_cast<int8_t*>(k_all),
      static_cast<int8_t*>(v_all), static_cast<__nv_bfloat16*>(k_scale),
      static_cast<__nv_bfloat16*>(v_scale), layer, B, H, Hkv, cap, cap_pad, kk_stride,
      vv_stride);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes by moshi_tpu_torch/ops/int4_attention.py.
// acc, m, l are f32 outputs of B*H*D, B*H and B*H elements.  Blocks of
// `warps` warps (1..8) split the positions.  pos null: the attention alone
// (kk, vv and the strides are not read).  pos int64 [B]: also the write of
// the rows kk, vv bf16 [B, Hkv, D] (slot strides kk_stride, vv_stride >=
// Hkv*D elements) at lane pos[b] of layer `layer`, in place; it needs
// H / Hkv <= 8.  The caches and scales must be 16-byte aligned and cap_pad a
// multiple of 64; anything else returns cudaErrorInvalidValue and launches
// nothing.  Returns the launch's error code.
extern "C" int decode_attention_int4(const void* q, void* k_all, void* v_all, void* k_scale,
                                     void* v_scale, const void* mask, const void* kk,
                                     const void* vv, const void* pos, void* acc, void* m,
                                     void* l, int layer, int B, int H, int Hkv, int D,
                                     int cap, int cap_pad, int warps, int kk_stride,
                                     int vv_stride, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || cap <= 0 || cap > cap_pad ||
      cap_pad % kChunk != 0 || layer < 0 || warps < 1 || warps > kMaxWarps ||
      misaligned(k_all) || misaligned(v_all) || misaligned(k_scale) || misaligned(v_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pos != nullptr && (kk == nullptr || vv == nullptr || H / Hkv > kHeads ||
                         kk_stride < Hkv * D || vv_stride < Hkv * D))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k_all, v_all, k_scale, v_scale, mask, kk, vv,
                                         pos, acc, m, l, layer, B, H, Hkv, cap, cap_pad,
                                         warps, kk_stride, vv_stride, s));
    case 128:
      return static_cast<int>(launch<128>(q, k_all, v_all, k_scale, v_scale, mask, kk, vv,
                                          pos, acc, m, l, layer, B, H, Hkv, cap, cap_pad,
                                          warps, kk_stride, vv_stride, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
