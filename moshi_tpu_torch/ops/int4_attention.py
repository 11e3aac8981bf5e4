"""Flash decode over the int4-packed KV cache and its in-place cache write:
the wrappers of the CUDA kernels `csrc/decode_attention_int4.cu` and
`csrc/cache_write_int4.cu`, and their plain PyTorch versions.

Counterpart of moshi_tpu/ops/int4_attention.py (`decode_attention_int4_stats`,
`cache_write_int4`), in its layout:
- k_all, v_all int8 [L, B, Hkv*D/2, cap_pad]: the byte at (row r, lane s) of
  a slot holds channels 2r (low nibble) and 2r+1 (high nibble) of position
  s, each signed in [-7, 7];
- k_scale, v_scale bf16 [L, B, Hkv, cap_pad]: the per-(position, head)
  dequantization scales;
- cap_pad is the logical capacity rounded up to a multiple of 128; the pad
  lanes are never attended.

The attention kernel's blocks take the query heads of one slot that share
a KV head (up to 8, the n8 side of its tensor-core tiles), and their warps
split the positions in chunks of CHUNK; `plan_warps` sizes the blocks so
that the grid fits on the card at once.  On CPU tensors the wrappers run
the plain versions; on CUDA tensors they launch the kernels or raise.
"""

import math

import torch

from ..utils.quantize import unpack_nibbles
from . import build
from .q4matmul import _num_sms

HEAD_DIMS = (64, 128)  # the kernel's template instances
MASKED = -1e30         # score of a masked lane, as in the JAX package
CHUNK = 64             # decode_attention_int4.cu kChunk: positions of a warp's step
MAX_WARPS = 8          # decode_attention_int4.cu kMaxWarps: warps of a block
HEADS_PER_BLOCK = 8    # decode_attention_int4.cu kHeads: query heads of a block
SMEM_LIMIT = 48 * 1024  # shared memory a launch takes without opting in
# plan_warps gives each SM at most this many warps: the kernel's registers
# (ptxas on the H100, PERF.md) let 16 warps share an SM
WARPS_PER_SM = 16


def attention_blocks(B: int, H: int, Hkv: int) -> int:
    """Blocks of a launch: one per slot, KV head and group of up to
    HEADS_PER_BLOCK query heads that read it."""
    return B * Hkv * -(-(H // Hkv) // HEADS_PER_BLOCK)


def smem_bytes(D: int, warps: int) -> int:
    """decode_attention_int4.cu smem_bytes: the warps' partials."""
    return 4 * warps * HEADS_PER_BLOCK * (D + 2)


def plan_warps(B: int, H: int, Hkv: int, cap: int, num_sms: int) -> int:
    """Warps of a block: the most (at most MAX_WARPS, and no more than the
    cap's chunks of CHUNK positions) that keep the grid within WARPS_PER_SM
    warps per SM, so that every block is resident at once; at least 1."""
    fit = WARPS_PER_SM * num_sms // attention_blocks(B, H, Hkv)
    return max(1, min(MAX_WARPS, -(-cap // CHUNK), fit))


def _dequant_layer(packed: torch.Tensor, scale: torch.Tensor, cap: int) -> torch.Tensor:
    """One layer's packed cache [B, Hkv*D/2, cap_pad] and scales [B, Hkv,
    cap_pad] -> f32 [B, Hkv, D, cap] (the JAX package's
    `_unpack_int4_channel_major` times the scales)."""
    B, hd2, _ = packed.shape
    Hkv = scale.shape[1]
    low, high = unpack_nibbles(packed[..., :cap])
    vals = torch.stack([low, high], dim=2).reshape(B, Hkv, 2 * hd2 // Hkv, cap)
    return vals.float() * scale[..., :cap].float()[:, :, None, :]


def decode_attention_int4_stats_plain(q, layer, k_all, v_all, k_scale, v_scale, mask):
    """The JAX package's dense fallback (moshi_tpu transformer.py:886-904):
    dequantize the layer in f32, scores over the logical capacity, masked
    lanes at -1e30, softmax statistics."""
    B, H, _, D = q.shape
    cap = mask.shape[-1]
    rep = H // k_scale.shape[2]
    kf = _dequant_layer(k_all[layer], k_scale[layer], cap).repeat_interleave(rep, dim=1)
    vf = _dequant_layer(v_all[layer], v_scale[layer], cap).repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhd,bhds->bhs", q[:, :, 0].float(), kf) / math.sqrt(D)
    scores = torch.where(mask[:, None, :], scores, MASKED)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return torch.einsum("bhs,bhds->bhd", p, vf), m, p.sum(dim=-1, keepdim=True)


def _check_attention(q, k_all, v_all, k_scale, v_scale, mask):
    devs = {t.device for t in (q, k_all, v_all, k_scale, v_scale, mask)}
    if len(devs) != 1:
        raise ValueError(f"decode_attention_int4: tensors on {sorted(map(str, devs))}")
    if q.ndim != 4 or q.shape[2] != 1 or k_all.ndim != 4 or k_scale.ndim != 4:
        raise ValueError(f"decode_attention_int4: shapes q {tuple(q.shape)}, k_all "
                         f"{tuple(k_all.shape)}, k_scale {tuple(k_scale.shape)}")
    B, H, _, D = q.shape
    L, _, hd2, cap_pad = k_all.shape
    Hkv = k_scale.shape[2]
    if (tuple(v_all.shape) != tuple(k_all.shape)
            or tuple(k_scale.shape) != (L, B, Hkv, cap_pad)
            or tuple(v_scale.shape) != tuple(k_scale.shape)
            or k_all.shape[1] != B or H % Hkv or 2 * hd2 != Hkv * D
            or mask.ndim != 2 or mask.shape[0] != B or not 0 < mask.shape[1] <= cap_pad):
        raise ValueError(f"decode_attention_int4: q {tuple(q.shape)}, caches "
                         f"{tuple(k_all.shape)}, scales {tuple(k_scale.shape)}, mask "
                         f"{tuple(mask.shape)} do not fit together")
    if k_all.dtype != torch.int8 or v_all.dtype != torch.int8 or mask.dtype != torch.bool:
        raise TypeError(f"decode_attention_int4: caches {k_all.dtype}, {v_all.dtype}, "
                        f"mask {mask.dtype}")
    if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
        raise TypeError(f"decode_attention_int4: scales {k_scale.dtype}, {v_scale.dtype}")


def decode_attention_int4_stats(q, layer: int, k_all, v_all, k_scale, v_scale, mask):
    """Unnormalized flash attention of q [B, H, 1, D] (rope'd, unscaled)
    over layer `layer` of the packed cache; mask [B, cap] bool over the
    logical capacity.  Query head h reads KV head h // (H // Hkv).  Returns
    (acc [B, H, D], m [B, H, 1], l [B, H, 1]) in f32: the caller merges
    further rows with the flash rule and divides by l."""
    _check_attention(q, k_all, v_all, k_scale, v_scale, mask)
    if q.device.type == "cpu":
        return decode_attention_int4_stats_plain(q, layer, k_all, v_all, k_scale, v_scale,
                                                 mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int4: unsupported device {q.device}")
    B, H, _, D = q.shape
    L, _, _, cap_pad = k_all.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_int4: head dim {D} not in {HEAD_DIMS}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode_attention_int4: q {q.dtype} on the card, the kernel takes "
                        f"bf16")
    if not 0 <= layer < L:
        raise ValueError(f"decode_attention_int4: layer {layer} outside 0..{L - 1}")
    if cap_pad % 128:
        raise ValueError(f"decode_attention_int4: cap_pad {cap_pad} not a multiple of 128")
    if not all(t.is_contiguous() for t in (q, k_all, v_all, k_scale, v_scale, mask)):
        raise ValueError("decode_attention_int4: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (k_all, v_all, k_scale, v_scale)):
        raise ValueError("decode_attention_int4: caches and scales must be 16-byte aligned")
    Hkv, cap = k_scale.shape[2], mask.shape[1]
    warps = plan_warps(B, H, Hkv, cap, _num_sms(q.device.index or 0))
    acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    lse = torch.empty_like(m)
    lib = build.load("decode_attention_int4")
    err = lib.decode_attention_int4(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), mask.data_ptr(), acc.data_ptr(), m.data_ptr(), lse.data_ptr(),
        int(layer), B, H, Hkv, D, cap, cap_pad, warps,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attention_int4")
    decode_attention_int4_stats.launches += 1
    return acc, m, lse


decode_attention_int4_stats.launches = 0


def cache_write_int4_plain(pos, kcols, vcols, kscols, vscols, k_all, v_all, ks_all, vs_all):
    """Advanced-index assignment, as the JAX package's dynamic-update-slice
    fallback (moshi_tpu transformer.py:840-850)."""
    b = torch.arange(kcols.shape[1], device=pos.device)
    k_all[:, b, :, pos] = kcols.transpose(0, 1)
    v_all[:, b, :, pos] = vcols.transpose(0, 1)
    ks_all[:, b, :, pos] = kscols.transpose(0, 1)
    vs_all[:, b, :, pos] = vscols.transpose(0, 1)
    return k_all, v_all, ks_all, vs_all


def _check_write(pos, kcols, vcols, kscols, vscols, k_all, v_all, ks_all, vs_all):
    ts = (pos, kcols, vcols, kscols, vscols, k_all, v_all, ks_all, vs_all)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"cache_write_int4: tensors on {sorted(map(str, devs))}")
    if k_all.ndim != 4 or ks_all.ndim != 4 or kcols.ndim != 3 or kscols.ndim != 3:
        raise ValueError(f"cache_write_int4: caches {tuple(k_all.shape)}, "
                         f"{tuple(ks_all.shape)}, columns {tuple(kcols.shape)}")
    L, B, hd2, cap_pad = k_all.shape
    Hkv = ks_all.shape[2]
    if (tuple(v_all.shape) != tuple(k_all.shape)
            or tuple(ks_all.shape) != (L, B, Hkv, cap_pad)
            or tuple(vs_all.shape) != tuple(ks_all.shape)
            or tuple(kcols.shape) != (L, B, hd2) or tuple(vcols.shape) != (L, B, hd2)
            or tuple(kscols.shape) != (L, B, Hkv) or tuple(vscols.shape) != (L, B, Hkv)
            or tuple(pos.shape) != (B,)):
        raise ValueError("cache_write_int4: columns, positions and caches do not fit "
                         "together")
    if not (k_all.dtype == v_all.dtype == kcols.dtype == vcols.dtype == torch.int8
            and ks_all.dtype == vs_all.dtype == kscols.dtype == vscols.dtype
            == torch.bfloat16 and pos.dtype == torch.int64):
        raise TypeError("cache_write_int4: caches and columns int8, scales bf16, "
                        "positions int64")


def cache_write_int4(pos, kcols, vcols, kscols, vscols, k_all, v_all, ks_all, vs_all):
    """Write one frame's packed columns kcols/vcols [L, B, Hkv*D/2] int8
    and scales kscols/vscols [L, B, Hkv] bf16 at lane pos[b] of every layer
    of slot b, in place, for every slot (frozen ones too).  Returns the four
    caches."""
    args = (pos, kcols, vcols, kscols, vscols, k_all, v_all, ks_all, vs_all)
    _check_write(*args)
    if pos.device.type == "cpu":
        return cache_write_int4_plain(*args)
    if pos.device.type != "cuda":
        raise ValueError(f"cache_write_int4: unsupported device {pos.device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("cache_write_int4: operands must be contiguous")
    L, B, hd2, cap_pad = k_all.shape
    lib = build.load("cache_write_int4")
    err = lib.cache_write_int4(*(t.data_ptr() for t in args), L, B, hd2, ks_all.shape[2],
                               cap_pad, torch.cuda.current_stream(pos.device).cuda_stream)
    build.check(lib, err, "cache_write_int4")
    cache_write_int4.launches += 1
    return k_all, v_all, ks_all, vs_all


cache_write_int4.launches = 0
