"""Flash decode over the int4-packed KV cache, and the in-place write of
the layer's new column: the wrappers of the CUDA kernel
`csrc/decode_attention_int4.cu` and their plain PyTorch versions.

Counterpart of moshi_tpu/ops/int4_attention.py (`decode_attention_int4_stats`,
`cache_write_int4`) and of the quantization of moshi_tpu
modules/transformer.py (`_quant_rows_int4`, `_pack_nibble_cols`), in the
JAX package's layout:
- k_all, v_all int8 [L, B, Hkv*D/2, cap_pad]: the byte at (row r, lane s) of
  a slot holds channels 2r (low nibble) and 2r+1 (high nibble) of position
  s, each signed in [-7, 7];
- k_scale, v_scale bf16 [L, B, Hkv, cap_pad]: the per-(position, head)
  dequantization scales;
- cap_pad is the logical capacity rounded up to a multiple of 128; the pad
  lanes are never attended.

The kernel's blocks take the query heads of one slot that share a KV head
(up to 8, the n8 side of its tensor-core tiles), and their warps split the
positions in chunks of CHUNK; `plan_warps` sizes the blocks so that the
grid fits on the card at once.  `decode_attention_int4_write` is the
decode step's op: the same launch also quantizes the layer's current K/V
rows and stores them at the slot's ring lane (the JAX package's
`cache_write_int4`, there one launch for all layers after the layer scan).
`decode_attention_int4_stats` is the attention alone.  On CPU tensors the
wrappers run the plain versions; on CUDA tensors they launch the kernel or
raise.
"""

import math

import torch

from ..utils.quantize import divide, unpack_nibbles
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


def _launch(q, layer, k_all, v_all, k_scale, v_scale, mask, rows=None):
    """One launch of the kernel; rows = (kk, vv, pos) adds the write."""
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
    kk_ptr = vv_ptr = pos_ptr = None
    kk_stride = vv_stride = 0
    if rows is not None:
        kk, vv, pos = rows
        if H // Hkv > HEADS_PER_BLOCK:
            raise ValueError(f"decode_attention_int4_write: {H // Hkv} query heads per KV "
                             f"head, more than the {HEADS_PER_BLOCK} of a block: another "
                             f"block would read the lane while it is written")
        if kk.dtype != torch.bfloat16 or vv.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention_int4_write: rows {kk.dtype}, {vv.dtype} on "
                            f"the card, the kernel takes bf16")
        if any(t.stride(2) != 1 or t.stride(1) != D for t in (kk, vv)):
            raise ValueError("decode_attention_int4_write: each slot's rows must be "
                             "contiguous [Hkv, D]")
        if not pos.is_contiguous():
            raise ValueError("decode_attention_int4_write: pos must be contiguous")
        kk_ptr, vv_ptr, pos_ptr = kk.data_ptr(), vv.data_ptr(), pos.data_ptr()
        kk_stride, vv_stride = kk.stride(0), vv.stride(0)
    warps = plan_warps(B, H, Hkv, cap, _num_sms(q.device.index or 0))
    acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    lse = torch.empty_like(m)
    lib = build.load("decode_attention_int4")
    err = lib.decode_attention_int4(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), mask.data_ptr(), kk_ptr, vv_ptr, pos_ptr, acc.data_ptr(),
        m.data_ptr(), lse.data_ptr(), int(layer), B, H, Hkv, D, cap, cap_pad, warps,
        kk_stride, vv_stride, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attention_int4")
    decode_attention_int4_stats.launches += 1
    return acc, m, lse


def decode_attention_int4_stats(q, layer: int, k_all, v_all, k_scale, v_scale, mask):
    """Unnormalized flash attention of q [B, H, 1, D] (rope'd, unscaled)
    over layer `layer` of the packed cache; mask [B, cap] bool over the
    logical capacity.  Query head h reads KV head h // (H // Hkv).  Returns
    (acc [B, H, D], m [B, H, 1], l [B, H, 1]) in f32: the caller merges
    further rows with the flash rule and divides by l.  `.launches` counts
    every launch of the kernel, decode_attention_int4_write's too."""
    _check_attention(q, k_all, v_all, k_scale, v_scale, mask)
    if q.device.type == "cpu":
        return decode_attention_int4_stats_plain(q, layer, k_all, v_all, k_scale, v_scale,
                                                 mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int4: unsupported device {q.device}")
    return _launch(q, layer, k_all, v_all, k_scale, v_scale, mask)


decode_attention_int4_stats.launches = 0


def _quant_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 quantization per (batch, time, head) row of [B, T, H,
    D]: values in [-7, 7] as int8 and the f32 scale [B, T, H, 1].
    torch.round rounds half to even, as jnp.round does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = divide(amax.clamp(min=1e-6), 7.0)
    return torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int8), scale


def _pack_nibble_cols(vals: torch.Tensor) -> torch.Tensor:
    """int4 values [B, H*D] (one position's channels) -> channel-pair
    packed bytes [B, H*D/2]: channel 2r in the low nibble, 2r+1 in the
    high."""
    return (vals[:, 1::2] << 4) | (vals[:, 0::2] & 15)


def cache_write_int4_plain(pos, kcols, vcols, kscols, vscols, k_all, v_all, ks_all, vs_all):
    """Write packed columns kcols/vcols [L, B, Hkv*D/2] int8 and scales
    kscols/vscols [L, B, Hkv] bf16 at lane pos[b] of every layer of slot b,
    in place, for every slot (frozen ones too); a position outside [0,
    cap_pad) writes nothing (its slot's lane 0 or cap_pad - 1 gets its own
    bytes back, so nothing waits on the host).  Advanced-index assignment,
    as the JAX package's dynamic-update-slice fallback (moshi_tpu
    transformer.py:840-850).  Returns the four caches."""
    cap_pad = k_all.shape[-1]
    keep = ((pos >= 0) & (pos < cap_pad))[:, None, None]
    b, p = torch.arange(pos.shape[0], device=pos.device), pos.clamp(0, cap_pad - 1)
    for col, cache in ((kcols, k_all), (vcols, v_all), (kscols, ks_all), (vscols, vs_all)):
        cache[:, b, :, p] = torch.where(keep, col.transpose(0, 1), cache[:, b, :, p])
    return k_all, v_all, ks_all, vs_all


def int4_columns(kk, vv):
    """The current rows kk, vv [B, Hkv, D] as the cache stores them (the
    JAX package's `_int4_attention` columns): packed int8 [1, B, Hkv*D/2]
    each and bf16 scales [1, B, Hkv] each, one layer's worth."""
    B = kk.shape[0]
    (kq, ks), (vq, vs) = _quant_rows_int4(kk[:, None]), _quant_rows_int4(vv[:, None])
    return ([_pack_nibble_cols(x.reshape(B, -1))[None] for x in (kq, vq)]
            + [x[None, :, 0, :, 0].to(torch.bfloat16) for x in (ks, vs)])


def decode_attention_int4_write_plain(q, kk, vv, pos, layer, k_all, v_all, k_scale, v_scale,
                                      mask):
    """The JAX package's order (moshi_tpu transformer.py:828-921): quantize
    and pack the current rows, attend over the layer with the dense
    fallback, then write the layer's column (the JAX package writes every
    layer's after the scan, which gives the same cache)."""
    cols = int4_columns(kk, vv)
    out = decode_attention_int4_stats_plain(q, layer, k_all, v_all, k_scale, v_scale, mask)
    at = slice(layer, layer + 1)
    cache_write_int4_plain(pos, *cols, k_all[at], v_all[at], k_scale[at], v_scale[at])
    return out


def _check_rows(q, kk, vv, pos, k_scale):
    devs = {t.device for t in (q, kk, vv, pos)}
    if len(devs) != 1:
        raise ValueError(f"decode_attention_int4_write: tensors on {sorted(map(str, devs))}")
    B, _, _, D = q.shape
    Hkv = k_scale.shape[2]
    if (tuple(kk.shape) != (B, Hkv, D) or tuple(vv.shape) != (B, Hkv, D)
            or tuple(pos.shape) != (B,)):
        raise ValueError(f"decode_attention_int4_write: rows {tuple(kk.shape)}, "
                         f"{tuple(vv.shape)} and pos {tuple(pos.shape)} do not fit q "
                         f"{tuple(q.shape)} and {Hkv} KV heads")
    if pos.dtype != torch.int64:
        raise TypeError(f"decode_attention_int4_write: pos {pos.dtype}, not int64")


def decode_attention_int4_write(q, kk, vv, pos, layer: int, k_all, v_all, k_scale, v_scale,
                                mask):
    """decode_attention_int4_stats of q over layer `layer`, and in the same
    launch the write of that layer's column: the current rows kk, vv [B,
    Hkv, D] (rope'd) quantized to int4 and stored with their bf16 scales at
    lane pos[b] (int64 [B]) of slot b, in place, for every slot (frozen
    ones too); a position outside [0, cap_pad) writes nothing.  The mask
    must hide lane pos[b] from the pass (the lane holds a stale row).
    Returns (acc, m, l) of the cache as it was before the write.  On the
    card it needs H / Hkv <= HEADS_PER_BLOCK.  `.launches` counts its
    launches."""
    _check_attention(q, k_all, v_all, k_scale, v_scale, mask)
    _check_rows(q, kk, vv, pos, k_scale)
    if q.device.type == "cpu":
        return decode_attention_int4_write_plain(q, kk, vv, pos, layer, k_all, v_all, k_scale,
                                                 v_scale, mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int4_write: unsupported device {q.device}")
    out = _launch(q, layer, k_all, v_all, k_scale, v_scale, mask, rows=(kk, vv, pos))
    decode_attention_int4_write.launches += 1
    return out


decode_attention_int4_write.launches = 0
