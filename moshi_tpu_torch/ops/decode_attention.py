"""Flash decode over the int8 ring KV cache: the wrapper of the CUDA kernel
`csrc/decode_attention_int8.cu` and its plain PyTorch version.

Counterpart of moshi_tpu/ops/decode_attention.py (`decode_attention_int8`),
on the layout of the int8 KV path of moshi_tpu's StreamingTransformer
instead of that experiment's head-major [B, H, S, D]:
- k_all, v_all int8 [L, B, cap, Hkv, D], the ring of every layer;
- k_scale, v_scale bf16 [L, B, cap, Hkv, 1], one scale per (position, head)
  row;
- mask [B, cap] bool, the positions each slot attends.

The kernel's blocks take a few query heads of one slot each, their warps
split the positions, and where there are too few blocks to fill the card
the positions are also split over a cluster of blocks (`plan_splits`); the
partial softmaxes merge in a fixed order in the same launch.  The plain
version can take the same split of the positions and merge.  On CPU tensors
the wrapper runs the plain version; on CUDA tensors it launches the kernel
or raises.
"""

import math

import torch

from . import build
from .q4matmul import _num_sms

HEAD_DIMS = (64, 128)  # the kernel's template instances
MAX_WARPS = 16         # decode_attention_int8.cu kMaxWarps: warps of a block
MAX_CLUSTER = 8        # decode_attention_int8.cu kMaxCluster: the portable cluster size
SPLIT_GRAIN = 16       # positions per split are a multiple of this
SMEM_LIMIT = 48 * 1024  # shared memory a launch takes without opting in
# plan_splits gives each SM about this many warps (measured on the H100:
# PERF.md), and splits the positions while the grid has fewer blocks than
# MIN_FILL of the SMs
WARPS_PER_SM = 16
MIN_FILL = 0.75


def heads_per_block(D: int) -> int:
    """Query heads of one block: one per group of D / 16 lanes of a warp."""
    return 512 // D


def smem_bytes(D: int, warps: int, splits: int) -> int:
    """decode_attention_int8.cu smem_floats, in bytes."""
    return 4 * (warps + (splits if splits > 1 else 0)) * heads_per_block(D) * (D + 2)


def split_length(cap: int, splits: int) -> int:
    """Positions per split when `splits` blocks share `cap` positions: a
    multiple of SPLIT_GRAIN, the last split the only short one."""
    per = -(-cap // splits)
    return -(-per // SPLIT_GRAIN) * SPLIT_GRAIN


def plan_splits(B: int, H: int, D: int, cap: int, num_sms: int) -> tuple[int, int, int]:
    """(splits, per_split, warps) of one launch.  A block takes
    heads_per_block(D) query heads of one slot, so there are B * ceil(H /
    heads) blocks to a split.  The positions are split (a cluster of
    `splits` blocks of per_split positions) only while the grid has fewer
    blocks than MIN_FILL of the SMs, at most MAX_CLUSTER times and never
    into an empty split; then a block gets the most warps (a power of two,
    at most MAX_WARPS) that keep the grid within WARPS_PER_SM warps per SM
    and its shared memory within SMEM_LIMIT, so that the grid fits on the
    card at once and no block waits for a last wave."""
    blocks = B * -(-H // heads_per_block(D))
    splits = 1
    while (blocks * splits < MIN_FILL * num_sms and splits < MAX_CLUSTER
           and -(-cap // split_length(cap, splits + 1)) == splits + 1):
        splits += 1
    warps = MAX_WARPS
    while warps > 1 and (blocks * splits * warps > WARPS_PER_SM * num_sms
                         or smem_bytes(D, warps, splits) > SMEM_LIMIT):
        warps //= 2
    return splits, split_length(cap, splits), warps


def decode_attention_int8_plain(q, layer, k_all, v_all, k_scale, v_scale, mask, splits=1):
    """Dequantize layer `layer` in f32 and take a masked softmax; a slot
    with no position masked in gives 0 (the TPU kernel's max(l, 1e-20)),
    not NaN.  With `splits` > 1 the positions are cut as the kernel cuts
    them into ranges of split_length(cap, splits); each gives a partial (m,
    l, acc) and the partials merge in split order.  Returns [B, H, D] in
    q's dtype."""
    B, H, D = q.shape
    cap, Hkv = k_all.shape[2], k_all.shape[3]
    rep = H // Hkv
    per = split_length(cap, splits)
    kf = (k_all[layer].float() * k_scale[layer].float()).repeat_interleave(rep, dim=2)
    vf = (v_all[layer].float() * v_scale[layer].float()).repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kf) / math.sqrt(D)
    scores = scores.masked_fill(~mask[:, None, :], float("-inf"))
    parts = []
    for r in range(splits):
        sl = slice(r * per, min(cap, (r + 1) * per))
        m = (scores[..., sl].amax(dim=-1, keepdim=True) if sl.start < sl.stop
             else scores.new_full((B, H, 1), float("-inf")))           # an empty split
        p = torch.exp(scores[..., sl] - torch.where(torch.isinf(m), 0.0, m))  # 0 where masked
        parts.append((m, p.sum(dim=-1, keepdim=True), torch.einsum("bhs,bshd->bhd", p, vf[:, sl])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    acc = l = None
    for m, l_r, acc_r in parts:
        f = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_all))   # a split with no position: 0
        acc = f * acc_r if acc is None else acc + f * acc_r
        l = f * l_r if l is None else l + f * l_r
    return (acc / l.clamp(min=1e-20)).to(q.dtype)


def _check(q, k_all, v_all, k_scale, v_scale, mask):
    devs = {t.device for t in (q, k_all, v_all, k_scale, v_scale, mask)}
    if len(devs) != 1:
        raise ValueError(f"decode_attention_int8: tensors on {sorted(map(str, devs))}")
    if q.ndim != 3 or k_all.ndim != 5:
        raise ValueError(f"decode_attention_int8: shapes q {tuple(q.shape)}, k_all "
                         f"{tuple(k_all.shape)}")
    B, H, D = q.shape
    L, _, cap, Hkv, _ = k_all.shape
    if (tuple(v_all.shape) != tuple(k_all.shape) or tuple(k_all.shape[1:]) != (B, cap, Hkv, D)
            or tuple(k_scale.shape) != (L, B, cap, Hkv, 1)
            or tuple(v_scale.shape) != tuple(k_scale.shape) or H % Hkv
            or tuple(mask.shape) != (B, cap)):
        raise ValueError(f"decode_attention_int8: q {tuple(q.shape)}, caches "
                         f"{tuple(k_all.shape)}, scales {tuple(k_scale.shape)}, mask "
                         f"{tuple(mask.shape)} do not fit together")
    if k_all.dtype != torch.int8 or v_all.dtype != torch.int8 or mask.dtype != torch.bool:
        raise TypeError(f"decode_attention_int8: caches {k_all.dtype}, {v_all.dtype}, "
                        f"mask {mask.dtype}")
    if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
        raise TypeError(f"decode_attention_int8: scales {k_scale.dtype}, {v_scale.dtype}")


def decode_attention_int8(q, layer: int, k_all, v_all, k_scale, v_scale, mask):
    """Normalized attention of q [B, H, D] (rope'd, unscaled) over layer
    `layer` of the int8 ring cache; query head h reads KV head h // (H //
    Hkv).  Returns out [B, H, D] in q's dtype (bf16 on the card)."""
    _check(q, k_all, v_all, k_scale, v_scale, mask)
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, layer, k_all, v_all, k_scale, v_scale, mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: unsupported device {q.device}")
    B, H, D = q.shape
    L, _, cap, Hkv, _ = k_all.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_int8: head dim {D} not in {HEAD_DIMS}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode_attention_int8: q {q.dtype} on the card, the kernel takes "
                        f"bf16")
    if not 0 <= layer < L:
        raise ValueError(f"decode_attention_int8: layer {layer} outside 0..{L - 1}")
    if not all(t.is_contiguous() for t in (q, k_all, v_all, k_scale, v_scale, mask)):
        raise ValueError("decode_attention_int8: operands must be contiguous")
    if k_all.data_ptr() % 16 or v_all.data_ptr() % 16:
        raise ValueError("decode_attention_int8: caches must be 16-byte aligned")
    splits, per, warps = plan_splits(B, H, D, cap, _num_sms(q.device.index or 0))
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=q.device)
    lib = build.load("decode_attention_int8")
    err = lib.decode_attention_int8(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), mask.data_ptr(), out.data_ptr(), int(layer), B, H, Hkv, D, cap,
        per, splits, warps, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attention_int8")
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
