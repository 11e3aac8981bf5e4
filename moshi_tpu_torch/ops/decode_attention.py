"""Flash decode over the int8 ring KV cache: the wrapper of the CUDA kernel
`csrc/decode_attention_int8.cu` and its plain PyTorch version.

Counterpart of moshi_tpu/ops/decode_attention.py (`decode_attention_int8`),
on the layout of the int8 KV path of moshi_tpu's StreamingTransformer
instead of that experiment's head-major [B, H, S, D]:
- k_all, v_all int8 [L, B, cap, Hkv, D], the ring of every layer;
- k_scale, v_scale bf16 [L, B, cap, Hkv, 1], one scale per (position, head)
  row;
- mask [B, cap] bool, the positions each slot attends.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""

import math

import torch

from . import build

HEAD_DIMS = (64, 128)  # the kernel's template instances


def decode_attention_int8_plain(q, layer, k_all, v_all, k_scale, v_scale, mask):
    """Dequantize layer `layer` in f32 and take a masked softmax; a slot
    with no position masked in gives 0 (the TPU kernel's max(l, 1e-20)),
    not NaN.  Returns [B, H, D] in q's dtype."""
    B, H, D = q.shape
    rep = H // k_all.shape[3]
    kf = (k_all[layer].float() * k_scale[layer].float()).repeat_interleave(rep, dim=2)
    vf = (v_all[layer].float() * v_scale[layer].float()).repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kf) / math.sqrt(D)
    scores = scores.masked_fill(~mask[:, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isinf(m), 0.0, m))   # 0 where masked
    acc = torch.einsum("bhs,bshd->bhd", p, vf)
    return (acc / p.sum(dim=-1, keepdim=True).clamp(min=1e-20)).to(q.dtype)


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
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=q.device)
    lib = build.load("decode_attention_int8")
    err = lib.decode_attention_int8(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), mask.data_ptr(), out.data_ptr(), int(layer), B, H, Hkv, D, cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attention_int8")
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
