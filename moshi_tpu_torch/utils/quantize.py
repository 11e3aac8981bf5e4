"""Weight-only int8 and group-wise int4 quantization (counterpart of
moshi_tpu/utils/quantize.py).

The packed formats are byte-identical to the JAX package's, so a quantized
tree converts by copying and both kernels read the same bytes:
- `QTensor`: q int8 [..., din, dout], f32 scale [..., 1, dout], symmetric
  per output column;
- `QTensor4`: q int8 [..., din/2, dout] with sequential-pair nibbles (byte
  i holds din position 2i in the low nibble, 2i+1 in the high one, each
  signed in [-7, 7]) and an f32 scale [..., din/gs, 1, dout].

A member of a stacked tensor (`w[l]`) is a view: the JAX package's
QTensor4Ref, which kept XLA from copying a slice before a Pallas call, has
no counterpart here.
"""

from dataclasses import dataclass

import torch


def unpack_nibbles(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-extend the low and high 4-bit planes of packed bytes (int32)."""
    x = q.to(torch.int32)
    low = ((x & 0xF) ^ 8) - 8
    high = (((x >> 4) & 0xF) ^ 8) - 8
    return low, high


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 [..., din, dout] * scale [..., 1, dout], in `dtype`."""
    return q.to(dtype) * scale.to(dtype)


def dequantize4(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Unpack sequential-pair nibbles [..., din/2, dout] and apply the group
    scales [..., G, 1, dout], in `dtype` (the JAX package's
    `QTensor4.astype`)."""
    low, high = unpack_nibbles(q)
    *lead, p2, dout = q.shape
    w = torch.stack([low, high], dim=-2).reshape(*lead, p2 * 2, dout)
    G = scale.shape[-3]
    w = w.reshape(*lead, G, 2 * p2 // G, dout).to(dtype)
    w = w * scale.to(dtype)
    return w.reshape(*lead, p2 * 2, dout)


@dataclass
class QTensor:
    """Symmetric int8 weight with per-output-column scales."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return tuple(self.q.shape)

    def __getitem__(self, idx):
        return QTensor(self.q[idx], self.scale[idx])


@dataclass
class QTensor4:
    """Group-wise 4-bit weight, nibble-packed into int8.  Logical shape
    [..., din, dout]."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        *lead, p2, dout = self.q.shape
        return tuple(lead) + (p2 * 2, dout)

    def __getitem__(self, idx):
        return QTensor4(self.q[idx], self.scale[idx])


def _per_member(fn, w: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """Quantize each [din, dout] member of w's leading axes into q and scale,
    so quantizing a stack never holds an f32 copy of more than one member."""
    wf = w.reshape(-1, *w.shape[-2:])
    qf = q.view(-1, *q.shape[-2:])
    sf = scale.view(-1, *scale.shape[len(w.shape) - 2:])
    for i in range(wf.shape[0]):
        qf[i], sf[i] = fn(wf[i])


def _quantize8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize4(w: torch.Tensor, group_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    din, dout = w.shape[-2:]
    wf = w.to(torch.float32).reshape(din // group_size, group_size, dout)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8)
    q = q.reshape(din // 2, 2, dout)
    packed = (q[:, 0] & 0x0F) | ((q[:, 1] & 0x0F) << 4)
    return packed.to(torch.int8), scale


def quantize_tensor(w: torch.Tensor) -> QTensor:
    *lead, din, dout = w.shape
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*lead, 1, dout), dtype=torch.float32, device=w.device)
    _per_member(_quantize8, w, q, scale)
    return QTensor(q, scale)


def quantize_tensor4(w: torch.Tensor, group_size: int = 32) -> QTensor4:
    *lead, din, dout = w.shape
    if din % (2 * group_size):
        raise ValueError(f"din {din} is not a multiple of 2 * {group_size}")
    q = torch.empty((*lead, din // 2, dout), dtype=torch.int8, device=w.device)
    scale = torch.empty((*lead, din // group_size, 1, dout), dtype=torch.float32,
                        device=w.device)

    _per_member(lambda m: _quantize4(m, group_size), w, q, scale)
    return QTensor4(q, scale)


# Param-tree paths that hold linear weights (moshi_tpu/utils/quantize.py).
_LINEAR_KEYS = ("in_proj", "out_proj", "linear_in", "linear_out", "linear1",
                "linear2", "q_proj", "kv_proj")


def quantize_lm_params(params: dict, min_size: int = 1 << 16,
                       mode: str = "int8", group_size: int = 32) -> dict:
    """Quantize the linears of an LM param tree with the JAX package's rules:
    int8 per output column, or in "int4" mode group-wise q4 wherever din is
    a multiple of 2 * group_size, except the depformer (any path part
    starting with "depformer", or "linears"), which stays int8.  Embeddings,
    norms and tensors smaller than `min_size` stay as they are."""
    if mode not in ("int8", "int4"):
        raise ValueError(mode)

    def walk(tree, path=()):
        if isinstance(tree, (QTensor, QTensor4)):
            return tree
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        x = tree
        if (not isinstance(x, torch.Tensor) or x.ndim < 2 or x.numel() < min_size
                or not x.is_floating_point()):
            return x
        name = path[-1] if path else ""
        parent = path[-2] if len(path) >= 2 else ""
        grandparent = path[-3] if len(path) >= 3 else ""
        is_linear = (name in _LINEAR_KEYS
                     or (name == "weight" and parent in
                         ("text_linear", "depformer_in", "linears", "extra_heads",
                          "input_proj"))
                     or grandparent == "output_projs")
        if not is_linear:
            return x
        is_depformer = any(part.startswith("depformer") for part in path) \
            or "linears" in path
        if (mode == "int4" and not is_depformer
                and x.shape[-2] % (2 * group_size) == 0):
            return quantize_tensor4(x, group_size)
        return quantize_tensor(x)

    return walk(params)
