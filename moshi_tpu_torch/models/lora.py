"""LoRA adapters: runtime unfused (training) and fused (serving, loading)
(counterpart of moshi_tpu/models/lora.py).

`LoRAWeight(base, a, b, scaling)` is a weight leaf of a param tree: a frozen
base [.., din, dout] (a tensor, a QTensor or a QTensor4) with an adapter a
[.., din, rank], b [.., rank, dout].  `utils/matmul.wdot` computes
`wdot(x, base) + scaling * (x @ a) @ b` with the base detached, so a
gradient of the model reaches the adapters only; a quantized base goes to
its kernel (whose backward is ops/q4matmul.FrozenLinear).  `dense` (the JAX
package's `astype`) is the fused view, frozen base plus scaling * a @ b.
`b` starts at zero, so a fresh adapter leaves the model as it was.
"""

import math
from dataclasses import dataclass

import torch

from ..utils.quantize import QTensor, QTensor4


@dataclass
class LoRAWeight:
    """A linear weight with a low-rank residual adapter."""

    base: object
    a: torch.Tensor
    b: torch.Tensor
    scaling: float = 2.0

    @property
    def shape(self):
        return tuple(self.base.shape)

    @property
    def ndim(self):
        return len(self.shape)

    def __getitem__(self, idx):
        return LoRAWeight(self.base[idx], self.a[idx], self.b[idx], self.scaling)

    def take(self, indices, axis: int = 0) -> "LoRAWeight":
        if axis != 0:
            raise ValueError("LoRAWeight.take gathers along axis 0 only")
        return self[torch.as_tensor(indices, device=self.a.device)]

    def dense(self, dtype) -> torch.Tensor:
        """The fused weight in `dtype`: the frozen base, detached, plus
        scaling * a @ b computed in f32."""
        from ..modules.transformer import dense
        base = dense(self.base, dtype).detach()
        delta = torch.matmul(self.a.float(), self.b.float())
        return base + (self.scaling * delta).to(dtype)


# Param-tree keys holding linear weights (moshi_tpu/models/lora.py)
_LORA_KEYS = ("in_proj", "out_proj", "linear_in", "linear_out", "linear1",
              "linear2", "q_proj", "kv_proj")
_LORA_WEIGHT_PARENTS = ("text_linear", "depformer_in", "linears", "input_proj")


def _is_linear(path: tuple) -> bool:
    name = path[-1] if path else ""
    parent = path[-2] if len(path) >= 2 else ""
    grandparent = path[-3] if len(path) >= 3 else ""
    return (name in _LORA_KEYS or (name == "weight" and parent in _LORA_WEIGHT_PARENTS)
            or grandparent == "output_projs")


def replace_all_linear_with_lora(params: dict, rank: int, generator: torch.Generator,
                                 scaling: float = 2.0, dtype=torch.bfloat16) -> dict:
    """Wrap every linear weight leaf of an LM param tree in a LoRAWeight, the
    leaves moshi_tpu's replace_all_linear_with_lora picks: a new tree over
    the same base tensors.  a is normal / sqrt(din) (drawn in f32 from
    `generator` on the base's device, leaf by leaf in the tree's order; the
    JAX package's draws differ), b zeros, both in `dtype`."""
    count = 0

    def walk(tree, path=()):
        nonlocal count
        if isinstance(tree, LoRAWeight):
            return tree
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        if not _is_linear(path) or getattr(tree, "ndim", 0) < 2:
            return tree
        *lead, din, dout = tree.shape
        device = (tree.q if isinstance(tree, (QTensor, QTensor4)) else tree).device
        a = torch.randn((*lead, din, rank), dtype=torch.float32, device=device,
                        generator=generator) / math.sqrt(din)
        count += 1
        return LoRAWeight(tree, a.to(dtype),
                          torch.zeros((*lead, rank, dout), dtype=dtype, device=device),
                          scaling)

    out = walk(params)
    if not count:
        raise ValueError("no linear leaves found to adapt")
    return out


def _map_lora(fn, tree):
    if isinstance(tree, LoRAWeight):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_lora(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_lora(fn, v) for v in tree)
    return tree


def fuse_lora_params(params: dict) -> dict:
    """Every LoRAWeight fused into a dense weight, in its base's dtype (bf16
    for a quantized base), as moshi_tpu's fuse_lora_params."""
    def fuse(w):
        dtype = (torch.bfloat16 if isinstance(w.base, (QTensor, QTensor4))
                 else w.base.dtype)
        return w.dense(dtype).detach()
    return _map_lora(fuse, params)


def lora_labels(params: dict):
    """The tree's labels: "adapter" for every a and b, "frozen" for every
    other leaf (a LoRAWeight's label is a LoRAWeight of labels, its base's
    "frozen"), as moshi_tpu's lora_labels; train.lora_optimizer trains the
    "adapter" leaves only."""
    def mark(tree):
        if isinstance(tree, LoRAWeight):
            return LoRAWeight("frozen", "adapter", "adapter", tree.scaling)
        if isinstance(tree, dict):
            return {k: mark(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mark(v) for v in tree)
        return "frozen"
    return mark(params)


def has_lora(params) -> bool:
    """Whether the tree holds a LoRAWeight."""
    found = []
    _map_lora(lambda w: found.append(w), params)
    return bool(found)


def fuse_lora_state(state: dict, lora_state: dict, scaling: float = 2.0) -> dict:
    """A LoRA state dict (`<base>.lora_A.weight` [rank, in], `.lora_B.weight`
    [out, rank]) fused into a PyTorch-named base state: each base weight
    plus scaling * B @ A in f32, cast back to its dtype.  Both the split
    (`...in_projs.0.weight`) and the fused legacy (`...in_proj_weight`)
    names of a base are found (moshi_tpu/models/lora.py fuse_lora_state)."""
    state = dict(state)
    fused = 0
    for key in lora_state:
        if not key.endswith(".lora_A.weight"):
            continue
        base = key[: -len(".lora_A.weight")]
        A = lora_state[key].float()
        B = lora_state[base + ".lora_B.weight"].float()
        delta = (B @ A) * scaling
        for cand in (base + ".weight", base + "_weight"):
            if cand in state:
                w = state[cand]
                state[cand] = (w.float() + delta).to(w.dtype)
                fused += 1
                break
        else:
            raise KeyError(f"no base weight found for LoRA adapter {base}")
    if fused == 0:
        raise ValueError("LoRA state dict contained no adapters")
    return state
