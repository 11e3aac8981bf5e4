"""Parameters of the port: conversion from the JAX package and a seeded
initialisation.

Trees keep moshi_tpu's layout: nested dicts and lists whose leaves are
tensors, `QTensor` or `QTensor4`; linears are [din, dout], per-layer stacks
lead with [L, ...], per-step stacks with [W, ...].  Only Mimi's convolution
weights are re-laid-out, for `torch.nn.functional.conv1d`
(modules/conv.py).

`from_jax` takes a moshi_tpu tree already on the host (`jax.device_get`):
numpy arrays, and quantized leaves as objects with `q` and `scale`.  The
initialisers draw from an explicit `torch.Generator` with the distributions
of moshi_tpu's `init_params`, so a model can be built on a machine that has
no JAX; they do not reproduce jax.random's bits.
"""

import math

import numpy as np
import torch

from .quantize import QTensor, QTensor4


def from_jax(tree, device="cpu", mimi_config=None):
    """Convert a host-side moshi_tpu param tree to the port's tree on
    `device`.  With `mimi_config` (a MimiConfig) the tree is a Mimi tree and
    its conv weights are re-laid-out for F.conv1d / F.conv_transpose1d."""
    out = _convert(tree, device)
    if mimi_config is not None:
        from ..models.mimi import MimiModel
        MimiModel(mimi_config).relayout_jax_convs(out)
    return out


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        q, scale = _tensor(tree.q, device), _tensor(tree.scale, device)
        # QTensor4 packs two din rows per byte: q has one axis fewer than
        # its scale [..., din/gs, 1, dout]
        cls = QTensor4 if scale.ndim == q.ndim + 1 else QTensor
        return cls(q, scale)
    return _tensor(tree, device)


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def trunc_normal(generator: torch.Generator, shape, fan_in: int, dtype,
                 device=None) -> torch.Tensor:
    """Normal truncated to [-3, 3], times 1/sqrt(fan_in) (moshi_tpu's
    `trunc`).  Drawn in f32 one [.., din, dout] member at a time, so a big
    bf16 stack never has an f32 copy of more than one member."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out.view(1, *shape)
    std = 1.0 / math.sqrt(fan_in)
    for i in range(flat.shape[0]):
        t = torch.empty(flat.shape[1:], dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
        flat[i] = t * std
    return out


def uniform(generator: torch.Generator, shape, bound: float, dtype,
            device=None) -> torch.Tensor:
    """Uniform in [-bound, bound)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(dtype)


def normal(generator: torch.Generator, shape, dtype, device=None) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(generator=generator)
    return t.to(dtype)
