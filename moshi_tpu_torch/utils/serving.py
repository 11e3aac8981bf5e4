"""Serving knobs shared by the port's engines and the worker's TOML
(counterpart of moshi_tpu/utils/serving.py):

- kv_cache: "model" | "int8" | "int4", the temporal transformer's cache;
- context: the attention window, which sizes the per-user cache;
- weights: "int8" | "int4", the loaded LM's linears quantized
  (utils/quantize.py, the JAX package's rules and bytes);
- mimi_dtype: "bf16" halves the codec's share of a large-batch frame.
"""

from dataclasses import replace

import torch

_DTYPES = {"f32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def serving_device(name) -> torch.device:
    """The device an entry point was asked for; SystemExit when that is a
    CUDA device and torch sees none (nothing falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch sees no CUDA device")
    return device


def resolve_mimi_dtype(mimi_dtype) -> torch.dtype:
    """"f32" / "bf16" (a TOML or CLI string), a torch dtype, or None (f32)
    -> a torch dtype."""
    if mimi_dtype is None:
        return torch.float32
    if isinstance(mimi_dtype, str):
        return _DTYPES[mimi_dtype]
    return mimi_dtype


def override_lm(lm, kv_cache: str | None = None, context: int | None = None):
    """The LMModel rebuilt with its config's kv_cache_dtype and context
    replaced; `lm` itself when neither is given."""
    if not (kv_cache or context):
        return lm
    from ..models.lm import LMModel
    cfg = lm.config
    if kv_cache:
        cfg = replace(cfg, kv_cache_dtype=kv_cache)
    if context:
        cfg = replace(cfg, context=int(context))
    return LMModel(cfg)


def cast_mimi_params(mimi_params, mimi_dtype):
    """The Mimi tree with its floating leaves in `mimi_dtype` (itself when
    that is f32 or the tree is None)."""
    md = resolve_mimi_dtype(mimi_dtype)
    if md == torch.float32 or mimi_params is None:
        return mimi_params

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(v) for v in tree)
        return tree.to(md) if tree.is_floating_point() else tree

    return cast(mimi_params)


def apply_serving_overrides(lm, lm_params=None, mimi_params=None, *,
                            kv_cache: str | None = None, context: int | None = None,
                            weights: str | None = None, mimi_dtype=None):
    """All four knobs at once.  Returns (lm, lm_params, mimi_params,
    mimi_dtype as a torch dtype)."""
    lm = override_lm(lm, kv_cache, context)
    if weights and lm_params is not None:
        from .quantize import quantize_lm_params
        lm_params = quantize_lm_params(lm_params, mode=weights)
    md = resolve_mimi_dtype(mimi_dtype)
    return lm, lm_params, cast_mimi_params(mimi_params, md), md
