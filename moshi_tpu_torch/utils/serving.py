"""Serving knobs shared by the port's engines (counterpart of
moshi_tpu/utils/serving.py): the per-user KV cache dtype and attention
window of an LM, and the codec's dtype.

- kv_cache: "model" | "int8" | "int4", the temporal transformer's cache;
- context: the attention window, which sizes the per-user cache;
- mimi_dtype: "bf16" halves the codec's share of a large-batch frame.
"""

from dataclasses import replace

import torch

_DTYPES = {"f32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


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
