"""The reference worker's inline model-config schema -> the port's
`LmConfig` (counterpart of moshi_tpu/models/rust_config.py).

The reference production worker carries the whole model architecture in
its TOML (`rust/s2st-1b.toml:1-52`): top-level vocab sizes, a
`[transformer]` table (`rust/moshi-core/src/transformer.rs:20-47`), an
optional `[depformer]` table (`lm.rs:23-27`), optional
`[conditioners.<name>]` tables (`conditioner.rs:8-29`) and `extra_heads`
(`lm.rs:30-33`), deserialized into `moshi::lm::Config` (`lm.rs:36-45`).
Enum names are serde defaults: CamelCase for NormType, PositionalEmbedding
and CrossAttentionGating, lowercase for the activations.

`rust_lm_kwargs` gives the JAX package's LmConfig fields, so
`lm_config_dict_from_rust` is the config.json dict the JAX package writes.
"""

from __future__ import annotations

import dataclasses

from .lm import LmConfig, _acoustic_delays

# rust NormType (lib.rs) -> modules/norm.py names.  The rust RmsNorm upcasts
# to f32 internally (norm.rs), matching our rms_norm_f32.
_NORM = {
    "RmsNorm": "rms_norm_f32",
    "LayerNorm": "layer_norm",
}

# rust transformer::PositionalEmbedding (transformer.rs:49-54)
_POS_EMB = {"Rope": "rope", "Sin": "sin", "None": "none"}

# rust transformer::CrossAttentionGating (transformer.rs:56-66) -> the
# XaGate zoo names in modules/transformer.py
_XA_GATING = {
    "Normal": "normal",
    "ConstantGatedTanh": "constant_gated_tanh",
    "ConstantGatedSigmoid": "constant_gated_sigmoid",
    "ConditionalGatedTanh": "conditional_gated_tanh",
    "ConditionalGatedSigmoid": "conditional_gated_sigmoid",
    "ConditionalGatedSigmoidLearnableBias":
        "conditional_gated_sigmoid_learnable_bias",
    "ConditionalGatedTanhLearnableBias":
        "conditional_gated_tanh_learnable_bias",
}


def _main_transformer_kwargs(t: dict) -> dict:
    """`[transformer]` table (transformer.rs Config) -> LmConfig kwargs."""
    d_model = int(t["d_model"])
    kw = dict(
        dim=d_model,
        num_heads=int(t["num_heads"]),
        num_layers=int(t["num_layers"]),
        hidden_scale=float(t["dim_feedforward"]) / d_model,
        causal=bool(t.get("causal", True)),
        context=int(t["context"]),
        max_period=float(t.get("max_period", 10_000)),
        gating=(t.get("gating") or "none"),
        norm=_NORM[t.get("norm", "RmsNorm")],
        positional_embedding=_POS_EMB[t.get("positional_embedding", "Rope")],
        layer_scale=t.get("layer_scale"),
        kv_repeat=int(t.get("kv_repeat", 1)),
        shared_cross_attn=bool(t.get("shared_cross_attn", False)),
    )
    xa = t.get("cross_attention")
    if xa:
        # serde tuple (gating, norm, Option<kv_dim>) arrives as a TOML array
        gating, norm = xa[0], xa[1]
        kv_dim = xa[2] if len(xa) > 2 else None
        kw.update(cross_attention=True,
                  cross_attention_gating=_XA_GATING[gating],
                  cross_attention_norm=_NORM[norm],
                  cross_attention_kv_dim=kv_dim)
    return kw


def _depformer_kwargs(dep: dict | None) -> dict:
    """`[depformer]` table (lm.rs DepFormerConfig) -> LmConfig kwargs.

    The rust DepFormer builds one slice (own weights) per generated codebook
    (lm.rs `DepFormerSlice`), i.e. weights-per-step + multi-linear."""
    if not dep:
        return dict(dep_q=0)
    t = dict(dep.get("transformer", {}))
    d_model = int(t.get("d_model", 1024))
    return dict(
        dep_q=int(dep["num_slices"]),
        depformer_dim=d_model,
        depformer_num_heads=int(t.get("num_heads", 16)),
        depformer_num_layers=int(t.get("num_layers", 6)),
        depformer_dim_feedforward=int(t.get("dim_feedforward", 4 * d_model)),
        depformer_gating=(t.get("gating") or "none"),
        depformer_norm=_NORM[t.get("norm", "RmsNorm")],
        depformer_kv_repeat=int(t.get("kv_repeat", 1)),
        depformer_pos_emb=_POS_EMB[t.get("positional_embedding", "None")],
        depformer_max_period=float(t.get("max_period", 10_000)),
        depformer_layer_scale=t.get("layer_scale"),
        depformer_multi_linear=True,
        depformer_weights_per_step=True,
        depformer_low_rank_embeddings=dep.get("low_rank_embeddings"),
    )


def translate_conditioners(cond: dict | None) -> dict | None:
    """rust `[conditioners.<name>]` tables (conditioner.rs Config: serde tag
    `type` in {"Lut", "ContinuousAttribute"}, fields flattened) -> the
    config.json `conditioners` block consumed by
    `conditioners.conditioners_from_config`."""
    if not cond:
        return None
    out = {}
    for name, c in cond.items():
        c = dict(c)
        ctype = c.pop("type")
        if ctype == "Lut":
            out[name] = {"type": "lut", "lut": c}
        elif ctype == "ContinuousAttribute":
            out[name] = {"type": "continuous_attribute",
                         "continuous_attribute": c}
        elif ctype in ("lut", "tensor", "continuous_attribute"):
            # already config.json-style (nested table) — pass through
            out[name] = {"type": ctype, ctype: c.get(ctype, c)}
        else:
            raise ValueError(f"unknown conditioner type {ctype!r}")
    return out


def rust_lm_kwargs(d: dict, gen: dict | None = None) -> dict:
    """`moshi::lm::Config` (lm.rs:36-45, from the worker TOML) -> LmConfig
    kwargs.  `*_vocab_size` counts the whole embedding table with its
    initial / pad row, `card` / `text_card` the real tokens, so card =
    audio_vocab_size - 1 and text_card = text_in_vocab_size - 1.  `gen` is
    the module's `gen` / `generation` table: its acoustic_delay makes the
    per-codebook delays, its text tokens the pad and end-pad ids."""
    d = dict(d)
    text_in = int(d["text_in_vocab_size"])
    text_out = int(d["text_out_vocab_size"])
    n_q = int(d["audio_codebooks"])
    kw = dict(
        card=int(d["audio_vocab_size"]) - 1,
        text_card=text_in - 1,
        text_card_out=(text_out if text_out != text_in - 1 else None),
        n_q=n_q,
    )
    kw.update(_main_transformer_kwargs(dict(d["transformer"])))
    kw.update(_depformer_kwargs(d.get("depformer")))
    if d.get("extra_heads"):
        kw.update(extra_heads_num_heads=int(d["extra_heads"]["num_heads"]),
                  extra_heads_dim=int(d["extra_heads"]["dim"]))
    gen = dict(gen or {})
    if gen:
        kw["delays"] = _acoustic_delays(n_q, kw["dep_q"], int(gen.get("acoustic_delay", 0)))
        if "text_pad_token" in gen:
            kw["existing_text_padding_id"] = int(gen["text_pad_token"])
        if "text_eop_token" in gen:
            kw["existing_text_end_padding_id"] = int(gen["text_eop_token"])
    else:
        kw["delays"] = (0,) * (1 + n_q)
    return kw


def lm_config_dict_from_rust(d: dict, gen: dict | None = None) -> dict:
    """The whole config.json dict of the JAX package's LmConfig for an
    inline rust model table: every field, defaults included, delays as a
    list."""
    cfg = dataclasses.asdict(LmConfig(**rust_lm_kwargs(d, gen)))
    cfg["delays"] = list(cfg["delays"])
    return cfg


def lm_config_from_rust_dict(d: dict, gen: dict | None = None) -> LmConfig:
    """`moshi::lm::Config` -> the port's LmConfig."""
    return LmConfig.from_dict(rust_lm_kwargs(d, gen))
