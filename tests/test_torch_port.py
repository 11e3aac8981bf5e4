"""Helpers shared by the tests that hold moshi_tpu_torch against
moshi_tpu (config conversion, output comparison), and the tests of the
conversion itself: parameter trees and the Moshi-7B / Mimi v0.1 configs."""

import dataclasses

import numpy as np


def port_config(cls, jax_config):
    """The port's config dataclass `cls` with the fields of `jax_config`
    (the port keeps moshi_tpu's field names; nested configs convert too)."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jax_config, f.name)
        if dataclasses.is_dataclass(v):
            sub = getattr(cls, "__dataclass_fields__")[f.name]
            v = port_config(_field_class(cls, sub), v)
        kw[f.name] = v
    return cls(**kw)


def _field_class(cls, field):
    default = field.default_factory() if field.default_factory is not dataclasses.MISSING \
        else field.default
    return type(default)


def port_mimi_config(jax_config):
    from moshi_tpu_torch.models.mimi import MimiConfig
    return port_config(MimiConfig, jax_config)


def port_lm_config(jax_config):
    from moshi_tpu_torch.models.lm import LmConfig
    return port_config(LmConfig, jax_config)


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    b = np.asarray(b, np.float32)
    return max_abs(a, b) / float(np.abs(b).max())


def to_np(t) -> np.ndarray:
    """A torch tensor (any dtype, bf16 included) as an f32 or integer numpy
    array."""
    if t.is_floating_point():
        t = t.float()
    return t.detach().cpu().numpy()


def test_from_jax_converts_leaves():
    """Arrays (bf16 included) copy bit for bit; quantized leaves become
    QTensor or QTensor4 by the rank of their scale; lists stay lists."""
    import jax
    import jax.numpy as jnp
    import torch
    from moshi_tpu.utils.quantize import quantize_tensor, quantize_tensor4
    from moshi_tpu_torch.utils.params import from_jax
    from moshi_tpu_torch.utils.quantize import QTensor, QTensor4

    w = jnp.asarray(np.random.RandomState(0).randn(2, 64, 16), jnp.bfloat16)
    tree = jax.device_get({"w": w, "q8": quantize_tensor(w), "q4": quantize_tensor4(w),
                           "list": [w[0], {}]})
    got = from_jax(tree)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))
    assert type(got["q8"]) is QTensor and type(got["q4"]) is QTensor4
    assert tuple(got["q4"].q.shape) == (2, 32, 16) and got["q4"].shape == (2, 64, 16)
    np.testing.assert_array_equal(got["q4"].q.numpy(), np.asarray(tree["q4"].q))
    assert isinstance(got["list"], list) and got["list"][1] == {}


def test_v0_1_configs_match_jax():
    """The port's Moshi-7B and Mimi v0.1 configs equal moshi_tpu's, and
    moshi_tpu's use only what the port takes as given."""
    from moshi_tpu.models.loaders import lm_config_v0_1
    from moshi_tpu.models.mimi import mimi_v0_1_config
    from moshi_tpu_torch.models import lm as tlm, mimi as tmimi

    j = lm_config_v0_1()
    assert port_lm_config(j) == tlm.lm_config_v0_1()
    assert j.depformer_multi_linear and j.depformer_weights_per_step
    assert j.depformer_weights_per_step_schedule is None and j.text_card_out is None
    assert j.kv_cache_dtype == "model" and not j.cross_attention
    jm = mimi_v0_1_config(8)
    assert port_mimi_config(jm) == tmimi.mimi_v0_1_config(8)
    assert jm.seanet.true_skip and jm.seanet.pad_mode == "constant"
    assert jm.seanet.activation == "elu"


def test_tts_and_vision_presets_match_jax():
    """The TTS and vision presets equal moshi_tpu's (the fields the port
    takes), and moshi_tpu's use only what the port takes as given."""
    from moshi_tpu.models import loaders
    from moshi_tpu_torch.models import lm as tlm

    for name in ("lm_config_tts_v0_1", "lm_config_tts_202501", "lm_config_v0_1_vision"):
        j = getattr(loaders, name)()
        assert port_lm_config(j) == getattr(tlm, name)(), name
        assert j.depformer_multi_linear and j.depformer_weights_per_step
        assert j.depformer_weights_per_step_schedule is None
        assert j.depformer_low_rank_embeddings is None and not j.demux_second_text_stream
    streaming = loaders.lm_config_v0_1_vision(num_slices=16, streaming=True)
    assert port_lm_config(streaming) == tlm.lm_config_v0_1_vision(16, streaming=True)
    tts = tlm.lm_config_tts_v0_1()
    assert (tts.text_out_card, tts.card, tts.transformer_config.head_dim) == (32001, 2049, 64)


def test_serving_overrides_match_jax():
    """override_lm replaces the KV cache dtype and the context as
    moshi_tpu's does; resolve_mimi_dtype reads the same strings."""
    import torch
    from moshi_tpu.models.lm import LMModel as JLM
    from moshi_tpu.models.loaders import lm_config_tts_v0_1
    from moshi_tpu.utils import serving as js
    from moshi_tpu_torch.models.lm import LMModel as TLM
    from moshi_tpu_torch.utils import serving as ts

    jlm, tlm_ = JLM(lm_config_tts_v0_1()), TLM(port_lm_config(lm_config_tts_v0_1()))
    assert ts.override_lm(tlm_) is tlm_
    for kv, ctx in (("int4", 1000), ("int8", None), (None, 250)):
        j, t = js.override_lm(jlm, kv, ctx), ts.override_lm(tlm_, kv, ctx)
        assert port_lm_config(j.config) == t.config
        assert t.transformer.config.kv_capacity == j.transformer.config.kv_capacity
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                     ("bfloat16", torch.bfloat16), (None, torch.float32)):
        assert ts.resolve_mimi_dtype(name) == dt
        assert str(js.resolve_mimi_dtype(name)) == str(dt)[6:]
    assert ts.resolve_mimi_dtype(torch.bfloat16) == torch.bfloat16
