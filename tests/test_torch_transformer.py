"""The port's StreamingTransformer.step against moshi_tpu's, in f32 on the
CPU, on weights converted from moshi_tpu: the ring KV cache past its
capacity, T > 1 steps, grouped KV heads, per-step (depformer) weights, and
q4/int8 weights through wdot."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.modules import transformer as jtr
from moshi_tpu.utils.quantize import quantize_lm_params
from moshi_tpu_torch.modules import transformer as ttr
from moshi_tpu_torch.utils.params import from_jax
from test_torch_port import max_abs, port_config, to_np

TOL = 1e-5  # f32, same weights: accumulation order only

LM = dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=264, context=6,
          gating="silu", norm="rms_norm_f32", positional_embedding="rope")
MIMI = dict(d_model=32, num_heads=2, num_layers=2, dim_feedforward=64, context=5,
            gating="none", norm="layer_norm", layer_scale=0.01,
            positional_embedding="rope")
GQA = dict(LM, kv_repeat=2, positional_embedding="rope_concat", norm="rms_norm")
DEP = dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128, context=None,
           gating="silu", norm="rms_norm_f32", positional_embedding="none",
           weights_per_step=3)

# name: (config, steps per call, calls, quantization)
CASES = {
    "ring_wraps": (LM, 1, 14, None),
    "t2_layer_scale": (MIMI, 2, 8, None),
    "kv_repeat_rope_concat": (GQA, 1, 9, None),
    "q4": (LM, 1, 9, "int4"),
    "int8": (LM, 1, 9, "int8"),
}


def _build(cfg_kw, quant):
    cfg = jtr.TransformerConfig(**cfg_kw)
    jmodel = jtr.StreamingTransformer(cfg)
    params = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params = quantize_lm_params(params, min_size=1, mode=quant)
    tmodel = ttr.StreamingTransformer(port_config(ttr.TransformerConfig, cfg))
    return cfg, jmodel, params, tmodel, from_jax(jax.device_get(params))


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case):
    cfg_kw, T, calls, quant = CASES[case]
    cfg, jmodel, params, tmodel, tparams = _build(cfg_kw, quant)
    if quant == "int4":
        assert type(tparams["layers"]["attn"]["in_proj"]).__name__ == "QTensor4"
    B = 2
    rs = np.random.RandomState(0)
    xs = rs.randn(calls, B, T, cfg.d_model).astype(np.float32)
    jstate = jmodel.init_state(B, jnp.float32)
    tstate = tmodel.init_state(B, torch.float32)
    step = jax.jit(jmodel.step)
    assert calls * T > cfg.kv_capacity  # the ring wraps
    for x in xs:
        yj, jstate = step(params, jstate, jnp.asarray(x))
        yt, tstate = tmodel.step(tparams, tstate, torch.from_numpy(x))
        assert max_abs(to_np(yt), yj) <= TOL
    np.testing.assert_array_equal(to_np(tstate["offset"]), np.asarray(jstate["offset"]))
    assert max_abs(to_np(tstate["k"]), jstate["k"]) <= TOL


@pytest.mark.parametrize("quant", [None, "int8"])
def test_per_step_weights_match_jax(quant):
    """The depformer's use: a fresh state each frame, step k with the
    weights of step k."""
    cfg, jmodel, params, tmodel, tparams = _build(DEP, quant)
    B = 2
    rs = np.random.RandomState(1)
    step = jax.jit(jmodel.step)
    for _ in range(2):
        jstate = jmodel.init_state(B, jnp.float32)
        tstate = tmodel.init_state(B, torch.float32)
        for k in range(cfg.weights_per_step):
            x = rs.randn(B, 1, cfg.d_model).astype(np.float32)
            yj, jstate = step(params, jstate, jnp.asarray(x),
                              steps=jnp.asarray([k], jnp.int32))
            yt, tstate = tmodel.step(tparams, tstate, torch.from_numpy(x), steps=(k,))
            assert max_abs(to_np(yt), yj) <= TOL


def test_ring_positions_match_jax():
    for offset in ([0, 3], [5, 11], [12, 2]):
        for T in (1, 2):
            pj, oj = jtr.ring_positions(jnp.asarray(offset, jnp.int32), T, 6, None)
            pt, ot = ttr.ring_positions(torch.tensor(offset), T, 6)
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
            np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_gating_hidden_dim_matches_jax():
    for d, ff in ((4096, int(4.125 * 4096)), (1024, 4224), (64, 256), (32, 64)):
        assert ttr.gating_hidden_dim(d, ff) == jtr.gating_hidden_dim(d, ff)


# cross-attention: (gating, shared projections, KV cache); heads of 64 as
# in the TTS presets
XA = dict(d_model=128, num_heads=2, num_layers=2, dim_feedforward=256, context=6,
          gating="none", norm="layer_norm", positional_embedding="rope",
          cross_attention=True, cross_attention_kv_dim=24)
XA_CASES = ([(g, shared, "model") for g in ttr.XA_GATINGS for shared in (False, True)]
            + [(g, shared, kv) for g in ("normal", "conditional_gated_tanh_learnable_bias")
               for shared in (False, True) for kv in ("int8", "int4")])


@pytest.mark.parametrize("gating,shared,kv", XA_CASES)
def test_cross_attention_step_matches_jax(gating, shared, kv):
    """precompute_cross, then steps attending the cross K/V after
    self-attention, through each gating (its parameters drawn away from
    their zero init so every gate acts), shared or per-layer projections,
    over the model, int8 and int4 caches."""
    cfg = jtr.TransformerConfig(**XA, cross_attention_gating=gating, shared_cross_attn=shared,
                                kv_cache_dtype=kv)
    jmodel = jtr.StreamingTransformer(cfg)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float32))
    rs = np.random.RandomState(2)
    gate = params["layers"].get("cross_attn_gate", {})
    for name in ("alpha", "bias"):
        if name in gate:
            gate[name] = rs.randn(*gate[name].shape).astype(np.float32)
    tmodel = ttr.StreamingTransformer(port_config(ttr.TransformerConfig, cfg))
    tparams = from_jax(params)
    B, Ts = 2, 5
    src = rs.randn(B, Ts, 24).astype(np.float32)
    jcross = jmodel.precompute_cross(params, jnp.asarray(src))
    tcross = tmodel.precompute_cross(tparams, torch.from_numpy(src))
    lead = () if shared else (cfg.num_layers,)
    assert tuple(tcross["k_cross"].shape) == lead + (B, Ts, 2, 64)
    for name in ("k_cross", "v_cross"):
        assert max_abs(to_np(tcross[name]), jcross[name]) <= TOL
    jstate = {**jmodel.init_state(B, jnp.float32), **jcross}
    tstate = {**tmodel.init_state(B, torch.float32), **tcross}
    step = jax.jit(jmodel.step)
    for x in rs.randn(9, B, 1, cfg.d_model).astype(np.float32):
        yj, jstate = step(params, jstate, jnp.asarray(x))
        yt, tstate = tmodel.step(tparams, tstate, torch.from_numpy(x))
        assert max_abs(to_np(yt), yj) <= TOL
    # the cross block acts: the same step without the cross K/V differs
    plain = {k: v for k, v in tstate.items() if k not in ("k_cross", "v_cross")}
    y_plain, _ = tmodel.step(tparams, plain, torch.from_numpy(x))
    assert max_abs(to_np(y_plain), yj) > 10 * TOL


def test_precompute_cross_writes_in_place():
    """With `out`, precompute_cross writes the given tensors (a captured
    graph keeps reading them), cast to their dtype."""
    cfg = jtr.TransformerConfig(**XA)
    params = jax.device_get(jtr.StreamingTransformer(cfg).init_params(
        jax.random.PRNGKey(1), dtype=jnp.float32))
    tmodel = ttr.StreamingTransformer(port_config(ttr.TransformerConfig, cfg))
    tparams = from_jax(params)
    src = torch.from_numpy(np.random.RandomState(3).randn(2, 4, 24).astype(np.float32))
    ref = tmodel.precompute_cross(tparams, src)
    out = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in ref.items()}
    ptrs = {k: v.data_ptr() for k, v in out.items()}
    got = tmodel.precompute_cross(tparams, src, out=out)
    assert got is out and {k: v.data_ptr() for k, v in got.items()} == ptrs
    for k in ref:
        assert torch.equal(got[k], ref[k].to(torch.bfloat16))
