"""The port's LMGen against moshi_tpu's on the tiny LM in f32: identical
greedy token streams, unquantized and after int4 quantization; sampling in
range and reproducible under one generator seed; garbage input tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.lm_gen import LMGen as JGen, LMGenConfig as JGenConfig
from moshi_tpu.utils.quantize import quantize_lm_params
from moshi_tpu_torch.models import lm as tlm
from moshi_tpu_torch.models.lm_gen import LMGen as TGen, LMGenConfig as TGenConfig
from moshi_tpu_torch.utils.params import from_jax
from test_lm import tiny_lm_config
from test_torch_port import port_lm_config

FRAMES = 24
B = 2


def _models(quant=None):
    # dim 64: the temporal linears' din is a multiple of 2 * 32, so int4
    # mode gives them q4 (linear_out's din 176 stays int8, by the rule)
    cfg = tiny_lm_config(dim=64, num_heads=4, depformer_dim=32)
    jlm = JLM(cfg)
    params = jlm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params = quantize_lm_params(params, min_size=1, mode=quant)
    return cfg, jlm, params, tlm.LMModel(port_lm_config(cfg)), from_jax(jax.device_get(params))


def _inputs(cfg, seed=0, low=0, high=None):
    n_in = cfg.num_codebooks - cfg.dep_q - 1
    high = cfg.card if high is None else high
    return np.random.RandomState(seed).randint(low, high, (FRAMES, B, n_in, 1))


@pytest.mark.parametrize("quant", [None, "int4"])
def test_greedy_stream_matches_jax(quant):
    cfg, jlm, params, tmodel, tparams = _models(quant)
    if quant:
        assert type(tparams["text_linear"]["weight"]).__name__ == "QTensor4"
    jgen = JGen(jlm, JGenConfig(use_sampling=False))
    tgen = TGen(tmodel, TGenConfig(use_sampling=False))
    jstate = jgen.init_state(B, jax.random.PRNGKey(0), dtype=jnp.float32)
    tstate = tgen.init_state(B, None, torch.float32)
    step = jax.jit(jgen.step)
    outs = []
    for toks in _inputs(cfg):
        oj, jstate = step(params, jstate, jnp.asarray(toks, jnp.int32))
        ot, tstate = tgen.step(tparams, tstate, torch.from_numpy(toks))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        outs.append(ot.numpy())
    outs = np.stack(outs)
    # the first max_delay frames are ungenerated, the rest real tokens
    assert (outs[:cfg.max_delay] == tlm.UNGENERATED_TOKEN).all()
    assert (outs[cfg.max_delay:] >= 0).all()
    np.testing.assert_array_equal(tstate["cache"].numpy(), np.asarray(jstate["cache"]))


def _sampled_stream(tmodel, tparams, cfg, seed, inputs, **gen_kw):
    gen = TGen(tmodel, TGenConfig(use_sampling=True, **gen_kw))
    state = gen.init_state(B, torch.Generator().manual_seed(seed), torch.float32)
    return np.stack([gen.step(tparams, state, torch.from_numpy(t))[0].numpy()
                     for t in inputs])


def test_sampling_in_range_and_reproducible():
    cfg, _, _, tmodel, tparams = _models()
    inputs = _inputs(cfg, seed=3)
    a = _sampled_stream(tmodel, tparams, cfg, 7, inputs)
    b = _sampled_stream(tmodel, tparams, cfg, 7, inputs)
    c = _sampled_stream(tmodel, tparams, cfg, 8, inputs)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    gen = a[cfg.max_delay:]
    assert ((gen[:, :, 0] >= 0) & (gen[:, :, 0] < cfg.text_card)).all()
    assert ((gen[:, :, 1:] >= 0) & (gen[:, :, 1:] < cfg.card)).all()


def test_text_prob_and_padding_bonus():
    cfg, _, _, tmodel, tparams = _models()
    inputs = _inputs(cfg, seed=4)
    # a huge pad bonus makes every greedy text token the pad id
    gen = TGen(tmodel, TGenConfig(use_sampling=False, padding_bonus=1e4))
    state = gen.init_state(B, None, torch.float32)
    for t in inputs:
        out, prob, state = gen.step_with_text_prob(tparams, state, torch.from_numpy(t))
        assert ((prob > 0) & (prob <= 1)).all()
    assert (out[:, 0] == cfg.existing_text_padding_id).all()


def test_garbage_tokens_do_not_raise():
    """Ids >= card and < -2 clamp into the tables; ZERO_TOKEN embeds to 0."""
    cfg, _, _, tmodel, tparams = _models()
    inputs = _inputs(cfg, seed=5, low=-50, high=10 * cfg.card)
    outs = _sampled_stream(tmodel, tparams, cfg, 0, inputs)
    assert (outs[cfg.max_delay:] >= 0).all()
    table = {"weight": tparams["emb"]["weight"][0]}
    z = tlm.embed(table, torch.tensor([[tlm.ZERO_TOKEN, 10 ** 6, -7]]))
    assert torch.equal(z[0, 0], torch.zeros_like(z[0, 0]))
    assert torch.equal(z[0, 1], table["weight"][-1])
    assert torch.equal(z[0, 2], table["weight"][0])


def test_lm_gen_embedding_fuzz():
    """Random int32 tokens over the whole range, including ids >= card and
    <= -3, through LMGen.step: nothing raises, no NaN reaches the state,
    and every generated token is in range."""
    cfg, _, _, tmodel, tparams = _models()
    rs = np.random.RandomState(11)
    gen = TGen(tmodel, TGenConfig(use_sampling=True))
    state = gen.init_state(B, torch.Generator().manual_seed(0), torch.float32)
    n_in = cfg.num_codebooks - cfg.dep_q - 1
    info = np.iinfo(np.int32)
    for f in range(FRAMES):
        toks = rs.randint(info.min, info.max, (B, n_in, 1), dtype=np.int64).astype(np.int32)
        toks[0, 0, 0] = [tlm.ZERO_TOKEN, tlm.UNGENERATED_TOKEN, -3, cfg.card][f % 4]
        out, state = gen.step(tparams, state, torch.from_numpy(toks))
        assert torch.isfinite(state["transformer"]["k"]).all()
        if f >= cfg.max_delay:
            assert (out[:, 0] < cfg.text_card).all() and (out[:, 1:] < cfg.card).all()
            assert (out >= 0).all()

