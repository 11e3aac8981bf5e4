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



def _multinomial_token(generator, logits, temp, top_k):
    """The draw of utils/sampling.py before it was written out: the same
    temperature and top-k, then torch.multinomial."""
    if top_k > 0:
        vals, idx = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)
        choice = torch.multinomial(torch.softmax(vals / temp, dim=-1), 1, generator=generator)
        return torch.gather(idx, -1, choice)[..., 0]
    return torch.multinomial(torch.softmax(logits / temp, dim=-1), 1, generator=generator)[..., 0]


@pytest.mark.parametrize("top_k", [0, 25, 250])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_written_out_draw_is_multinomials(top_k, seed):
    """sample_token's exponential race draws what torch.multinomial drew for
    the same seeded CPU generator, with and without top-k, over a run of
    draws from one generator (so its state advances alike)."""
    from moshi_tpu_torch.utils.sampling import sample_token
    rs = np.random.RandomState(seed)
    ours, theirs = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    for V in (64, 2048, 32000):
        logits = torch.from_numpy(3 * rs.randn(4, V).astype(np.float32))
        for temp in (0.7, 1.0):
            got = sample_token(ours, logits, use_sampling=True, temp=temp, top_k=top_k)
            want = _multinomial_token(theirs, logits, temp, top_k)
            assert torch.equal(got, want), (V, temp)


def test_init_state_keeps_the_delays_tensor():
    """The delays are copied to a device once: a step reads the tensor that
    the first init_state made, whatever init_state runs after (a CUDA graph
    captured over it must not read freed memory)."""
    _, _, _, tmodel, _ = _models()
    gen = TGen(tmodel, TGenConfig(use_sampling=False))
    gen.init_state(B, None, torch.float32)
    first = gen._delays(torch.device("cpu"))
    gen.init_state(B, None, torch.float32, "cpu")
    gen.init_state(B, None, torch.float32, torch.device("cpu"))
    assert gen._delays(None) is first and gen._delays("cpu") is first


# the split API: (LMGenConfig options, cross-attention); heads of 64
SPLIT_CASES = {
    "plain": ({}, False),
    "cfg": (dict(cfg_coef=2.0), True),
    "cfg_no_text": (dict(cfg_coef=2.0, cfg_is_no_text=True), True),
    "cfg_masked_until": (dict(cfg_coef=2.0, cfg_is_masked_until=True), False),
    "rep_penalty": (dict(text_rep_penalty=1.6, text_rep_context=4), True),
}


def _split_models(cross: bool):
    cfg = tiny_lm_config(dim=128, num_heads=2, depformer_dim=32, cross_attention=cross,
                         text_card_out=66 if cross else None)
    jlm = JLM(cfg)
    params = jax.device_get(jlm.init_params(jax.random.PRNGKey(1), dtype=jnp.float32))
    return cfg, jlm, params, tlm.LMModel(port_lm_config(cfg)), from_jax(params)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_main_and_depth_step_match_jax(case):
    """main_step, then depth_step with the host's rewritten text token,
    1-D and 2-D audio_zero_mask, forced_audio, a replaced depformer and a
    frozen slot: greedy text tokens, output frames and the delay cache
    identical to JAX's, over CFG (with and without cfg_is_no_text, the
    masked-prefix variant), the repetition penalty, a summed condition and
    cross-attention K/V (CFG's null rows after the slots')."""
    opts, cross = SPLIT_CASES[case]
    cfg, jlm, params, tmodel, tparams = _split_models(cross)
    jgen = JGen(jlm, JGenConfig(use_sampling=False, **opts))
    tgen = TGen(tmodel, TGenConfig(use_sampling=False, **opts))
    assert tgen.model_batch_mult == jgen.model_batch_mult
    Bm = B * tgen.model_batch_mult
    rs = np.random.RandomState(5)
    jstate = jgen.init_state(B, jax.random.PRNGKey(0), dtype=jnp.float32)
    tstate = tgen.init_state(B, None, torch.float32)
    cond_sum = rs.randn(Bm, 1, cfg.dim).astype(np.float32)
    jsum, tsum = jnp.asarray(cond_sum), torch.from_numpy(cond_sum)
    if cross:
        src = rs.randn(Bm, 3, cfg.dim).astype(np.float32)
        jstate = jgen.init_cross_state(jstate, params, jnp.asarray(src))
        tgen.init_cross_state(tstate, tparams, torch.from_numpy(src))
    until = np.array([3, 6])
    jmain, jdepth = jax.jit(jgen.main_step), jax.jit(jgen.depth_step)
    ones = np.ones(B, bool)
    for f, toks in enumerate(_inputs(cfg, seed=6)):
        exec_mask = ones if f % 7 != 4 else np.array([True, False])
        masked = until if opts.get("cfg_is_masked_until") else None
        jt, _, jh, jstate = jmain(params, jstate, jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(exec_mask), jsum,
                                  None if masked is None else jnp.asarray(masked))
        tt, _, th = tgen.main_step(tparams, tstate, torch.from_numpy(toks),
                                   torch.from_numpy(exec_mask), tsum,
                                   None if masked is None else torch.from_numpy(masked))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        # the host rewrites the text token, as the TTS state machine does
        text = (tt.numpy() + f) % cfg.text_card
        zero = [None, rs.rand(cfg.dep_q) < 0.5, rs.rand(B, cfg.dep_q) < 0.5][f % 3]
        forced = None
        if f % 4 == 1:
            forced = np.full((B, cfg.dep_q), tlm.UNGENERATED_TOKEN)
            forced[0, 0] = 7
        replace = np.full((B, cfg.dep_q, 1), 5) if f % 5 == 2 else None
        j_args = [None if a is None else jnp.asarray(a, jnp.int32 if a.dtype != bool else bool)
                  for a in (replace, zero, forced)]
        t_args = [None if a is None else torch.from_numpy(a) for a in (replace, zero, forced)]
        jo, jstate = jdepth(params, jstate, jnp.asarray(text, jnp.int32), jh,
                            jnp.asarray(exec_mask), *j_args)
        to = tgen.depth_step(tparams, tstate, torch.from_numpy(text), th,
                             torch.from_numpy(exec_mask), *t_args)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tstate["cache"].numpy(), np.asarray(jstate["cache"]))
    if opts.get("text_rep_context"):
        np.testing.assert_array_equal(tstate["text_history"].numpy(),
                                      np.asarray(jstate["text_history"]))
        np.testing.assert_array_equal(tstate["hist_pos"].numpy(), np.asarray(jstate["hist_pos"]))
        assert (tstate["text_history"].numpy() >= 0).any()


@pytest.mark.parametrize("case", ["plain", "cfg", "rep_penalty"])
def test_step_is_main_then_depth_step(case):
    """LMGen.step gives what main_step then depth_step (the text token
    unchanged) give, sampled, from one generator seed."""
    opts, cross = SPLIT_CASES[case]
    cfg, _, _, tmodel, tparams = _split_models(False)
    outs = []
    for split in (False, True):
        gen = TGen(tmodel, TGenConfig(use_sampling=True, **opts))
        state = gen.init_state(B, torch.Generator().manual_seed(3), torch.float32)
        rows = []
        for toks in _inputs(cfg, seed=7):
            toks = torch.from_numpy(toks)
            if split:
                text, _, h = gen.main_step(tparams, state, toks)
                rows.append(gen.depth_step(tparams, state, text, h).numpy())
            else:
                rows.append(gen.step(tparams, state, toks)[0].numpy())
        outs.append(np.stack(rows))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[0][cfg.max_delay:] >= 0).all()
