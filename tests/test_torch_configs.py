"""The transformer's and the LM's remaining options held against
moshi_tpu on the CPU in f32: the FFN's GLU gatings (gelu, relu, tanh,
sigmoid beside silu), an acausal LM and transformer (`causal=False`: no
mask in the offline forward), steps of T > 1 positions over the int8 and
int4 KV caches (a prefill), and the batched TTS engine above 16 model
rows (true CFG on 9 slots).  Mimi's options are in
tests/test_torch_mimi_configs.py.

Weights come from the JAX package's `init_params`, converted by
`from_jax`; inputs from numpy seeds.  Tolerances: outputs within
OUT_TOL, tokens equal, cache bytes equal; within the port, a prefill
chunk against the same positions stepped one at a time within OUT_TOL
over the model-dtype and int8 caches (over int4 see
test_chunked_equals_per_step)."""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu import run_tts as jrun
from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.loaders import CheckpointInfo as JInfo
from moshi_tpu.modules import transformer as jtr
from moshi_tpu.serve import batched_tts as jbt
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.models.lm import LmConfig as TLmConfig
from moshi_tpu_torch.models.loaders import CheckpointInfo
from moshi_tpu_torch.modules import transformer as ttr
from moshi_tpu_torch.serve import batched_tts as tbt
from moshi_tpu_torch.utils.params import from_jax
from test_lm import tiny_lm_config
from test_torch_port import max_abs, port_config, port_lm_config, to_np
from test_torch_tts_serve import (_drain_jax, _drain_port, record_jax_tokens,
                                  record_port_tokens, same_session)
from test_torch_tts_serve_cli import two_voiced_sessions, write_tts_checkpoint

OUT_TOL = 1e-5
GATINGS = ("silu", "gelu", "relu", "tanh", "sigmoid")
CFG = dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=256, context=8,
           positional_embedding="rope", norm="rms_norm_f32")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_lora.py): beside other test
    processes torch's thread pool slows models this small down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host(tree):
    return jax.device_get(tree)


@functools.lru_cache(maxsize=None)
def _params(kv_repeat: int):
    """JAX's init of the CFG transformer; its shapes depend on kv_repeat
    alone (not on the gating or the cache), so the tests here share it."""
    cfg = jtr.TransformerConfig(**CFG, gating="silu", kv_repeat=kv_repeat)
    return jtr.StreamingTransformer(cfg).init_params(jax.random.PRNGKey(0), dtype=jnp.float32)


def _transformer(**over):
    cfg = jtr.TransformerConfig(**{**CFG, "gating": "silu", **over})
    params = _params(cfg.kv_repeat)
    tmodel = ttr.StreamingTransformer(port_config(ttr.TransformerConfig, cfg))
    return cfg, jtr.StreamingTransformer(cfg), params, tmodel, from_jax(host(params))


def _bytes_equal(t, a) -> bool:
    a, t = np.asarray(a), t.contiguous()
    if t.dtype == torch.bfloat16:
        return np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    return np.array_equal(t.numpy(), a)


# ------------------------------------------------------------ gatings
@pytest.mark.parametrize("gating", GATINGS)
def test_gating_matches_jax(gating):
    """Each GLU gate: the offline forward against JAX's, and the port's 6
    streaming steps against its offline forward (the one layer body)."""
    cfg, jmodel, params, tmodel, tparams = _transformer(gating=gating)
    x = (0.5 * np.random.RandomState(1).randn(2, 6, cfg.d_model)).astype(np.float32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    got = tmodel.apply(tparams, torch.from_numpy(x))
    assert max_abs(to_np(got), want) <= OUT_TOL
    state = tmodel.init_state(2, torch.float32)
    steps = [tmodel.step(tparams, state, torch.from_numpy(x[:, t:t + 1]))[0] for t in range(6)]
    assert max_abs(to_np(torch.cat(steps, 1)), to_np(got)) <= OUT_TOL


def test_unknown_gating_is_refused():
    with pytest.raises(ValueError, match="gating"):
        ttr.StreamingTransformer(ttr.TransformerConfig(**{**CFG, "gating": "swish"}))


# -------------------------------------------------------------- causal
def test_lm_forward_acausal_matches_jax():
    """LmConfig.from_dict takes `causal: false` into both transformers; the
    teacher-forced forward then attends every position, as JAX's does
    (gelu and relu gates on the temporal transformer and the depformer)."""
    jcfg = tiny_lm_config(causal=False, gating="gelu", depformer_gating="relu")
    tcfg = TLmConfig.from_dict({**{k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__},
                                "delays": list(jcfg.delays)})
    assert tcfg == port_lm_config(jcfg)
    assert not tcfg.transformer_config.causal and not tcfg.depformer_config.causal
    jlm = JLM(jcfg)
    params = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0), jnp.float32)
    tlm, tparams = TLM(tcfg), from_jax(host(params))
    codes = np.random.RandomState(2).randint(0, 48, (2, jcfg.num_codebooks, 12))
    want = jax.jit(jlm.forward)(params, jnp.asarray(codes))
    got = tlm.forward(tparams, torch.from_numpy(codes))
    for key in ("logits", "text_logits"):
        np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]), rtol=0,
                                   atol=OUT_TOL, err_msg=key)
    for key in ("mask", "text_mask"):
        np.testing.assert_array_equal(to_np(got[key]), np.asarray(want[key]))
    causal = TLM(port_lm_config(tiny_lm_config(gating="gelu", depformer_gating="relu")))
    early = causal.forward(tparams, torch.from_numpy(codes))["text_logits"][:, :, :4]
    assert max_abs(to_np(early), to_np(got["text_logits"][:, :, :4])) > 1e-3


# ------------------------------------------------------------- prefill
@pytest.mark.parametrize("kv,kv_repeat", [("int8", 1), ("int4", 1), ("int4", 2)])
def test_quantized_prefill_matches_jax(kv, kv_repeat):
    """Steps of T = 1 until one slot's ring of 8 has wrapped, another slot
    frozen in some, then a T = 5 chunk with a third slot frozen: each
    executing slot's outputs within OUT_TOL, the offsets equal, and every
    cache byte (k, v and both scales) equal to JAX's after every step.
    (Steps after the chunk are held within the port below: in f32 the
    two packages' products differ in their last bits, and a later row of
    layer 1 can round to the next quantization level; C.4.)"""
    cfg, jmodel, params, tmodel, tparams = _transformer(kv_cache_dtype=kv, kv_repeat=kv_repeat)
    B = 3
    rs = np.random.RandomState(6)
    plan = [(1, [1, 1, 1])] * 5 + [(1, [1, 0, 1])] * 4 + [(5, [1, 1, 0])]
    jstate, tstate = jmodel.init_state(B, jnp.float32), tmodel.init_state(B, torch.float32)
    step = jax.jit(jmodel.step)
    for T, mask in plan:
        x = (0.5 * rs.randn(B, T, cfg.d_model)).astype(np.float32)
        m = np.asarray(mask, bool)
        yj, jstate = step(params, jstate, jnp.asarray(x), exec_mask=jnp.asarray(m))
        yt, tstate = tmodel.step(tparams, tstate, torch.from_numpy(x),
                                 exec_mask=torch.from_numpy(m))
        assert max_abs(to_np(yt)[m], np.asarray(yj)[m]) <= OUT_TOL, T
        for name in ("k", "v", "k_scale", "v_scale"):
            assert _bytes_equal(tstate[name], jstate[name]), (T, name)
        np.testing.assert_array_equal(to_np(tstate["offset"]), np.asarray(jstate["offset"]))
    np.testing.assert_array_equal(to_np(tstate["offset"]), [14, 10, 9])


def _per_step_and_chunked(kv: str):
    """The same 12 positions through two fresh states: one at a time, and
    as 3 steps, a chunk of 6 and 3 steps.  Outputs [2, 12, 64] each."""
    _, _, _, tmodel, tparams = _transformer(kv_cache_dtype=kv, context=16)
    x = torch.from_numpy((0.5 * np.random.RandomState(7).randn(2, 12, 64)).astype(np.float32))
    per_state, chunk_state = (tmodel.init_state(2, torch.float32) for _ in range(2))
    per = torch.cat([tmodel.step(tparams, per_state, x[:, t:t + 1])[0] for t in range(12)], 1)
    chunked = torch.cat([tmodel.step(tparams, chunk_state, x[:, a:b])[0]
                         for a, b in ((0, 1), (1, 2), (2, 3), (3, 9), (9, 10), (10, 11),
                                      (11, 12))], 1)
    return per, chunked


@pytest.mark.parametrize("kv", ["model", "int8", "int4"])
def test_chunked_equals_per_step(kv):
    """Within the port, chunked against per-step: every output within
    OUT_TOL over the model-dtype and int8 caches.  Over int4, a T = 1 step
    merges its own row unquantized where a chunk reads its rows back from
    the cache, so the two runs differ: by less, norm-relative, than the
    per-step int4 run differs from the model-dtype one (the cache's own
    quantization error)."""
    per, chunked = _per_step_and_chunked(kv)
    if kv != "int4":
        assert max_abs(to_np(chunked), to_np(per)) <= OUT_TOL
        return
    exact, _ = _per_step_and_chunked("model")
    assert float((chunked - per).norm()) < float((per - exact).norm())


# --------------------------------------------------------- batched TTS
@pytest.fixture(scope="module")
def voiced_ckpt(tmp_path_factory):
    return write_tts_checkpoint(tmp_path_factory.mktemp("tts_voiced"), True)


def test_batched_tts_above_16_rows_matches_jax(voiced_ckpt):
    """True CFG (cfg_coef 2.0 on a model without the `cfg` condition) on 9
    slots runs 18 model rows through the port's engine: two voiced greedy
    sessions give the tokens, words and PCM of JAX's engine at 9 slots."""
    voices = str(voiced_ckpt / "voices")
    st = tbt.build_state(CheckpointInfo.from_dir(voiced_ckpt), batch_size=9, device="cpu",
                         temp=0.0, cfg_coef=2.0, voice_dir=voices)
    assert (st.mult, st.h.shape[0]) == (2, 18)
    tokens = []
    record_port_tokens(st, tokens)
    got = asyncio.run(two_voiced_sessions(st, lambda s, p, t: _drain_port(st, s, p, t), tokens))
    jt, jp, jm, jcp = jrun.build_tts_from_info(JInfo.from_dir(voiced_ckpt), temp=0.0,
                                               cfg_coef=2.0, voice_repo=voices)
    jst = jbt.BatchedTTSState(jt, jp, jm, batch_size=9, rng=jax.random.PRNGKey(2),
                              condition_params=jcp)
    jtokens = []
    record_jax_tokens(jst, jtokens)
    want = asyncio.run(two_voiced_sessions(
        jst, lambda s, p, t: _drain_jax(jst.slots[s], p, t), jtokens))
    np.testing.assert_array_equal(got[0], want[0])
    for b in range(2):
        same_session((got[0][:, b], got[1][b], got[2][b]),
                     (want[0][:, b], want[1][b], want[2][b]))
