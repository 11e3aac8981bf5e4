"""The port's offline halves against moshi_tpu's, in f32 on the CPU, on
weights converted from moshi_tpu: the `apply` of the convolutions,
resampling and SEANet modules, StreamingTransformer.apply, Mimi's encode /
decode / decode_latent / encode_to_latent, the LM's delay_sequence /
undelay_logits / forward_text / forward, and TTSModel.get_prefix; and
streaming == offline inside the port (transformer and Mimi)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models import lm as jlm
from moshi_tpu.models import tts as jtts
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.modules import conv as jconv, resample as jres, transformer as jtr
from moshi_tpu.utils.quantize import quantize_lm_params
from moshi_tpu_torch.models import lm as tlm
from moshi_tpu_torch.models import tts as ttts
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.modules import conv as tconv, resample as tres, transformer as ttr
from moshi_tpu_torch.utils.params import from_jax
from test_lm import tiny_lm_config
from test_mimi import tiny_mimi_config
from test_torch_port import max_abs, port_config, port_lm_config, port_mimi_config, to_np
from test_tts_asr import FakeTokenizer

CONV_TOL = 1e-5   # f32, same weights: accumulation order only
TR_TOL = 2e-4     # f32 transformer, JAX's own bound (tests/test_transformer.py:38)
PCM_TOL = 1e-4    # f32 Mimi decode (tests/test_torch_mimi.py)
LOGIT_TOL = 1e-4  # f32 LM logits


# ------------------------------------------------------------ convolutions
# cin, cout, kernel, stride, dilation, groups, pad_mode, T (9, 11 and 13
# are not multiples of their strides)
CONV_CASES = {
    "replicate_s2": (3, 5, 4, 2, 1, 1, "replicate", 9),
    "constant_dilated_groups": (4, 4, 3, 1, 2, 2, "constant", 10),
    "constant_s3": (6, 4, 7, 3, 1, 1, "constant", 11),
    "replicate_s4_groups": (4, 8, 8, 4, 1, 4, "replicate", 13),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_apply_matches_jax(case):
    cin, cout, K, stride, dil, groups, pad, T = CONV_CASES[case]
    jmod = jconv.StreamingConv1d(cin, cout, K, stride=stride, dilation=dil, groups=groups,
                                 pad_mode=pad)
    tmod = tconv.StreamingConv1d(cin, cout, K, stride=stride, dilation=dil, groups=groups,
                                 pad_mode=pad)
    p = jmod.init_params(jax.random.PRNGKey(K))
    tp = from_jax(jax.device_get(p))
    tp["weight"] = tconv.conv_from_jax(tp["weight"])
    x = np.random.RandomState(K).randn(2, T, cin).astype(np.float32)
    yj = jmod.apply(p, jnp.asarray(x))
    yt = tmod.apply(tp, torch.from_numpy(x))
    assert tuple(yt.shape) == yj.shape
    assert max_abs(to_np(yt), yj) <= CONV_TOL


# cin, cout, kernel, stride, groups, T
CONVTR_CASES = {"s2": (6, 4, 4, 2, 1, 5), "s3_groups": (4, 4, 6, 3, 4, 7),
                "depthwise_s4": (8, 8, 8, 4, 8, 3)}


@pytest.mark.parametrize("case", sorted(CONVTR_CASES))
def test_conv_transpose_apply_matches_jax(case):
    cin, cout, K, stride, groups, T = CONVTR_CASES[case]
    jmod = jconv.StreamingConvTranspose1d(cin, cout, K, stride=stride, groups=groups)
    tmod = tconv.StreamingConvTranspose1d(cin, cout, K, stride=stride, groups=groups)
    p = jmod.init_params(jax.random.PRNGKey(K))
    tp = from_jax(jax.device_get(p))
    tp["weight"] = tconv.convtr_from_jax(tp["weight"], groups)
    x = np.random.RandomState(K).randn(2, T, cin).astype(np.float32)
    yj = jmod.apply(p, jnp.asarray(x))
    yt = tmod.apply(tp, torch.from_numpy(x))
    assert tuple(yt.shape) == yj.shape == (2, T * stride, cout)
    assert max_abs(to_np(yt), yj) <= CONV_TOL


@pytest.mark.parametrize("learnt", [True, False])
@pytest.mark.parametrize("kind", ["down", "up"])
def test_resample_apply_matches_jax(kind, learnt):
    """The learnt stride-2 resampling of Mimi (the upsample depthwise, as
    Mimi v0.1's 512-group one) and the fixed filters, over 7 steps."""
    S, C, T = 2, 6, 7
    if kind == "down":
        jmod = jres.ConvDownsample1d(S, C, learnt=learnt)
        tmod = tres.ConvDownsample1d(S, C, learnt=learnt)
        relayout = tconv.conv_from_jax
    else:
        jmod = jres.ConvTrUpsample1d(S, C, learnt=learnt, channel_wise=True)
        tmod = tres.ConvTrUpsample1d(S, C, learnt=learnt, channel_wise=True)

        def relayout(w):
            return tconv.convtr_from_jax(w, tmod.convtr.groups)
    p = jmod.init_params(jax.random.PRNGKey(3))
    tp = {"weight": relayout(from_jax(jax.device_get(p))["weight"])}
    x = np.random.RandomState(3).randn(2, T, C).astype(np.float32)
    yj = jmod.apply(p, jnp.asarray(x))
    yt = tmod.apply(tp, torch.from_numpy(x))
    assert tuple(yt.shape) == yj.shape
    assert max_abs(to_np(yt), yj) <= CONV_TOL


@pytest.fixture(scope="module")
def mimi_pair():
    cfg = tiny_mimi_config()
    jm = JMimi(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tcfg = port_mimi_config(cfg)
    return jm, params, TMimi(tcfg), from_jax(jax.device_get(params), mimi_config=tcfg)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_seanet_apply_matches_jax(mimi_pair, part):
    """SEANet's encoder (strided convs, residual blocks) and decoder
    (transposed convs) of the tiny Mimi, over 37 and 9 steps."""
    jm, params, tm, tparams = mimi_pair
    jmod, tmod = getattr(jm, part), getattr(tm, part)
    T, C = (37, 1) if part == "encoder" else (9, tm.config.seanet.dimension)
    x = np.random.RandomState(5).randn(2, T, C).astype(np.float32)
    yj = jmod.apply(params[part], jnp.asarray(x))
    yt = tmod.apply(tparams[part], torch.from_numpy(x))
    assert tuple(yt.shape) == yj.shape
    assert max_abs(to_np(yt), yj) <= CONV_TOL * max(1.0, float(np.abs(np.asarray(yj)).max()))


# ------------------------------------------------------------- transformer
LM = dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=264, context=6,
          gating="silu", norm="rms_norm_f32", positional_embedding="rope")
SIN = dict(d_model=32, num_heads=2, num_layers=2, dim_feedforward=64, context=None,
           gating="none", norm="layer_norm", layer_scale=0.01, positional_embedding="sin")
DEP = dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128, context=None,
           gating="silu", norm="rms_norm_f32", positional_embedding="none",
           weights_per_step=4)
CROSS = dict(LM, context=None, cross_attention=True, cross_attention_kv_dim=24)

# name: (config, quantization, cross-attention source)
APPLY_CASES = {
    "rope_context_below_T": (LM, None, False),
    "rope_concat_kv_repeat": (dict(LM, kv_repeat=2, positional_embedding="rope_concat",
                                   norm="rms_norm"), None, False),
    "sin": (SIN, None, False),
    "sin_rope": (dict(SIN, positional_embedding="sin_rope"), None, False),
    "per_step": (DEP, None, False),
    "per_step_schedule": (dict(DEP, weights_per_step_schedule=(0, 1, 1, 0)), None, False),
    "per_step_int8": (DEP, "int8", False),
    "q4": (LM, "int4", False),
    "int8": (LM, "int8", False),
    "cross_per_layer": (dict(CROSS, cross_attention_gating="conditional_gated_tanh_learnable_bias"),
                        None, True),
    "cross_shared": (dict(CROSS, shared_cross_attn=True,
                          cross_attention_gating="conditional_gated_sigmoid",
                          cross_attention_norm="rms_norm_f32"), None, True),
    "cross_constant_gate_q4": (dict(CROSS, cross_attention_gating="constant_gated_tanh"),
                               "int4", True),
}


def _transformers(cfg_kw, quant=None):
    cfg = jtr.TransformerConfig(**cfg_kw)
    jmodel = jtr.StreamingTransformer(cfg)
    params = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params = quantize_lm_params(params, min_size=1, mode=quant)
    tmodel = ttr.StreamingTransformer(port_config(ttr.TransformerConfig, cfg))
    return cfg, jmodel, params, tmodel, from_jax(jax.device_get(params))


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_transformer_apply_matches_jax(case):
    cfg_kw, quant, cross = APPLY_CASES[case]
    cfg, jmodel, params, tmodel, tparams = _transformers(cfg_kw, quant)
    if quant == "int4":
        assert type(tparams["layers"]["attn"]["in_proj"]).__name__ == "QTensor4"
    rs = np.random.RandomState(1)
    B, T = 2, (cfg.weights_per_step or 10)
    x = rs.randn(B, T, cfg.d_model).astype(np.float32)
    src = rs.randn(B, 5, cfg.xa_kv_dim).astype(np.float32) if cross else None
    kw = {} if src is None else {"cross_src": jnp.asarray(src)}
    yj = jmodel.apply(params, jnp.asarray(x), **kw)
    yt = tmodel.apply(tparams, torch.from_numpy(x),
                      cross_src=None if src is None else torch.from_numpy(src))
    assert tuple(yt.shape) == yj.shape
    assert max_abs(to_np(yt), yj) <= TR_TOL


def test_steps_to_weight_indices_match_jax():
    for sched in (None, (0, 1, 1, 0), (2, 0, 1, 1)):
        cfg = jtr.TransformerConfig(**dict(DEP, weights_per_step_schedule=sched))
        tcfg = port_config(ttr.TransformerConfig, cfg)
        assert tcfg.num_weights == cfg.num_weights
        steps = [3, 0, 2]
        ref = cfg.steps_to_weight_indices(jnp.asarray(steps, jnp.int32))
        assert tcfg.steps_to_weight_indices(steps) == np.asarray(ref).tolist()


# Streaming == offline inside the port, the counterparts of
# tests/test_transformer.py:23 (chunks within the ring's capacity) and :41
# (single steps while the ring wraps past the context)
STREAM = dict(d_model=64, num_heads=4, num_layers=3, dim_feedforward=256, context=32,
              gating="silu", norm="rms_norm_f32", positional_embedding="rope")
WRAP = dict(d_model=32, num_heads=2, num_layers=2, dim_feedforward=64, context=6,
            gating="silu", norm="rms_norm_f32", positional_embedding="rope")


@pytest.mark.parametrize("cfg_kw,T,chunk", [(STREAM, 24, 1), (STREAM, 24, 3), (STREAM, 24, 8),
                                            (dict(SIN, context=32), 24, 3), (WRAP, 40, 1)],
                         ids=["chunk1", "chunk3", "chunk8", "sin_chunk3", "ring_wraps"])
def test_transformer_streaming_matches_apply(cfg_kw, T, chunk):
    _, _, _, tmodel, tparams = _transformers(cfg_kw)
    B = 2
    x = torch.from_numpy(np.random.RandomState(2).randn(B, T, cfg_kw["d_model"])
                         .astype(np.float32))
    y_ref = tmodel.apply(tparams, x)
    state = tmodel.init_state(B, torch.float32)
    ys = []
    for off in range(0, T, chunk):
        y, state = tmodel.step(tparams, state, x[:, off:off + chunk])
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_ref.numpy(),
                               rtol=TR_TOL, atol=TR_TOL)


# -------------------------------------------------------------------- Mimi
def test_mimi_offline_matches_jax(mimi_pair):
    """encode (the input not a whole number of frames: zero-padded), decode,
    decode_latent, encode_to_latent with and without quantization: codes
    bit-exact, PCM and latents within PCM_TOL."""
    jm, params, tm, tparams = mimi_pair
    x = (0.3 * np.random.RandomState(0).randn(2, 1, 5 * jm.frame_size + 17)).astype(np.float32)
    cj = jm.encode(params, jnp.asarray(x))
    ct = tm.encode(tparams, torch.from_numpy(x))
    assert tuple(ct.shape) == cj.shape == (2, jm.num_codebooks, 6)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    pj, pt = jm.decode(params, cj), tm.decode(tparams, ct)
    assert tuple(pt.shape) == pj.shape == (2, 1, 6 * jm.frame_size)
    assert max_abs(to_np(pt), pj) <= PCM_TOL
    assert max_abs(to_np(tm.decode_latent(tparams, ct)), jm.decode_latent(params, cj)) <= PCM_TOL
    for quantize in (True, False):
        lj = jm.encode_to_latent(params, jnp.asarray(x), quantize=quantize)
        lt = tm.encode_to_latent(tparams, torch.from_numpy(x), quantize=quantize)
        assert tuple(lt.shape) == lj.shape
        assert max_abs(to_np(lt), lj) <= PCM_TOL


def test_mimi_streaming_matches_offline(mimi_pair):
    """The port's encode_step / decode_step frame by frame from a fresh
    state against its encode / decode (tests/test_mimi.py:31): codes
    equal, PCM within PCM_TOL."""
    _, _, tm, tparams = mimi_pair
    B, n, fs = 2, 6, tm.frame_size
    x = torch.from_numpy((0.3 * np.random.RandomState(1).randn(B, 1, n * fs))
                         .astype(np.float32))
    codes = tm.encode(tparams, x)
    pcm = tm.decode(tparams, codes)
    enc, dec = tm.init_encode_state(B), tm.init_decode_state(B)
    for f in range(n):
        c, _ = tm.encode_step(tparams, enc, x[:, :, f * fs:(f + 1) * fs])
        np.testing.assert_array_equal(c.numpy(), codes[:, :, f:f + 1].numpy())
        p, _ = tm.decode_step(tparams, dec, codes[:, :, f:f + 1])
        assert max_abs(p.numpy(), pcm[:, :, f * fs:(f + 1) * fs].numpy()) <= PCM_TOL


def test_full_size_v0_1_offline_matches_jax():
    """Mimi v0.1 at its released width (ratios 8,6,5,4, 512-d transformers,
    stride-2 resampling, the 512-group transposed upsample) over 3 frames:
    offline codes bit-exact, decoded PCM close."""
    from moshi_tpu.models.mimi import mimi_v0_1_config
    from moshi_tpu_torch.models import mimi as tmimi

    cfg = mimi_v0_1_config(8)
    jm = JMimi(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tcfg = tmimi.mimi_v0_1_config(8)
    tm = TMimi(tcfg)
    tparams = from_jax(jax.device_get(params), mimi_config=tcfg)
    x = (0.2 * np.random.RandomState(2).randn(1, 1, 3 * jm.frame_size)).astype(np.float32)
    cj = jm.encode(params, jnp.asarray(x))
    ct = tm.encode(tparams, torch.from_numpy(x))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    pj, pt = jm.decode(params, cj), tm.decode(tparams, ct)
    assert tuple(pt.shape) == pj.shape == (1, 1, 3 * jm.frame_size)
    assert max_abs(to_np(pt), pj) <= PCM_TOL * max(1.0, float(np.abs(np.asarray(pj)).max()))


# ---------------------------------------------------------------------- LM
def test_delay_and_undelay_match_jax():
    delays = (0, 1, 3, 2)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 10, (2, 4, 6))
    initial = rs.randint(90, 99, (2, 4))
    dj = jlm.delay_sequence(delays, jnp.asarray(toks), jnp.asarray(initial))
    dt = tlm.delay_sequence(delays, torch.from_numpy(toks), torch.from_numpy(initial))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    logits = rs.randn(2, 4, 6, 5).astype(np.float32)
    lj, mj = jlm.undelay_logits(delays, jnp.asarray(logits))
    lt, mt = tlm.undelay_logits(delays, torch.from_numpy(logits))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))  # NaN where JAX's are
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def _lm_pair(quant="int4", **over):
    """A tiny LM whose temporal linears and text head are all q4 (din a
    multiple of 64: dim 64, hidden 192) and whose depformer is int8."""
    cfg = tiny_lm_config(dim=64, hidden_scale=4.5, **over)
    model = jlm.LMModel(cfg)
    params = model.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params = quantize_lm_params(params, min_size=1, mode=quant)
    tparams = from_jax(jax.device_get(params))
    return cfg, model, params, tlm.LMModel(port_lm_config(cfg)), tparams


def _codes(cfg, B, T, seed):
    rs = np.random.RandomState(seed)
    codes = rs.randint(0, cfg.card, (B, cfg.num_codebooks, T))
    codes[:, 0] = rs.randint(0, cfg.text_card, (B, T))
    codes[0, 2, 3] = jlm.ZERO_TOKEN  # a masked target
    return codes


def _assert_logits(t, j):
    j = np.asarray(j)
    t = to_np(t)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    finite = ~np.isnan(j)
    assert max_abs(t[finite], j[finite]) <= LOGIT_TOL


def test_lm_forward_matches_jax():
    """LMModel.forward, q4 temporal linears and text head (the q4 wrapper at
    M = B * T rows) and an int8 depformer: logits, text logits and both
    masks."""
    cfg, jmodel, params, tmodel, tparams = _lm_pair()
    w = tparams["transformer"]["layers"]
    assert type(w["attn"]["in_proj"]).__name__ == "QTensor4"
    assert type(w["mlp"]["linear_out"]).__name__ == "QTensor4"
    assert type(tparams["text_linear"]["weight"]).__name__ == "QTensor4"
    assert type(tparams["depformer"]["layers"]["attn"]["in_proj"]).__name__ == "QTensor"
    codes = _codes(cfg, 2, 9, 0)
    oj = jmodel.forward(params, jnp.asarray(codes))
    ot = tmodel.forward(tparams, torch.from_numpy(codes))
    for key in ("logits", "text_logits"):
        assert tuple(ot[key].shape) == oj[key].shape
        _assert_logits(ot[key], oj[key])
    for key in ("mask", "text_mask"):
        np.testing.assert_array_equal(ot[key].numpy(), np.asarray(oj[key]))
    assert not ot["mask"][0, 1, 3]  # the ZERO_TOKEN target


def test_lm_forward_text_with_sum_condition_matches_jax():
    cfg, jmodel, params, tmodel, tparams = _lm_pair()
    seq = _codes(cfg, 2, 7, 1)
    cond = np.random.RandomState(1).randn(2, 1, cfg.dim).astype(np.float32)
    hj, lj = jmodel.forward_text(params, jnp.asarray(seq), sum_condition=jnp.asarray(cond))
    ht, lt = tmodel.forward_text(tparams, torch.from_numpy(seq),
                                 sum_condition=torch.from_numpy(cond))
    assert tuple(lt.shape) == lj.shape == (2, 1, 7, cfg.text_card)
    assert max_abs(to_np(ht), hj) <= LOGIT_TOL
    assert max_abs(to_np(lt), lj) <= LOGIT_TOL


def test_lm_forward_text_with_cross_src_matches_jax():
    """A tiny TTS-like LM (cross-attention over a conditioning source, a
    text head of text_card_out columns), f32 weights."""
    cfg, jmodel, params, tmodel, tparams = _lm_pair(
        quant=None, cross_attention=True, text_card_out=65, num_heads=2)
    rs = np.random.RandomState(2)
    seq = _codes(cfg, 2, 6, 2)
    src = rs.randn(2, 4, cfg.dim).astype(np.float32)
    hj, lj = jmodel.forward_text(params, jnp.asarray(seq), cross_src=jnp.asarray(src))
    ht, lt = tmodel.forward_text(tparams, torch.from_numpy(seq),
                                 cross_src=torch.from_numpy(src))
    assert tuple(lt.shape) == lj.shape == (2, 1, 6, 65)
    assert max_abs(to_np(lt), lj) <= LOGIT_TOL


def test_lm_forward_text_matches_streaming():
    """forward_text against single forward_text_step calls over the ring KV
    cache (f32), the check [offline] makes on the card in bf16."""
    cfg, _, _, tmodel, tparams = _lm_pair(context=16)
    seq = torch.from_numpy(_codes(cfg, 2, 12, 3))
    seq[0, 2, 3] = 0
    _, logits = tmodel.forward_text(tparams, seq)
    state = tmodel.transformer.init_state(2, torch.float32)
    for t in range(seq.shape[-1]):
        _, lt, state = tmodel.forward_text_step(tparams, state, seq[:, :, t:t + 1])
        assert max_abs(lt[:, :, 0].numpy(), logits[:, :, t].numpy()) <= LOGIT_TOL


# --------------------------------------------------------------------- TTS
def _tts_pair():
    cfg = tiny_lm_config(n_q=2, dep_q=2, delays=(0, 0, 1))
    jmodel = jlm.LMModel(cfg)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float32))
    jm = JMimi(tiny_mimi_config())
    mparams = jax.device_get(jm.init_params(jax.random.PRNGKey(1)))
    kw = dict(delay_steps=2, temp=0.0, n_q=2, max_gen_length=40, final_padding=2)

    def machine(mod):
        return mod.StateMachine(mod.TokenIds(card=cfg.text_card + 1), max_padding=3,
                                initial_padding=1)
    jt = jtts.TTSModel(jmodel, jm, FakeTokenizer(), machine(jtts), **kw)
    tmcfg = port_mimi_config(tiny_mimi_config())
    tt = ttts.TTSModel(tlm.LMModel(port_lm_config(cfg)), TMimi(tmcfg), FakeTokenizer(),
                       machine(ttts), **kw)
    return (jt, params, mparams), (tt, from_jax(params), from_jax(mparams, mimi_config=tmcfg))


def test_tts_get_prefix_and_generate_match_jax():
    """get_prefix of the same PCM equals JAX's (a ZERO_TOKEN text row, the
    codec's codebooks trimmed to n_q, the last two frames dropped); then
    greedy generate with that prefix (tests/test_tts_prefix.py:16) gives
    JAX's frames and text tokens."""
    (jt, jp, jm), (tt, tp, tm) = _tts_pair()
    wav = (0.3 * np.random.RandomState(4).randn(7 * tt.mimi.frame_size + 11)).astype(np.float32)
    pj, pt = jt.get_prefix(jm, wav), tt.get_prefix(tm, wav)
    assert pt.shape == (1 + 2, 6) and pt.dtype == np.int64
    np.testing.assert_array_equal(pt, np.asarray(pj))
    assert (pt[0] == ttts.ZERO_TOKEN).all()
    entries = [["hi there"], ["bye"]]
    jr = jt.generate(jp, [jt.prepare_script(s) for s in entries], prefixes=[pj, pj[:, :4]],
                     rng=jax.random.PRNGKey(2))
    tr = tt.generate(tp, [tt.prepare_script(s) for s in entries], prefixes=[pt, pt[:, :4]])
    assert len(tr.frames) == len(jr.frames) > 6
    for a, b in zip(tr.frames, jr.frames):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tr.logged_text_tokens == jr.logged_text_tokens
    assert tr.end_steps == jr.end_steps


def test_tts_get_prefix_marks_missing_codebooks_ungenerated():
    """An LM of more codebooks than the codec has: the extra rows stay
    UNGENERATED_TOKEN, as in JAX."""
    (jt, jp, jm), (tt, tp, tm) = _tts_pair()
    n_q = 6  # the tiny Mimi has 4 codebooks
    jt.lm.config = dataclasses.replace(jt.lm.config, n_q=n_q)
    tt.lm.config = dataclasses.replace(tt.lm.config, n_q=n_q)
    wav = (0.3 * np.random.RandomState(5).randn(5 * tt.mimi.frame_size)).astype(np.float32)
    pt = tt.get_prefix(tm, wav)
    np.testing.assert_array_equal(pt, np.asarray(jt.get_prefix(jm, wav)))
    assert pt.shape == (1 + n_q, 3)
    assert (pt[1 + tt.mimi.num_codebooks:] == ttts.UNGENERATED_TOKEN).all()
    assert (pt[1:1 + tt.mimi.num_codebooks] >= 0).all()
