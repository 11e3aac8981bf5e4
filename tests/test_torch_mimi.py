"""The port's Mimi against moshi_tpu's, in f32 on the CPU, on weights
converted from moshi_tpu: streaming encode gives bit-exact codes, streaming
decode PCM within 1e-4, and the conv layouts convert (grouped transposed
conv included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.modules import conv as jconv
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.modules import conv as tconv
from moshi_tpu_torch.utils.params import from_jax
from test_mimi import tiny_mimi_config
from test_torch_port import max_abs, port_mimi_config, to_np

FRAMES = 12


@pytest.fixture(scope="module")
def mimi_pair():
    cfg = tiny_mimi_config()
    jm = JMimi(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tcfg = port_mimi_config(cfg)
    return jm, params, TMimi(tcfg), from_jax(jax.device_get(params), mimi_config=tcfg)


def test_encode_step_codes_bit_exact(mimi_pair):
    jm, params, tm, tparams = mimi_pair
    B, fs = 2, jm.frame_size
    x = (0.3 * np.random.RandomState(0).randn(B, 1, FRAMES * fs)).astype(np.float32)
    jstate, tstate = jm.init_encode_state(B), tm.init_encode_state(B)
    enc = jax.jit(jm.encode_step)
    for f in range(FRAMES):
        chunk = x[:, :, f * fs:(f + 1) * fs]
        cj, jstate = enc(params, jstate, jnp.asarray(chunk))
        ct, tstate = tm.encode_step(tparams, tstate, torch.from_numpy(chunk))
        assert tuple(ct.shape) == (B, jm.num_codebooks, 1)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_decode_step_pcm_matches(mimi_pair):
    jm, params, tm, tparams = mimi_pair
    B = 2
    codes = np.random.RandomState(1).randint(0, jm.cardinality,
                                             (FRAMES, B, jm.num_codebooks, 1))
    jstate, tstate = jm.init_decode_state(B), tm.init_decode_state(B)
    dec = jax.jit(jm.decode_step)
    for c in codes:
        pj, jstate = dec(params, jstate, jnp.asarray(c, jnp.int32))
        pt, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(c))
        assert tuple(pt.shape) == (B, 1, jm.frame_size)
        assert max_abs(to_np(pt), pj) <= 1e-4


@pytest.mark.parametrize("groups,cin,cout", [(1, 6, 4), (4, 4, 4), (2, 6, 4)])
def test_conv_transpose_relayout(groups, cin, cout):
    """A grouped streaming ConvTranspose1d on weights converted from the JAX
    layout, against moshi_tpu's over several steps."""
    jmod = jconv.StreamingConvTranspose1d(cin, cout, 4, stride=2, groups=groups)
    tmod = tconv.StreamingConvTranspose1d(cin, cout, 4, stride=2, groups=groups)
    p = jmod.init_params(jax.random.PRNGKey(groups))
    tp = from_jax(jax.device_get(p))
    tp["weight"] = tconv.convtr_from_jax(tp["weight"], groups)
    js, ts = jmod.init_state(1), tmod.init_state(1)
    rs = np.random.RandomState(groups)
    for _ in range(4):
        x = rs.randn(1, 3, cin).astype(np.float32)
        yj, js = jmod.step(p, js, jnp.asarray(x))
        yt, ts = tmod.step(tp, ts, torch.from_numpy(x))
        assert max_abs(to_np(yt), yj) <= 1e-5


def test_conv_replicate_pad_stride():
    """The downsample's conv: replicate padding on the first step, stride."""
    jmod = jconv.StreamingConv1d(3, 5, 4, stride=2, pad_mode="replicate", bias=False)
    tmod = tconv.StreamingConv1d(3, 5, 4, stride=2, pad_mode="replicate", bias=False)
    p = jmod.init_params(jax.random.PRNGKey(0))
    tp = {"weight": tconv.conv_from_jax(from_jax(jax.device_get(p))["weight"])}
    js, ts = jmod.init_state(2), tmod.init_state(2)
    rs = np.random.RandomState(0)
    for _ in range(3):
        x = rs.randn(2, 4, 3).astype(np.float32)
        yj, js = jmod.step(p, js, jnp.asarray(x))
        yt, ts = tmod.step(tp, ts, torch.from_numpy(x))
        assert max_abs(to_np(yt), yj) <= 1e-5


def test_full_size_v0_1_streaming_matches_jax():
    """Mimi v0.1 at its released width (ratios 8,6,5,4, 512-d transformers,
    stride-2 resampling, 512-group transposed upsample), 3 frames: codes
    bit-exact, decoded PCM close."""
    from moshi_tpu.models.mimi import mimi_v0_1_config
    from moshi_tpu_torch.models import mimi as tmimi

    cfg = mimi_v0_1_config(8)
    jm = JMimi(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tcfg = tmimi.mimi_v0_1_config(8)
    tm = TMimi(tcfg)
    tparams = from_jax(jax.device_get(params), mimi_config=tcfg)
    fs = jm.frame_size
    x = (0.2 * np.random.RandomState(2).randn(3, 1, 1, fs)).astype(np.float32)
    js, ts = jm.init_encode_state(1), tm.init_encode_state(1)
    jd, td = jm.init_decode_state(1), tm.init_decode_state(1)
    enc, dec = jax.jit(jm.encode_step), jax.jit(jm.decode_step)
    for chunk in x:
        cj, js = enc(params, js, jnp.asarray(chunk))
        ct, ts = tm.encode_step(tparams, ts, torch.from_numpy(chunk))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        pj, jd = dec(params, jd, cj)
        pt, td = tm.decode_step(tparams, td, ct)
        assert tuple(pt.shape) == (1, 1, fs)
        assert max_abs(to_np(pt), pj) <= 1e-4 * max(1.0, float(np.abs(np.asarray(pj)).max()))
