"""Mimi's remaining options held against moshi_tpu on the CPU in f32:
replicate padding, SEANet shortcut convolutions (`true_skip=False`), a
gelu-gated transformer wider than the SEANet, so that both of its
projections are real, causal and acausal; and a PyTorch-named checkpoint
with those weights through both packages' loaders.

The weights are one JAX `init_params` tree (converted by `from_jax`) for
every test here; the PCM comes from a numpy seed.  Tolerances: codes
equal, PCM within OUT_TOL, trees equal leaf for leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models import loaders as jl
from moshi_tpu.models.mimi import MimiConfig as JMimiConfig
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.modules.seanet import SEANetConfig as JSEANetConfig
from moshi_tpu.modules.transformer import TransformerConfig as JTransformerConfig
from moshi_tpu.quantization.vq import RVQConfig as JRVQConfig
from moshi_tpu_torch.models import loaders as tl
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.utils.params import from_jax
from test_torch_checkpoint import _conv_to_torch, assert_same_tree, mimi_torch_state
from test_torch_port import max_abs, port_mimi_config, to_np

OUT_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_lora.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mimi_options_config(causal: bool) -> JMimiConfig:
    """The 1200 Hz tiny Mimi (tests/test_mimi.py) with every option on:
    replicate padding, shortcut convs, a gelu-gated transformer of width 48
    between 32-wide ends (both projections real)."""
    seanet = JSEANetConfig(channels=1, dimension=32, n_filters=4, n_residual_layers=1,
                           ratios=(4, 3, 2), kernel_size=7, residual_kernel_size=3,
                           last_kernel_size=3, dilation_base=2, compress=2,
                           pad_mode="replicate", true_skip=False)
    tr = JTransformerConfig(d_model=48, num_heads=2, num_layers=2, dim_feedforward=96,
                            causal=causal, context=25, positional_embedding="rope",
                            gating="gelu", norm="layer_norm", layer_scale=0.01)
    q = JRVQConfig(dimension=16, input_dimension=32, output_dimension=32, n_q=8, bins=32)
    return JMimiConfig(sample_rate=1200, channels=1, frame_rate=12.5, seanet=seanet,
                       transformer=tr, quantizer=q, num_codebooks=4)


@pytest.fixture(scope="module")
def mimi_params():
    """One JAX Mimi tree for every Mimi test here (jitted: the eager init
    compiles each of its ops apart); causal or not, the trees are alike."""
    return jax.jit(JMimi(mimi_options_config(True)).init_params)(jax.random.PRNGKey(3))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "acausal"])
def test_mimi_options_match_jax(causal, mimi_params):
    """encode, decode and the streaming steps: codes equal, PCM within
    OUT_TOL; with a causal transformer the port's streaming equals its
    offline path too (an acausal one differs by design, in JAX as well)."""
    jcfg = mimi_options_config(causal)
    jm, params = JMimi(jcfg), mimi_params
    tcfg = port_mimi_config(jcfg)
    tm, tp = TMimi(tcfg), from_jax(jax.device_get(params), mimi_config=tcfg)
    assert "input_proj" in tp["encoder_transformer"]
    assert "weight" in tp["decoder_transformer"]["output_projs"][0]
    assert "shortcut" in tp["encoder"]["model"][1]
    B, frames, fs = 2, 5, jcfg.frame_size
    pcm = (0.3 * np.random.RandomState(4).randn(B, 1, frames * fs)).astype(np.float32)
    jcodes = np.asarray(jax.jit(jm.encode)(params, jnp.asarray(pcm)))
    tcodes = to_np(tm.encode(tp, torch.from_numpy(pcm)))
    jcodes = jcodes.copy()
    np.testing.assert_array_equal(tcodes, jcodes)
    assert max_abs(to_np(tm.decode(tp, torch.from_numpy(jcodes))),
                   jax.jit(jm.decode)(params, jnp.asarray(jcodes))) <= OUT_TOL

    jst, tst = jm.init_encode_state(B), tm.init_encode_state(B)
    jdec, tdec = jm.init_decode_state(B), tm.init_decode_state(B)
    encode_step, decode_step = jax.jit(jm.encode_step), jax.jit(jm.decode_step)
    for i in range(frames):
        chunk = pcm[..., i * fs:(i + 1) * fs]
        jc, jst = encode_step(params, jst, jnp.asarray(chunk))
        tc, _ = tm.encode_step(tp, tst, torch.from_numpy(chunk))
        np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
        if causal:
            np.testing.assert_array_equal(to_np(tc), tcodes[..., i:i + 1])
        ja, jdec = decode_step(params, jdec, jc)
        ta, _ = tm.decode_step(tp, tdec, tc)
        assert max_abs(to_np(ta), ja) <= OUT_TOL


def test_mimi_options_load_alike(mimi_params):
    """A PyTorch-named Mimi with shortcut convs and both transformer
    projections: both packages' loaders give the same tree, and
    mimi_config_from_dict takes pad_mode and causal as JAX's does."""
    jcfg = mimi_options_config(False)
    jm = JMimi(jcfg)
    params = jax.device_get(mimi_params)
    state = mimi_torch_state(jm, params)
    for name, net in (("encoder", jm.encoder), ("decoder", jm.decoder)):
        for (kind, _, _), ti, p in zip(net.items, net.torch_indices, params[name]["model"]):
            if kind == "block":
                key = f"{name}.model.{ti}.shortcut.conv.conv"
                state[key + ".weight"] = _conv_to_torch(p["shortcut"]["weight"])
                state[key + ".bias"] = np.asarray(p["shortcut"]["bias"])
    for name in ("encoder_transformer", "decoder_transformer"):
        state[f"{name}.input_proj.weight"] = np.asarray(params[name]["input_proj"]["weight"]).T
        state[f"{name}.output_projs.0.weight"] = np.asarray(
            params[name]["output_projs"][0]["weight"]).T
    mcfg = {"sample_rate": 1200, "frame_rate": 12.5,
            "seanet": {"dimension": 32, "n_filters": 4, "ratios": [4, 3, 2],
                       "pad_mode": "replicate"},
            "transformer": {"d_model": 48, "num_heads": 2, "num_layers": 2,
                            "dim_feedforward": 96, "causal": False, "context": 25,
                            "gating": "gelu"},
            "quantizer": {"dimension": 16, "n_q": 8, "bins": 32}}
    want_cfg = jl.mimi_config_from_dict(mcfg, 4)
    got_cfg = tl.mimi_config_from_dict(mcfg, 4)
    assert got_cfg.seanet.pad_mode == "replicate" and not got_cfg.transformer.causal
    assert got_cfg == port_mimi_config(want_cfg)
    jparams = jl.mimi_params_from_torch_state(jm, {k: jnp.asarray(v) for k, v in state.items()})
    tm = TMimi(port_mimi_config(jcfg))
    tparams = tl.mimi_params_from_torch_state(
        tm, {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in state.items()})
    assert_same_tree(tparams, from_jax(jax.device_get(jparams), mimi_config=tm.config))
