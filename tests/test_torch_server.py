"""The port's slice as a whole: a tiny ServerState in each package, on the
same converted weights, fed the same PCM frames with greedy decoding; the
port imports no JAX; chip_smoke.py refuses to run without a CUDA device."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.loaders import CheckpointInfo
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.serve.server import ServerState as JServerState
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.serve.server import ServerState as TServerState, serve_sessions
from moshi_tpu_torch.utils.params import from_jax
from test_lm import tiny_lm_config
from test_mimi import tiny_mimi_config
from test_torch_port import max_abs, port_lm_config, port_mimi_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 16


@pytest.fixture(scope="module")
def servers():
    cfg = tiny_lm_config(dim=64, num_heads=4, depformer_dim=32)
    jlm = JLM(cfg)
    lm_params = jlm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    mcfg = tiny_mimi_config()
    jmimi = JMimi(mcfg)
    mimi_params = jmimi.init_params(jax.random.PRNGKey(1))
    jstate = JServerState(CheckpointInfo({"model_type": "moshi"}), jmimi, mimi_params,
                          jlm, lm_params, None, use_sampling=False)
    tmcfg = port_mimi_config(mcfg)
    tstate = TServerState(TMimi(tmcfg),
                          from_jax(jax.device_get(mimi_params), mimi_config=tmcfg),
                          TLM(port_lm_config(cfg)), from_jax(jax.device_get(lm_params)),
                          device="cpu", use_sampling=False)
    return jstate, tstate


def _pcm(frame_size, seed=0):
    rs = np.random.RandomState(seed)
    return (0.3 * rs.randn(FRAMES, frame_size)).astype(np.float32)


def test_slice_matches_jax_server(servers):
    jstate, tstate = servers
    jstate.warmup()
    tstate.warmup()
    assert tstate.frame_size == jstate.frame_size
    generated = 0
    for chunk in _pcm(jstate.frame_size):
        jpcm, jtok, _ = jstate.step_frame(chunk)
        tpcm, ttok = tstate.step_frame(chunk)
        assert ttok == jtok
        if jpcm is None:
            assert tpcm is None
            continue
        generated += 1
        assert tpcm.shape == jpcm.shape == (jstate.frame_size,)
        assert max_abs(tpcm, jpcm) <= 1e-4
    assert generated == FRAMES - tstate.lm.config.max_delay
    np.testing.assert_array_equal(np.stack(tstate.session_tokens),
                                  np.stack(jstate.session_tokens))


def test_reset_replays_the_first_session(servers):
    _, tstate = servers
    first, again = serve_sessions(tstate, [5, 5], FRAMES)
    np.testing.assert_array_equal(first[0], again[0])
    for a, b in zip(first[1], again[1]):
        np.testing.assert_array_equal(a, b)
    assert first[0].shape == (FRAMES - tstate.lm.config.max_delay,
                              1 + tstate.lm.config.dep_q)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_reset_rewrites_the_state_in_place(servers):
    """reset writes fresh values into the tensors the engine already holds
    (a CUDA graph captured over them stays valid): no state tensor moves,
    each state equals a new init_*_state, the generator is the same object
    and its seed the session's."""
    _, tstate = servers
    trees = (tstate.enc_state, tstate.dec_state, tstate.gen_state)
    ptrs = [t.data_ptr() for tree in trees for t in _tensors(tree)]
    generator = tstate.generator
    for chunk in _pcm(tstate.frame_size)[:6]:
        tstate.step_frame(chunk)
    tstate.session_seed = 9
    tstate.reset()
    assert [t.data_ptr() for tree in trees for t in _tensors(tree)] == ptrs
    assert tstate.generator is generator and tstate.gen_state["generator"] is generator
    assert generator.initial_seed() == 9
    md = tstate.mimi_dtype
    fresh = (tstate.mimi.init_encode_state(1, md, "cpu"),
             tstate.mimi.init_decode_state(1, md, "cpu"),
             tstate.lm_gen.init_state(1, None, torch.bfloat16, "cpu"))
    for tree, new in zip(trees, fresh):
        got, want = _tensors(tree), _tensors(new)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert tstate.session_tokens == [] and tstate.steps_done == 0


def test_sampled_sessions_of_one_seed_repeat_in_place(servers):
    """Sampling on, one engine: two sessions with one seed give the same
    tokens (reset reseeds the one generator), a third seed others."""
    _, tstate = servers
    sampled = TServerState(tstate.mimi, tstate.mimi_params, tstate.lm, tstate.lm_params,
                           device="cpu")
    assert not sampled.graphed and sampled.lm_gen.gc.use_sampling
    sampled.warmup()
    a, b, c = serve_sessions(sampled, [5, 5, 6], FRAMES)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])


def test_graphed_engines_need_a_cuda_device(servers):
    """graphed=True on the CPU raises; the CPU's engines run eagerly."""
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState
    from moshi_tpu_torch.utils.graphs import GraphedStep
    _, t = servers
    with pytest.raises(ValueError):
        TServerState(t.mimi, t.mimi_params, t.lm, t.lm_params, device="cpu", graphed=True)
    with pytest.raises(ValueError):
        BatchedMoshiState(t.mimi, t.mimi_params, t.lm, t.lm_params, 2, device="cpu",
                          graphed=True)
    step = GraphedStep(lambda x: x + 1, graphed=False)
    x = torch.zeros(2)
    assert torch.equal(step.warm_up(x), x + 1) and torch.equal(step(x), x + 1)
    assert step.graph is None and step.replays == 0


def test_port_imports_no_jax():
    """Every module of the port imports with jax absent from sys.modules."""
    code = ("import importlib, pkgutil, sys, moshi_tpu_torch\n"
            "for m in pkgutil.walk_packages(moshi_tpu_torch.__path__, 'moshi_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import moshi_tpu_torch.serve.server\n"
            "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    pkg = os.path.join(ROOT, "moshi_tpu_torch")
    names = [m.name for m in pkgutil.walk_packages([pkg])]
    assert names, "no modules found"
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pattern.search(fh.read()), f


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result when torch sees no
    CUDA device, and when it stands in a directory without the package."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

