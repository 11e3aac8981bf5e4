"""The port's batched frame engine (serve/batched_moshi.py) against
moshi_tpu's BatchedMoshiState, on the same converted weights with greedy
decoding and the int4 KV cache, over a schedule of joins, freezes and a
reset at B = 3; and the per-slot state helpers of utils/trees.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.serve.batched_moshi import BatchedMoshiState as JBatched
from moshi_tpu_torch.models.lm import UNGENERATED_TOKEN, LMModel as TLM
from moshi_tpu_torch.models.lm_gen import LMGen as TGen
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState as TBatched, serve_batched
from moshi_tpu_torch.utils.params import from_jax
from moshi_tpu_torch.utils.trees import masked_reset, put_slots, state_batch_axes, take_slots
from test_lm import tiny_lm_config
from test_mimi import tiny_mimi_config
from test_torch_port import max_abs, port_lm_config, port_mimi_config

B = 3
PCM_TOL = 1e-4  # f32 Mimi decode, port vs JAX (tests/test_torch_mimi.py)
# tick -> {slot: action}; a slot not named is frozen that tick.  Slot 2
# joins late, slot 1 freezes for two ticks, slot 0 starts a second session
# (reset) at tick 9, slot 2 freezes once more.
SCHEDULE = ([{0: "join", 1: "join"}] + [{0: "send", 1: "send"}] * 3
            + [{0: "send", 1: "send", 2: "join"}, {0: "send", 1: "send", 2: "send"}]
            + [{0: "send", 2: "send"}] * 2 + [{0: "send", 1: "send", 2: "send"}]
            + [{0: "join", 1: "send", 2: "send"}] + [{0: "send", 1: "send", 2: "send"}] * 2
            + [{0: "send", 1: "send"}] + [{0: "send", 1: "send", 2: "send"}] * 5)


def _config():
    return dataclasses.replace(tiny_lm_config(dim=64, num_heads=4, depformer_dim=32),
                               kv_cache_dtype="int4")


@pytest.fixture(scope="module")
def engines():
    cfg, mcfg = _config(), tiny_mimi_config()
    jlm, jmimi = JLM(cfg), JMimi(mcfg)
    lm_params = jlm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    mimi_params = jmimi.init_params(jax.random.PRNGKey(1))
    jstate = JBatched(jmimi, mimi_params, jlm, lm_params, None, B, jax.random.PRNGKey(2),
                      use_sampling=False)
    tmcfg = port_mimi_config(mcfg)
    tstate = TBatched(TMimi(tmcfg), from_jax(jax.device_get(mimi_params), mimi_config=tmcfg),
                      TLM(port_lm_config(cfg)), from_jax(jax.device_get(lm_params)), B,
                      device="cpu", use_sampling=False)
    return jstate, tstate


def _frames(frame_size):
    rs = np.random.RandomState(0)
    return {s: (0.3 * rs.randn(len(SCHEDULE), frame_size)).astype(np.float32)
            for s in range(B)}


def _jax_serve(state, schedule, frames):
    """serve_batched's loop over moshi_tpu's BatchedMoshiState (its _run_loop
    without the sockets)."""
    taken = dict.fromkeys(frames, 0)
    sessions = {s: [] for s in range(B)}
    for tick in schedule:
        chunk = np.zeros((B, 1, state.frame_size), np.float32)
        mask = np.zeros(B, bool)
        for s, action in tick.items():
            if action == "join":
                state.reset_slot(s)
                sessions[s].append(([], []))
            chunk[s, 0] = frames[s][taken[s]]
            taken[s] += 1
            if state.skip_frames[s] > 0:
                state.skip_frames[s] -= 1
                continue
            mask[s] = True
        if not mask.any():
            continue
        out, pcm, state.gen_state, state.enc_state, state.dec_state = state._frame(
            state.lm_params, state.mimi_params, state.gen_state, state.enc_state,
            state.dec_state, jnp.asarray(chunk), jnp.asarray(mask))
        out, pcm = np.asarray(out), np.asarray(pcm)
        for s in np.nonzero(mask)[0]:
            if (out[s] == UNGENERATED_TOKEN).any():
                continue
            sessions[s][-1][0].append(out[s, :, 0])
            sessions[s][-1][1].append(pcm[s, 0])
    return sessions


def test_batched_engine_matches_jax(engines):
    """Warm-up, joins with the first-frame skip, freezes and a reset: every
    session's greedy tokens identical to JAX's, its PCM within 1e-4."""
    jstate, tstate = engines
    jstate.warmup()
    tstate.warmup()
    frames = _frames(tstate.frame_size)
    jsessions = _jax_serve(jstate, SCHEDULE, frames)
    tsessions, ms = serve_batched(tstate, SCHEDULE, frames)
    assert len(ms) == len(SCHEDULE) - 1  # tick 0 only joins: no frame runs
    assert [len(s) for s in tsessions.values()] == [2, 1, 1]
    generated = 0
    for s in range(B):
        for (ttok, tpcm), (jtok, jpcm) in zip(tsessions[s], jsessions[s], strict=True):
            np.testing.assert_array_equal(ttok, np.array(jtok).reshape(ttok.shape))
            assert len(tpcm) == len(jpcm) == len(ttok)
            for a, b in zip(tpcm, jpcm):
                assert max_abs(a, b) <= PCM_TOL
            generated += len(ttok)
    assert generated > 20


def test_reset_slot_replays_the_session(engines):
    """A slot reset mid-run and fed the PCM another slot got from its start
    gives that slot's token stream, whatever the others do meanwhile."""
    _, tstate = engines
    tstate.reset_all()
    frames = _frames(tstate.frame_size)
    frames[2] = np.concatenate([frames[1][:6], frames[0]])
    schedule = ([{0: "join", 1: "join", 2: "join"}] + [dict.fromkeys(range(B), "send")] * 5
                + [{0: "send", 1: "send", 2: "join"}] + [dict.fromkeys(range(B), "send")] * 8)
    sessions, _ = serve_batched(tstate, schedule, frames)
    first, replay = sessions[0][0][0], sessions[2][1][0]
    assert len(replay) >= 5
    np.testing.assert_array_equal(replay, first[:len(replay)])


def _compare_axes(jax_tree, port_tree, path=()):
    """Pairs of (JAX axis, port axis) over the leaves the two trees share;
    the port's `generator` stands where JAX has `rng`."""
    if isinstance(jax_tree, dict):
        pairs = []
        for k, v in jax_tree.items():
            pk = "generator" if k == "rng" else k
            if pk in port_tree:
                pairs += _compare_axes(v, port_tree[pk], path + (k,))
        return pairs
    if isinstance(jax_tree, (list, tuple)):
        assert len(jax_tree) == len(port_tree), path
        return [p for i, (a, b) in enumerate(zip(jax_tree, port_tree))
                for p in _compare_axes(a, b, path + (i,))]
    return [(path, jax_tree, port_tree)]


def test_state_batch_axes_match_jax(engines):
    jstate, tstate = engines
    for jax_axes, port_axes in ((jstate._ax_gen, tstate._ax_gen),
                                (jstate._ax_enc, tstate._ax_enc),
                                (jstate._ax_dec, tstate._ax_dec)):
        pairs = _compare_axes(jax_axes, port_axes)
        assert len(pairs) > 3
        for path, a, b in pairs:
            assert a == b, path
    assert tstate._ax_gen["generator"] is None
    assert tstate._ax_gen["transformer"]["k"] == 1  # [L, B, ...]


def _fill(tree, gen):
    """Random values in every tensor leaf of a state, in place."""
    if isinstance(tree, dict):
        for v in tree.values():
            _fill(v, gen)
    elif isinstance(tree, list):
        for v in tree:
            _fill(v, gen)
    elif isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bool:
            tree.copy_(torch.rand(tree.shape, generator=gen) < 0.5)
        elif tree.is_floating_point():
            tree.copy_(torch.randn(tree.shape, generator=gen))
        else:
            tree.copy_(torch.randint(-7, 8, tree.shape, generator=gen))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("which", ["lm_gen", "mimi_encode"])
def test_masked_reset_when_batch_equals_layers(which):
    """At B == num_layers a shape rule takes the layer axis of [L, B, ...]
    for the batch axis (moshi_tpu/utils/trees.py:10-17); the structural axes
    reset slot 1 and nothing else, in place."""
    cfg = _config()
    if which == "lm_gen":
        gen = TGen(TLM(port_lm_config(cfg)))
        init = lambda b, d: gen.init_state(b, None, torch.float32, d)  # noqa: E731
        n_layers = cfg.num_layers
    else:
        mimi = TMimi(port_mimi_config(tiny_mimi_config()))
        init = lambda b, d: mimi.init_encode_state(b, torch.float32, d)  # noqa: E731
        n_layers = mimi.config.transformer.num_layers
    nb = n_layers
    state = init(nb, None)
    _fill(state, torch.Generator().manual_seed(0))
    before = [t.clone() for t in _leaves(state)]
    axes = state_batch_axes(init)
    fresh = init(1, None)
    out = masked_reset(state, fresh, np.arange(nb) == 1, axes)
    assert out is state
    leaves_ax = [(t, a) for t, a in zip(_leaves(state), _leaves_axes(axes, state))]
    assert any(a == 1 and t.ndim > 2 for t, a in leaves_ax)  # a stacked [L, B, ...] leaf
    for (t, ax), old, f in zip(leaves_ax, before, _leaves(fresh)):
        for b in range(nb):
            got = t.select(ax, b)
            if b == 1:
                assert torch.equal(got, f.select(ax, 0).to(t.dtype))
            else:
                assert torch.equal(got, old.select(ax, b))


def _leaves_axes(axes, state):
    """The batch axis of each tensor leaf of `state`, in _leaves' order."""
    if isinstance(state, dict):
        return [x for k in state for x in _leaves_axes(axes[k], state[k])]
    if isinstance(state, list):
        return [x for a, s in zip(axes, state) for x in _leaves_axes(a, s)]
    return [axes] if isinstance(state, torch.Tensor) else []


def test_take_and_put_slots_round_trip():
    """A slot taken out of one state and put into another slot of a second
    state carries every leaf's values over, the generator untouched."""
    gen = TGen(TLM(port_lm_config(_config())))
    init = lambda b, d: gen.init_state(b, None, torch.float32, d)  # noqa: E731
    axes = state_batch_axes(init)
    a, b = init(3, None), init(3, None)
    _fill(a, torch.Generator().manual_seed(1))
    keys = ("cache", "offsets", "transformer")
    snap = take_slots({k: a[k] for k in keys}, [2], {k: axes[k] for k in keys})
    assert snap["transformer"]["k"].shape[1] == 1
    put_slots({k: b[k] for k in keys}, snap, [0], {k: axes[k] for k in keys})
    assert torch.equal(b["transformer"]["k"][:, 0], a["transformer"]["k"][:, 2])
    assert torch.equal(b["cache"][0], a["cache"][2])
    assert (b["transformer"]["k"][:, 1:] == 0).all()

