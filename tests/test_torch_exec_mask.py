"""Per-slot exec masks in the port, the four cases of tests/test_exec_mask.py:
Mimi with desynchronized users, LMGen with desynchronized users, a per-slot
reset, and a frozen slot over the int4 KV cache.  Each case checks the
per-item invariant (a masked batched run equals each item run alone) and
that the port equals moshi_tpu on the same masked schedule: Mimi codes and
greedy tokens identical, float outputs within the stated tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.lm_gen import LMGen as JGen, LMGenConfig as JGenConfig
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.modules import resample as jresample
from moshi_tpu.utils.trees import masked_reset as jmasked_reset, state_batch_axes as jaxes
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.models.lm_gen import LMGen as TGen, LMGenConfig as TGenConfig
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.modules import resample as tresample
from moshi_tpu_torch.modules.conv import conv_from_jax, convtr_from_jax
from moshi_tpu_torch.utils.params import from_jax
from moshi_tpu_torch.utils.trees import masked_reset, state_batch_axes
from test_lm import tiny_lm_config
from test_mimi import tiny_mimi_config
from test_torch_port import max_abs, port_lm_config, port_mimi_config

PCM_TOL = 1e-4  # f32 Mimi decode, port vs JAX (tests/test_torch_mimi.py)


def _mimi():
    cfg = tiny_mimi_config()
    jm = JMimi(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tcfg = port_mimi_config(cfg)
    return jm, params, TMimi(tcfg), from_jax(jax.device_get(params), mimi_config=tcfg)


def _sched(B, n, seed):
    sched = np.random.RandomState(seed).rand(n, B) > 0.3
    sched[0] = True
    return sched


def test_mimi_exec_mask_desync():
    """Encode and decode with per-slot freezes: codes identical to JAX's and
    to each item encoded alone; decoded PCM within 1e-4 of JAX's and of each
    item decoded alone."""
    jm, params, tm, tparams = _mimi()
    B, n, fs = 3, 8, jm.frame_size
    rs = np.random.RandomState(0)
    sched = _sched(B, n, 1)
    pcm = (0.3 * rs.randn(B, 1, n * fs)).astype(np.float32)
    codes_in = rs.randint(0, 32, (B, n, jm.num_codebooks, 1))
    enc, dec = jax.jit(jm.encode_step), jax.jit(jm.decode_step)
    jenc, tenc = jm.init_encode_state(B), tm.init_encode_state(B)
    jdec, tdec = jm.init_decode_state(B), tm.init_decode_state(B)
    counts = np.zeros(B, int)
    codes, audio = [[] for _ in range(B)], [[] for _ in range(B)]
    for mask in sched:
        chunk = np.stack([pcm[b, :, counts[b] * fs:(counts[b] + 1) * fs] for b in range(B)])
        ctoks = np.stack([codes_in[b, counts[b]] for b in range(B)])
        cj, jenc = enc(params, jenc, jnp.asarray(chunk), jnp.asarray(mask))
        ct, _ = tm.encode_step(tparams, tenc, torch.from_numpy(chunk), torch.from_numpy(mask))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        aj, jdec = dec(params, jdec, jnp.asarray(ctoks), jnp.asarray(mask))
        at, _ = tm.decode_step(tparams, tdec, torch.from_numpy(ctoks), torch.from_numpy(mask))
        assert max_abs(at.numpy(), aj) <= PCM_TOL
        for b in np.nonzero(mask)[0]:
            codes[b].append(ct[b].numpy())
            audio[b].append(at[b].numpy())
            counts[b] += 1
    for b in range(B):
        es, ds = tm.init_encode_state(1), tm.init_decode_state(1)
        for f in range(counts[b]):
            c, _ = tm.encode_step(tparams, es, torch.from_numpy(pcm[b:b + 1, :, f * fs:(f + 1) * fs]))
            np.testing.assert_array_equal(c[0].numpy(), codes[b][f])
            a, _ = tm.decode_step(tparams, ds, torch.from_numpy(codes_in[b, f][None]))
            assert max_abs(a[0].numpy(), audio[b][f]) <= PCM_TOL


@pytest.mark.parametrize("learnt", [True, False])
@pytest.mark.parametrize("kind", ["downsample", "upsample"])
def test_resample_exec_mask(kind, learnt):
    """Resampling under a per-slot freeze schedule, on the learnt path and
    on the non-learnt one, which runs B*C single-channel rows with the mask
    repeated per channel: every output within 1e-5 of JAX's, and frozen
    slots resume where they stopped."""
    B, C, S = 3, 4, 2
    if kind == "downsample":
        jmod = jresample.ConvDownsample1d(S, C, learnt=learnt)
        tmod = tresample.ConvDownsample1d(S, C, learnt=learnt)
        T = 2 * S
    else:
        jmod = jresample.ConvTrUpsample1d(S, C, learnt=learnt, channel_wise=learnt)
        tmod = tresample.ConvTrUpsample1d(S, C, channel_wise=learnt, learnt=learnt)
        T = 1
    jp = jmod.init_params(jax.random.PRNGKey(0))
    w = torch.from_numpy(np.array(jp["weight"]))
    tp = {"weight": conv_from_jax(w) if kind == "downsample"
          else convtr_from_jax(w, tmod.convtr.groups)}
    x = np.random.RandomState(0).randn(10, B, T, C).astype(np.float32)
    sched = _sched(B, 10, 3)
    jstate, tstate = jmod.init_state(B), tmod.init_state(B)
    counts = np.zeros(B, int)
    outs = [[] for _ in range(B)]
    for mask in sched:
        xi = np.stack([x[counts[b], b] for b in range(B)])
        yj, jstate = jmod.step(jp, jstate, jnp.asarray(xi), jnp.asarray(mask))
        yt, _ = tmod.step(tp, tstate, torch.from_numpy(xi), torch.from_numpy(mask))
        assert max_abs(yt.numpy(), yj) <= 1e-5
        for b in np.nonzero(mask)[0]:
            outs[b].append(yt[b].numpy())
            counts[b] += 1
    for b in range(B):
        st = tmod.init_state(1)
        for f in range(counts[b]):
            y, _ = tmod.step(tp, st, torch.from_numpy(x[f, b:b + 1]))
            assert max_abs(y[0].numpy(), outs[b][f]) <= 1e-5


def test_lmgen_exec_mask_desync():
    """Greedy LMGen with per-slot freezes: tokens identical to JAX's on the
    same schedule (frozen slots output UNGENERATED_TOKEN in both) and to
    each item stepped alone."""
    cfg = tiny_lm_config()
    params = JLM(cfg).init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    jgen = JGen(JLM(cfg), JGenConfig(use_sampling=False))
    tgen = TGen(TLM(port_lm_config(cfg)), TGenConfig(use_sampling=False))
    tparams = from_jax(jax.device_get(params))
    B, n = 3, 12
    n_in = cfg.num_codebooks - cfg.dep_q - 1
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg.card, (B, n_in, n))
    sched = _sched(B, n, 2)
    jstate = jgen.init_state(B, jax.random.PRNGKey(1), dtype=jnp.float32)
    tstate = tgen.init_state(B, None, torch.float32)
    step = jax.jit(jgen.step)
    counts = np.zeros(B, int)
    outs = [[] for _ in range(B)]
    for mask in sched:
        it = np.stack([tokens[b, :, counts[b]:counts[b] + 1] for b in range(B)])
        oj, jstate = step(params, jstate, jnp.asarray(it, jnp.int32), jnp.asarray(mask))
        ot, _ = tgen.step(tparams, tstate, torch.from_numpy(it), torch.from_numpy(mask))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        for b in np.nonzero(mask)[0]:
            outs[b].append(ot[b].numpy())
            counts[b] += 1
    np.testing.assert_array_equal(tstate["offsets"].numpy(), counts)
    for b in range(B):
        st = tgen.init_state(1, None, torch.float32)
        ref = [tgen.step(tparams, st, torch.from_numpy(tokens[b:b + 1, :, s:s + 1]))[0][0].numpy()
               for s in range(counts[b])]
        np.testing.assert_array_equal(np.stack(outs[b]), np.stack(ref))


def test_per_slot_reset():
    """masked_reset of slot 1 restarts its stream exactly and leaves slot 0's
    untouched, as the JAX package's masked reset does."""
    jm, params, tm, tparams = _mimi()
    B, fs = 2, jm.frame_size
    pcm = (0.3 * np.random.RandomState(0).randn(B, 1, 6 * fs)).astype(np.float32)
    jstate, tstate = jm.init_encode_state(B), tm.init_encode_state(B)
    for f in range(3):
        chunk = pcm[:, :, f * fs:(f + 1) * fs]
        _, jstate = jm.encode_step(params, jstate, jnp.asarray(chunk))
        tm.encode_step(tparams, tstate, torch.from_numpy(chunk))
    jstate = jmasked_reset(jstate, jm.init_encode_state(B), jnp.asarray([False, True]),
                           jaxes(jm.init_encode_state))
    masked_reset(tstate, tm.init_encode_state(1), np.array([False, True]),
                 state_batch_axes(lambda b, d: tm.init_encode_state(b, device=d)))
    chunk = pcm[:, :, 3 * fs:4 * fs]
    cj, _ = jm.encode_step(params, jstate, jnp.asarray(chunk))
    ct, _ = tm.encode_step(tparams, tstate, torch.from_numpy(chunk))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    fresh, _ = tm.encode_step(tparams, tm.init_encode_state(1), torch.from_numpy(chunk[1:]))
    np.testing.assert_array_equal(ct[1].numpy(), fresh[0].numpy())
    st0 = tm.init_encode_state(1)
    for f in range(4):
        ref0, _ = tm.encode_step(tparams, st0, torch.from_numpy(pcm[:1, :, f * fs:(f + 1) * fs]))
    np.testing.assert_array_equal(ct[0].numpy(), ref0[0].numpy())


def test_int4_kv_lmgen_freeze():
    """Greedy LMGen over the int4 KV cache with per-slot freezes: tokens
    identical to JAX's and to each item stepped alone, and every int4 cache
    byte equal to JAX's after the run."""
    cfg = dataclasses.replace(tiny_lm_config(dim=64, num_heads=4, depformer_dim=32),
                              kv_cache_dtype="int4")
    params = JLM(cfg).init_params(jax.random.PRNGKey(3), dtype=jnp.float32)
    jgen = JGen(JLM(cfg), JGenConfig(use_sampling=False))
    tgen = TGen(TLM(port_lm_config(cfg)), TGenConfig(use_sampling=False))
    tparams = from_jax(jax.device_get(params))
    B, n = 3, 16
    n_in = cfg.num_codebooks - cfg.dep_q - 1
    tokens = np.random.RandomState(4).randint(0, cfg.card, (n, B, n_in, 1))
    sched = _sched(B, n, 5)
    jstate = jgen.init_state(B, jax.random.PRNGKey(1), dtype=jnp.float32)
    tstate = tgen.init_state(B, None, torch.float32)
    step = jax.jit(jgen.step)
    counts = np.zeros(B, int)
    outs = [[] for _ in range(B)]
    for mask in sched:
        it = np.stack([tokens[counts[b], b] for b in range(B)])
        oj, jstate = step(params, jstate, jnp.asarray(it, jnp.int32), jnp.asarray(mask))
        ot, _ = tgen.step(tparams, tstate, torch.from_numpy(it), torch.from_numpy(mask))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        for b in np.nonzero(mask)[0]:
            outs[b].append(ot[b].numpy())
            counts[b] += 1
    assert counts.max() > cfg.context  # the ring wrapped
    for b in range(B):
        st = tgen.init_state(1, None, torch.float32)
        ref = [tgen.step(tparams, st, torch.from_numpy(tokens[s, b:b + 1]))[0][0].numpy()
               for s in range(counts[b])]
        np.testing.assert_array_equal(np.stack(outs[b]), np.stack(ref))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tstate["transformer"][name].numpy(),
                                      np.asarray(jstate["transformer"][name]))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(
            tstate["transformer"][name].view(torch.int16).numpy(),
            np.asarray(jstate["transformer"][name]).view(np.int16))
