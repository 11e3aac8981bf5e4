"""The port's int4 KV cache against moshi_tpu's, in f32 on the CPU: the
quantized and packed bytes, StreamingTransformer.step over the packed cache
with a per-slot exec_mask schedule (outputs, offsets and every cache byte),
and the plain versions of the attention, of the cache write and of the
op that fuses them against the JAX package's dense fallback and its Pallas
kernels run in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from moshi_tpu.modules import transformer as jtr
from moshi_tpu.ops import int4_attention as jia
from moshi_tpu_torch.modules import transformer as ttr
from moshi_tpu_torch.ops import int4_attention as tia
from moshi_tpu_torch.utils.params import from_jax
from test_torch_port import max_abs, port_config, rel_err, to_np

# the bar of tests/test_exec_mask.py for the int4 path's outputs
TOL = 2e-4
# f32 on both sides, same bytes and scales: summation order only
TOL_PLAIN = 1e-5
# the Pallas kernel rounds q / sqrt(D) and p * v_scale to bf16
TOL_KERNEL = 2e-2

CFG = dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=256, context=8,
           positional_embedding="rope", gating="silu", norm="rms_norm_f32",
           kv_cache_dtype="int4")


def _build(kv_repeat):
    cfg = jtr.TransformerConfig(**CFG, kv_repeat=kv_repeat)
    jmodel = jtr.StreamingTransformer(cfg)
    params = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = ttr.StreamingTransformer(port_config(ttr.TransformerConfig, cfg))
    return cfg, jmodel, params, tmodel, from_jax(jax.device_get(params))


def _bytes_equal(t, a):
    """A torch tensor and a JAX array hold the same bytes."""
    a = np.asarray(a)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    return np.array_equal(t.numpy(), a)


def test_quant_and_pack_bytes_match_jax():
    """Values, f32 scales and packed bytes equal JAX's, ties included:
    torch.round rounds half to even, as jnp.round does."""
    rs = np.random.RandomState(0)
    x = rs.randn(3, 2, 4, 16).astype(np.float32)
    x[0, 0, 0, :6] = [7.0, 3.5, -3.5, 2.5, -0.5, 1.5]   # amax 7: scale 1, ties
    qj, sj = jtr._quant_rows_int4(jnp.asarray(x))
    qt, st = ttr._quant_rows_int4(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert list(qt[0, 0, 0, :6]) == [7, 4, -4, 2, 0, 2]
    flat = qt[:, 0].reshape(3, -1)
    pj = jtr._pack_nibble_cols(jnp.asarray(flat.numpy()))
    pt = ttr._pack_nibble_cols(flat)
    assert pt.dtype == torch.int8
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def _schedule(B, steps, seed):
    sched = np.random.RandomState(seed).rand(steps, B) > 0.35
    sched[0] = True
    return sched


@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_int4_step_matches_jax(kv_repeat):
    """12 masked steps at B = 3 (the context-8 ring wraps): outputs within
    2e-4, equal offsets, and the packed caches and scales byte for byte."""
    cfg, jmodel, params, tmodel, tparams = _build(kv_repeat)
    B, steps = 3, 12
    rs = np.random.RandomState(1)
    xs = (0.5 * rs.randn(steps, B, 1, cfg.d_model)).astype(np.float32)
    sched = _schedule(B, steps, 2)
    assert not sched.all()
    jstate = jmodel.init_state(B, jnp.float32)
    tstate = tmodel.init_state(B, torch.float32)
    assert tuple(tstate["k"].shape) == jstate["k"].shape == (2, B, 16 // kv_repeat * 2, 128)
    assert tstate["k_scale"].dtype == torch.bfloat16
    step = jax.jit(jmodel.step)
    for x, mask in zip(xs, sched):
        yj, jstate = step(params, jstate, jnp.asarray(x), exec_mask=jnp.asarray(mask))
        yt, tstate = tmodel.step(tparams, tstate, torch.from_numpy(x),
                                 exec_mask=torch.from_numpy(mask))
        assert max_abs(to_np(yt), yj) <= TOL
    np.testing.assert_array_equal(to_np(tstate["offset"]), np.asarray(jstate["offset"]))
    np.testing.assert_array_equal(to_np(tstate["offset"]), sched.sum(0))
    for name in ("k", "v", "k_scale", "v_scale"):
        assert _bytes_equal(tstate[name], jstate[name]), name


def test_int4_freeze_matches_per_item_runs():
    """A frozen slot's stream over the int4 cache equals the stream of the
    same slot stepped alone (tests/test_exec_mask.py's invariant)."""
    cfg, _, _, tmodel, tparams = _build(1)
    B, steps = 3, 10
    rs = np.random.RandomState(3)
    xs = (0.5 * rs.randn(B, steps, cfg.d_model)).astype(np.float32)
    sched = _schedule(B, steps, 4)
    state = tmodel.init_state(B, torch.float32)
    counts = np.zeros(B, int)
    got = [[] for _ in range(B)]
    for mask in sched:
        chunk = torch.from_numpy(np.stack([xs[b, counts[b]][None] for b in range(B)]))
        y, state = tmodel.step(tparams, state, chunk, exec_mask=torch.from_numpy(mask))
        for b in np.nonzero(mask)[0]:
            got[b].append(y[b, 0].numpy())
            counts[b] += 1
    for b in range(B):
        alone = tmodel.init_state(1, torch.float32)
        for i in range(counts[b]):
            y1, alone = tmodel.step(tparams, alone, torch.from_numpy(xs[b, i][None, None]))
            np.testing.assert_allclose(y1[0, 0].numpy(), got[b][i], rtol=TOL, atol=TOL)


def _jax_cache(kv_repeat, steps=11):
    """A JAX-built int4 cache after `steps` steps at B = 2 (the ring wrapped)
    and the attention mask of the next step."""
    cfg, jmodel, params, _, _ = _build(kv_repeat)
    B = 2
    state = jmodel.init_state(B, jnp.float32)
    rs = np.random.RandomState(5)
    step = jax.jit(jmodel.step)
    for _ in range(steps):
        _, state = step(params, state, jnp.asarray(rs.randn(B, 1, cfg.d_model), jnp.float32))
    offset = state["offset"]
    pos_k, _ = jtr.ring_positions(offset, 1, cfg.kv_capacity, None)
    delta = offset[:, None] - pos_k
    mask = (pos_k >= 0) & (delta >= 0) & (delta < cfg.context)
    mask &= jnp.arange(cfg.kv_capacity)[None] != (offset % cfg.kv_capacity)[:, None]
    return cfg, jmodel, state, mask


@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_plain_attention_matches_jax_dense_fallback(kv_repeat):
    """acc / l of the plain K4 on a JAX-built cache equals what the JAX
    package's dense fallback attends to (its current row switched off)."""
    cfg, jmodel, state, mask = _jax_cache(kv_repeat)
    B, H, D = 2, cfg.num_heads, cfg.head_dim
    rs = np.random.RandomState(6)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    kv = rs.randn(B, 1, cfg.num_kv_heads, D).astype(np.float32)
    for layer in range(cfg.num_layers):
        ictx = {"layer": layer, "k_all": state["k"], "v_all": state["v"],
                "ks_all": state["k_scale"], "vs_all": state["v_scale"], "mask": mask,
                "cur_valid": jnp.zeros((B,), bool), "cap": cfg.kv_capacity}
        ref = jmodel._int4_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), ictx)
        t = {k: from_jax(jax.device_get(state[k])) for k in ("k", "v", "k_scale", "v_scale")}
        acc, m, lse = tia.decode_attention_int4_stats(
            torch.from_numpy(q).transpose(1, 2).contiguous(), layer, t["k"], t["v"],
            t["k_scale"], t["v_scale"], torch.from_numpy(np.array(mask)))
        assert acc.shape == (B, H, D) and m.shape == lse.shape == (B, H, 1)
        got = (acc / lse).reshape(B, 1, H * D)
        assert max_abs(got.numpy(), ref) <= TOL_PLAIN


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run moshi_tpu's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                             interpret=True))


def _random_cache(rs, L, B, Hkv, D, cap_pad):
    vals = rs.randint(-7, 8, (2, L, B, Hkv * D, cap_pad)).astype(np.int8)
    packed = (vals[:, :, :, 1::2] << 4) | (vals[:, :, :, 0::2] & 15)
    scales = (0.01 + 0.2 * rs.rand(2, L, B, Hkv, cap_pad)).astype(np.float32)
    scales = np.asarray(jnp.asarray(scales, jnp.bfloat16))
    return [packed[0], packed[1], scales[0], scales[1]]


@pytest.mark.parametrize("D", [64, 128])
def test_plain_attention_matches_pallas_kernel(D, pallas_interpret):
    """The plain K4 against the TPU kernel itself (`_kernel` at D = 128,
    `_kernel_folded` at D = 64), layer 1 of 2, a ragged mask."""
    rs = np.random.RandomState(D)
    B, H, cap = 2, 4, 200
    cache = _random_cache(rs, 2, B, H, D, 256)
    q = rs.randn(B, H, 1, D).astype(np.float32)
    mask = rs.rand(B, cap) < 0.7
    jacc, jm, jl = jia.decode_attention_int4_stats(
        jnp.asarray(q), 1, *(jnp.asarray(c) for c in cache), jnp.asarray(mask))
    tcache = [torch.from_numpy(c) if c.dtype == np.int8 else
              torch.from_numpy(c.astype(np.float32)).to(torch.bfloat16) for c in cache]
    acc, m, lse = tia.decode_attention_int4_stats(torch.from_numpy(q), 1, *tcache,
                                                  torch.from_numpy(mask))
    assert rel_err((acc / lse).numpy(), np.asarray(jacc / jl)) <= TOL_KERNEL
    assert rel_err(m.numpy(), np.asarray(jm)) <= TOL_KERNEL


def test_plain_cache_write_matches_pallas_kernel(pallas_interpret):
    """cache_write_int4_plain, the reference of the fused write, writes the
    bytes of the TPU kernel, frozen slots too."""
    rs = np.random.RandomState(7)
    L, B, H, D, cap_pad = 2, 3, 4, 16, 256
    cache = _random_cache(rs, L, B, H, D, cap_pad)
    cols = [rs.randint(-128, 128, (L, B, H * D // 2)).astype(np.int8) for _ in range(2)]
    scols = [np.asarray(jnp.asarray(rs.randn(L, B, H), jnp.bfloat16)) for _ in range(2)]
    pos = np.array([0, 131, 255])
    ref = jia.cache_write_int4(jnp.asarray(pos, jnp.int32),
                               *(jnp.asarray(c) for c in cols + scols + cache))

    def tt(a):
        return (torch.from_numpy(a) if a.dtype == np.int8
                else torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
    got = tia.cache_write_int4_plain(torch.from_numpy(pos),
                                     *(tt(a) for a in cols + scols + cache))
    for g, r in zip(got, ref):
        assert _bytes_equal(g, r)


def _tt(a):
    """A copy of a numpy int8, bf16 or f32 array as a torch tensor of its
    dtype."""
    if a.dtype == np.int8 or a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _repeat_heads(cache, rep):
    """Caches of Hkv KV heads -> caches of Hkv * rep, each head repeated (a
    grouped-query cache as the Pallas kernel, which takes H = Hkv, sees it)."""
    k, v, ks, vs = cache
    L, B, hd2, cap_pad = k.shape
    Hkv = ks.shape[2]

    def rows(c):
        return np.repeat(c.reshape(L, B, Hkv, hd2 // Hkv, cap_pad), rep, axis=2).reshape(
            L, B, hd2 * rep, cap_pad)
    return [rows(k), rows(v), np.repeat(ks, rep, axis=2), np.repeat(vs, rep, axis=2)]


@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_fused_write_plain_matches_jax(kv_repeat, pallas_interpret):
    """decode_attention_int4_write's plain version against the JAX package
    at D = 128, layer 1 of 2: its stats against the Pallas kernel in
    interpret mode (TOL_KERNEL; at kv_repeat 2 on the caches with each KV
    head repeated) and against `_int4_attention`'s dense fallback
    (TOL_PLAIN); its caches byte for byte against `_int4_attention`'s
    columns written by the Pallas `cache_write_int4`: lanes 0, 100 and
    cap - 1, and a frozen slot's, of layer 1, every other byte unchanged."""
    rs = np.random.RandomState(10 + kv_repeat)
    L, B, H, D, cap, cap_pad, layer = 2, 4, 4, 128, 200, 256, 1
    Hkv = H // kv_repeat
    cache = _random_cache(rs, L, B, Hkv, D, cap_pad)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    kk, vv = (rs.randn(B, 1, Hkv, D).astype(np.float32) for _ in range(2))
    pos = np.array([0, 100, cap - 1, 37])
    mask = rs.rand(B, cap) < 0.7
    mask[np.arange(B), pos] = False              # the lane being written
    cfg = jtr.TransformerConfig(**dict(CFG, d_model=H * D, num_heads=H, num_layers=L,
                                       context=cap), kv_repeat=kv_repeat)
    ictx = {"layer": layer, "k_all": jnp.asarray(cache[0]), "v_all": jnp.asarray(cache[1]),
            "ks_all": jnp.asarray(cache[2]), "vs_all": jnp.asarray(cache[3]),
            "mask": jnp.asarray(mask), "cur_valid": jnp.zeros((B,), bool), "cap": cap}
    dense = jtr.StreamingTransformer(cfg)._int4_attention(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), ictx)
    qh = q.transpose(0, 2, 1, 3)
    jacc, jm, jl = jia.decode_attention_int4_stats(
        jnp.asarray(qh), layer, *(jnp.asarray(c) for c in _repeat_heads(cache, kv_repeat)),
        jnp.asarray(mask))
    # every layer's column: layer 1's from _int4_attention, the others the
    # bytes already at the lane, so the Pallas write changes layer 1 alone
    b = np.arange(B)
    cols = [np.asarray(c).copy() for c in (cache[0][:, b, :, pos], cache[1][:, b, :, pos],
                                           cache[2][:, b, :, pos], cache[3][:, b, :, pos])]
    cols = [c.transpose(1, 0, 2).copy() for c in cols]
    for c, new in zip(cols, ictx["cols"]):
        c[layer] = np.asarray(new)
    ref = jia.cache_write_int4(jnp.asarray(pos, jnp.int32),
                               *(jnp.asarray(c) for c in cols + cache))

    tcache = [_tt(c) for c in cache]
    acc, m, lse = tia.decode_attention_int4_write(
        torch.from_numpy(qh.copy()), torch.from_numpy(kk[:, 0].copy()),
        torch.from_numpy(vv[:, 0].copy()), torch.from_numpy(pos), layer, *tcache,
        torch.from_numpy(mask))
    assert max_abs((acc / lse).reshape(B, 1, H * D).numpy(), dense) <= TOL_PLAIN
    assert rel_err((acc / lse).numpy(), np.asarray(jacc / jl)) <= TOL_KERNEL
    assert rel_err(m.numpy(), np.asarray(jm)) <= TOL_KERNEL
    for got, want in zip(tcache, ref):
        assert _bytes_equal(got, want)
    assert not _bytes_equal(tcache[0], cache[0])  # the write did write


def test_fused_write_plain_skips_lanes_outside_the_cache():
    """A pos outside [0, cap_pad) writes nothing (as the kernel), and the
    stats are the attention-only op's."""
    rs = np.random.RandomState(12)
    L, B, H, D, cap = 2, 3, 4, 16, 100
    cache = [_tt(c) for c in _random_cache(rs, L, B, H, D, 128)]
    before = [c.clone() for c in cache]
    q = torch.from_numpy(rs.randn(B, H, 1, D).astype(np.float32))
    kk, vv = (torch.from_numpy(rs.randn(B, H, D).astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(rs.rand(B, cap) < 0.8)
    pos = torch.tensor([-1, 128, 5])
    got = tia.decode_attention_int4_write(q, kk, vv, pos, 0, *cache, mask)
    want = tia.decode_attention_int4_stats(q, 0, *before, mask)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    for c, c0 in zip(cache, before):
        assert torch.equal(c[:, :2], c0[:, :2])    # slots 0 and 1: nothing written
        assert torch.equal(c[1], c0[1])             # layer 1 untouched
    assert not torch.equal(cache[0][0, 2, :, 5], before[0][0, 2, :, 5])


def test_int4_prefill_runs_and_int8_qk_is_refused():
    """A T = 2 step over either quantized cache (the prefill path) from a
    fresh state gives JAX's outputs within TOL_PLAIN and its cache bytes
    (tests/test_torch_configs.py holds wrapped rings and frozen slots);
    the XLA-only int8 x int8 scores are refused."""
    cfg, jmodel, params, tmodel, tparams = _build(1)
    x = (0.5 * np.random.RandomState(13).randn(2, 2, 64)).astype(np.float32)
    for kv in ("int4", "int8"):
        jm = jtr.StreamingTransformer(jtr.TransformerConfig(**dict(CFG, kv_cache_dtype=kv)))
        tm = ttr.StreamingTransformer(ttr.TransformerConfig(**dict(CFG, kv_cache_dtype=kv)))
        yj, jstate = jm.step(params, jm.init_state(2, jnp.float32), jnp.asarray(x))
        yt, tstate = tm.step(tparams, tm.init_state(2, torch.float32), torch.from_numpy(x))
        assert max_abs(to_np(yt), yj) <= TOL_PLAIN, kv
        for name in ("k", "v", "k_scale", "v_scale", "offset"):
            assert _bytes_equal(tstate[name], jstate[name]), (kv, name)
    with pytest.raises(NotImplementedError, match="attention_int8_qk"):
        ttr.StreamingTransformer(ttr.TransformerConfig(
            **dict(CFG, kv_cache_dtype="int8"), attention_int8_qk=True))


def test_int4_wrappers_reject_bad_operands():
    rs = np.random.RandomState(8)
    k, v, ks, vs = (torch.from_numpy(c) if c.dtype == np.int8
                    else torch.from_numpy(c.astype(np.float32)).to(torch.bfloat16)
                    for c in _random_cache(rs, 2, 2, 4, 16, 128))
    q = torch.zeros(2, 4, 1, 16)
    mask = torch.ones(2, 100, dtype=torch.bool)
    with pytest.raises(ValueError):
        tia.decode_attention_int4_stats(q[:, :3], 0, k, v, ks, vs, mask)  # heads
    with pytest.raises(ValueError):
        tia.decode_attention_int4_stats(q, 0, k, v, ks, vs, mask[:, :0])  # no lanes
    with pytest.raises(TypeError):
        tia.decode_attention_int4_stats(q, 0, k, v, ks.float(), vs, mask)
    rows = torch.zeros(2, 4, 16)
    pos = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError):
        tia.decode_attention_int4_write(q, rows, rows, torch.zeros(3, dtype=torch.long), 0,
                                        k, v, ks, vs, mask)               # slots
    with pytest.raises(ValueError):
        tia.decode_attention_int4_write(q, rows[:, :3], rows, pos, 0, k, v, ks, vs,
                                        mask)                             # KV heads
    with pytest.raises(TypeError):
        tia.decode_attention_int4_write(q, rows, rows, pos.int(), 0, k, v, ks, vs, mask)
