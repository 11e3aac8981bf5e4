"""The port's int8 KV cache against moshi_tpu's, on the CPU: the quantized
bytes and scales, StreamingTransformer.step over the int8 ring with a
per-slot exec_mask schedule (outputs, offsets and every cache byte), and
the plain version of the decode kernel against the JAX package's Pallas
kernel run in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.modules import transformer as jtr
from moshi_tpu.ops import decode_attention as jda
from moshi_tpu_torch.modules import transformer as ttr
from moshi_tpu_torch.ops import decode_attention as tda
from moshi_tpu_torch.utils.params import from_jax
from test_torch_int4_kv import _bytes_equal, _schedule, pallas_interpret  # noqa: F401
from test_torch_port import max_abs, port_config, rel_err, to_np

# f32 on both sides, the same int8 rows and bf16 scales: the JAX package
# puts the scales on scores and weights, the port on the dequantized rows,
# so outputs differ by summation order only
TOL = 2e-5
# the Pallas kernel rounds p * v_scale and its output to bf16
TOL_KERNEL = 2e-2

CFG = dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=256, context=8,
           positional_embedding="rope", gating="silu", norm="rms_norm_f32",
           kv_cache_dtype="int8")


def _build(kv_repeat):
    cfg = jtr.TransformerConfig(**CFG, kv_repeat=kv_repeat)
    jmodel = jtr.StreamingTransformer(cfg)
    params = jmodel.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = ttr.StreamingTransformer(port_config(ttr.TransformerConfig, cfg))
    return cfg, jmodel, params, tmodel, from_jax(jax.device_get(params))


def test_quant_rows_bytes_match_jax():
    """Values and f32 scales equal JAX's, ties included (half to even), and
    the bf16 scales stored in the cache too."""
    rs = np.random.RandomState(0)
    x = rs.randn(3, 2, 4, 16).astype(np.float32)
    x[0, 0, 0, :6] = [127.0, 2.5, -2.5, 3.5, -0.5, 1.5]   # amax 127: scale 1, ties
    qj, sj = jtr._quant_rows(jnp.asarray(x))
    qt, st = ttr._quant_rows(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert list(qt[0, 0, 0, :6]) == [127, 2, -2, 4, 0, 2]
    assert _bytes_equal(st.to(torch.bfloat16), sj.astype(jnp.bfloat16))


@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_int8_step_matches_jax(kv_repeat):
    """12 masked steps at B = 3 (the context-8 ring wraps): outputs within
    2e-5 on executing slots, equal offsets, and the int8 caches and bf16
    scales byte for byte."""
    cfg, jmodel, params, tmodel, tparams = _build(kv_repeat)
    B, steps = 3, 12
    rs = np.random.RandomState(1)
    xs = (0.5 * rs.randn(steps, B, 1, cfg.d_model)).astype(np.float32)
    sched = _schedule(B, steps, 2)
    assert not sched.all()
    jstate = jmodel.init_state(B, jnp.float32)
    tstate = tmodel.init_state(B, torch.float32)
    Hkv = 4 // kv_repeat
    assert tuple(tstate["k"].shape) == jstate["k"].shape == (2, B, 8, Hkv, 16)
    assert tuple(tstate["k_scale"].shape) == jstate["k_scale"].shape == (2, B, 8, Hkv, 1)
    assert tstate["k"].dtype == torch.int8 and tstate["k_scale"].dtype == torch.bfloat16
    step = jax.jit(jmodel.step)
    for x, mask in zip(xs, sched):
        yj, jstate = step(params, jstate, jnp.asarray(x), exec_mask=jnp.asarray(mask))
        yt, tstate = tmodel.step(tparams, tstate, torch.from_numpy(x),
                                 exec_mask=torch.from_numpy(mask))
        if mask.any():
            assert max_abs(to_np(yt)[mask], np.asarray(yj)[mask]) <= TOL
    np.testing.assert_array_equal(to_np(tstate["offset"]), np.asarray(jstate["offset"]))
    np.testing.assert_array_equal(to_np(tstate["offset"]), sched.sum(0))
    for name in ("k", "v", "k_scale", "v_scale"):
        assert _bytes_equal(tstate[name], jstate[name]), name


def test_int8_freeze_matches_per_item_runs():
    """A frozen slot's stream over the int8 cache equals the stream of the
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


def test_frozen_first_frame_gives_zero_attention():
    """A slot frozen before its first executed frame has no position to
    attend: the port gives 0 there (the TPU kernel's max(l, 1e-20)), never
    NaN, and its offset stays."""
    _, _, _, tmodel, tparams = _build(1)
    state = tmodel.init_state(2, torch.float32)
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 1, 64).astype(np.float32))
    y, state = tmodel.step(tparams, state, x, exec_mask=torch.tensor([True, False]))
    assert torch.isfinite(y).all()
    assert state["offset"].tolist() == [1, 0]


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _to_torch(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
        if a.dtype.name == "bfloat16" else torch.from_numpy(a)


@pytest.mark.parametrize("D", [64, 128])
def test_plain_attention_matches_pallas_kernel(D, pallas_interpret):
    """The plain K6 against the TPU kernel itself at B = 2, H = 4, S = 512,
    block_s = 256, laid out as one layer of the ring with Hkv = H: a ragged
    mask on slot 0, every position masked on slot 1 (exactly 0 in both)."""
    rs = np.random.RandomState(D)
    B, H, S = 2, 4, 512
    q = _bf16(rs.randn(B, H, D))
    k, v = (rs.randint(-127, 128, (B, H, S, D)).astype(np.int8) for _ in range(2))
    ks, vs = (_bf16(0.001 + 0.02 * rs.rand(B, H, S, 1)) for _ in range(2))
    mask = rs.rand(B, S) < 0.7
    mask[1] = False
    ref = jda.decode_attention_int8(*(jnp.asarray(a) for a in (q, k, ks, v, vs)),
                                    jnp.asarray(mask[:, :, None]), block_s=256)

    def ring(a):  # [B, H, S, X] -> [1, B, S, H, X]
        return _to_torch(np.ascontiguousarray(a.transpose(0, 2, 1, 3))[None])
    got = tda.decode_attention_int8(_to_torch(q), 0, ring(k), ring(v), ring(ks), ring(vs),
                                    torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    ref = np.asarray(ref.astype(jnp.float32))
    assert rel_err(to_np(got[0]), ref[0]) <= TOL_KERNEL
    assert (to_np(got[1]) == 0).all() and (ref[1] == 0).all()


def test_plain_attention_grouped_heads_and_layer():
    """Query head h reads KV head h // (H // Hkv) of layer `layer`: the plain
    version equals attention over the dequantized rows taken by hand."""
    rs = np.random.RandomState(11)
    L, B, S, Hkv, H, D = 3, 2, 40, 2, 4, 64
    k, v = (torch.from_numpy(rs.randint(-127, 128, (L, B, S, Hkv, D)).astype(np.int8))
            for _ in range(2))
    ks, vs = (torch.from_numpy(0.01 + 0.1 * rs.rand(L, B, S, Hkv, 1).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rs.randn(B, H, D).astype(np.float32))
    mask = torch.from_numpy(rs.rand(B, S) < 0.6)
    got = tda.decode_attention_int8(q, 1, k, v, ks, vs, mask)
    for b in range(B):
        for h in range(H):
            g = h // 2
            kf = k[1, b, :, g].float() * ks[1, b, :, g].float()
            vf = v[1, b, :, g].float() * vs[1, b, :, g].float()
            s = (kf @ q[b, h]) / D ** 0.5
            w = torch.softmax(s.masked_fill(~mask[b], float("-inf")), dim=0)
            torch.testing.assert_close(got[b, h], w @ vf, rtol=1e-5, atol=1e-5)


def test_int8_wrapper_rejects_bad_operands():
    L, B, S, H, D = 2, 2, 16, 4, 64
    k = torch.zeros(L, B, S, H, D, dtype=torch.int8)
    ks = torch.ones(L, B, S, H, 1, dtype=torch.bfloat16)
    q = torch.zeros(B, H, D)
    mask = torch.ones(B, S, dtype=torch.bool)
    with pytest.raises(ValueError):
        tda.decode_attention_int8(q[:, :3], 0, k, k, ks, ks, mask)     # heads
    with pytest.raises(ValueError):
        tda.decode_attention_int8(q, 0, k, k, ks, ks, mask[:, :8])     # positions
    with pytest.raises(ValueError):
        tda.decode_attention_int8(q, 0, k, k, ks[..., 0], ks, mask)    # scale rank
    with pytest.raises(TypeError):
        tda.decode_attention_int8(q, 0, k, k, ks.float(), ks, mask)
    with pytest.raises(TypeError):
        tda.decode_attention_int8(q, 0, k.float(), k, ks, ks, mask)


def _split_case(cap, mask_kind, D=64, seed=21):
    """One layer of int8 caches at B = 3, H = 4, Hkv = 2, f32 q, and a mask:
    "ragged" (random, slot 1 fully masked) or "first100" (only positions
    0..99 of each slot, as on a ring filled from 0: every later split holds
    no masked-in position)."""
    rs = np.random.RandomState(seed)
    B, H, Hkv = 3, 4, 2
    k, v = (torch.from_numpy(rs.randint(-127, 128, (1, B, cap, Hkv, D)).astype(np.int8))
            for _ in range(2))
    ks, vs = (torch.from_numpy(0.001 + 0.02 * rs.rand(1, B, cap, Hkv, 1).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rs.randn(B, H, D).astype(np.float32))
    if mask_kind == "ragged":
        mask = rs.rand(B, cap) < 0.6
        mask[1] = False
    else:
        mask = np.zeros((B, cap), bool)
        mask[:, :100] = True
    return q, k, v, ks, vs, torch.from_numpy(mask)


@pytest.mark.parametrize("mask_kind", ["ragged", "first100"])
@pytest.mark.parametrize("splits", [1, 2, 7, "plan"])
def test_split_plain_matches_unsplit(splits, mask_kind):
    """The plain version cut into `splits` ranges (the kernel's partition),
    each a partial (m, l, acc) merged in split order, equals the one-pass
    softmax within f32 rounding (2e-6 of the largest output); a slot or a
    split with no position masked in gives 0, never NaN."""
    cap = 3000
    case = _split_case(cap, mask_kind)
    if splits == "plan":
        splits = tda.plan_splits(3, 4, 64, cap, 132)[0]  # the H100's 132 SMs
        assert splits > 1
    ref = tda.decode_attention_int8_plain(*case[:1], 0, *case[1:], splits=1)
    got = tda.decode_attention_int8_plain(*case[:1], 0, *case[1:], splits=splits)
    assert torch.isfinite(got).all()
    assert max_abs(to_np(got), to_np(ref)) <= 2e-6 * np.abs(to_np(ref)).max()
    if mask_kind == "ragged":
        assert (got[1] == 0).all()


def test_split_plain_matches_pallas_kernel(pallas_interpret):
    """At 3 splits the plain version against the TPU kernel itself
    (interpret mode, block_s = 256, one layer of the ring with Hkv = H):
    slot 0 attends positions 0..99 only, so its later splits are empty;
    slot 1 attends nothing (exactly 0 in both)."""
    rs = np.random.RandomState(5)
    B, H, S, D = 2, 4, 768, 128
    q = _bf16(rs.randn(B, H, D))
    k, v = (rs.randint(-127, 128, (B, H, S, D)).astype(np.int8) for _ in range(2))
    ks, vs = (_bf16(0.001 + 0.02 * rs.rand(B, H, S, 1)) for _ in range(2))
    mask = np.zeros((B, S), bool)
    mask[0, :100] = True
    ref = jda.decode_attention_int8(*(jnp.asarray(a) for a in (q, k, ks, v, vs)),
                                    jnp.asarray(mask[:, :, None]), block_s=256)

    def ring(a):  # [B, H, S, X] -> [1, B, S, H, X]
        return _to_torch(np.ascontiguousarray(a.transpose(0, 2, 1, 3))[None])
    got = tda.decode_attention_int8_plain(_to_torch(q), 0, ring(k), ring(v), ring(ks),
                                          ring(vs), torch.from_numpy(mask), splits=3)
    assert tda.split_length(S, 3) == 256
    ref = np.asarray(ref.astype(jnp.float32))
    assert rel_err(to_np(got[0]), ref[0]) <= TOL_KERNEL
    assert (to_np(got[1]) == 0).all() and (ref[1] == 0).all()
