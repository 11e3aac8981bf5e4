"""The port's session-resume store (serve/snapshots.py) mirroring the JAX
package's tests of its own (TTL, cap, reserve and fill, the one-shot take,
the move to host memory, the wait for a pending release); snapshot bytes
read by the other package both ways; and the port's MessagePack codec
(serve/msgpack_codec.py) byte-equal to the `msgpack` package on every
message of the speech-to-text protocol, with a round trip of generated
objects."""

import asyncio

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from moshi_tpu.serve import snapshots as jsnap
from moshi_tpu_torch.serve import snapshots as tsnap
from moshi_tpu_torch.serve.msgpack_codec import packb, unpackb
from moshi_tpu_torch.serve.snapshots import SnapshotStore, new_resume_id, wants_resume
from moshi_tpu_torch.utils.quantize import QTensor


def run(coro):
    return asyncio.run(coro)


def test_helpers():
    assert len(new_resume_id()) == 16 and new_resume_id() != new_resume_id()
    assert wants_resume({"resume": "x"})
    assert wants_resume({"resume_support": "1"})
    assert not wants_resume({"text_temperature": "0.7"})


def test_put_take_roundtrip_and_one_shot():
    """put under a running loop moves card tensors to the host on a worker
    thread; take waits for it and is one-shot."""
    async def go():
        st_ = SnapshotStore(ttl=30.0, cap=2)
        st_.put("r1", {"a": torch.arange(4)}, {"k": 1})
        arrays, meta = await st_.take("r1")
        assert torch.equal(arrays["a"], torch.arange(4)) and arrays["a"].device.type == "cpu"
        assert meta["k"] == 1
        assert await st_.take("r1") is None
        assert await st_.take(None) is None
        assert await st_.take("unknown") is None
    run(go())


def test_put_without_a_loop_and_pop():
    """Without a running loop (the scripted servers) put moves the tensors
    at once, and pop is the synchronous one-shot take."""
    st_ = SnapshotStore(ttl=30.0, cap=2)
    st_.put("r1", ({"a": torch.ones(2)}, [torch.zeros(1)]), {"m": 2})
    assert "r1" in st_ and st_["r1"][1] == {"m": 2}
    arrays, meta = st_.pop("r1")
    assert torch.equal(arrays[0]["a"], torch.ones(2)) and meta == {"m": 2}
    assert st_.pop("r1") is None and "r1" not in st_


def test_reserve_makes_fast_reconnects_wait_for_fill():
    async def go():
        st_ = SnapshotStore(ttl=30.0, cap=2)
        st_.reserve("r1")
        assert "r1" not in st_ and len(st_) == 1

        async def fill_later():
            await asyncio.sleep(0.15)
            st_.put("r1", {"a": torch.ones(2)}, {"m": True})

        task = asyncio.create_task(fill_later())
        got = await st_.take("r1", fill_timeout=5.0)
        await task
        assert got is not None and got[1]["m"] is True
        st_.reserve("r2")
        assert await st_.take("r2", fill_timeout=0.2) is None
        assert len(st_) == 0
    run(go())


def test_take_survives_cap_eviction_of_awaited_reservation():
    async def go():
        st_ = SnapshotStore(ttl=30.0, cap=2)
        st_.reserve("victim")

        async def churn_then_fill():
            await asyncio.sleep(0.05)
            st_.put("x1", {"x": torch.zeros(1)})  # cap 2: evicts "victim"
            st_.put("x2", {"x": torch.zeros(1)})
            st_.put("victim", {"a": torch.ones(3)}, {"late": True})

        task = asyncio.create_task(churn_then_fill())
        got = await st_.take("victim", fill_timeout=0.5)
        await task
        assert got is not None and got[1]["late"] is True
        assert torch.equal(got[0]["a"], torch.ones(3))
    run(go())


@pytest.mark.parametrize("registry", ["dict", "rid_registry"])
def test_await_pending_release(registry):
    """An acquire that races ahead of the dropped session's release waits
    (bounded) for the id to leave its slot, by polling a dict or on a
    RidRegistry's event."""
    async def go():
        owned = {} if registry == "dict" else tsnap.RidRegistry()
        owned[3] = "rid-a"

        async def release_later():
            await asyncio.sleep(0.05)
            owned.pop(3)

        task = asyncio.create_task(release_later())
        await tsnap.await_pending_release(owned, "rid-a", timeout=1.0)
        assert 3 not in owned
        await task
        await tsnap.await_pending_release(owned, "unknown")
        await tsnap.await_pending_release(owned, None)
        owned[4] = "rid-b"
        await asyncio.wait_for(tsnap.await_pending_release(owned, "rid-b", timeout=0.1), 2.0)
    run(go())


def test_ttl_and_cap():
    async def go():
        st_ = SnapshotStore(ttl=0.1, cap=2)
        st_.put("a", {"x": torch.zeros(1)})
        await asyncio.sleep(0.15)
        assert await st_.take("a") is None
        st_ = SnapshotStore(ttl=30.0, cap=2)
        for rid in ("a", "b", "c"):
            st_.put(rid, {"x": torch.zeros(1)})
        assert len(st_) == 2
        assert await st_.take("a") is None
        assert await st_.take("c") is not None
        disabled = SnapshotStore(ttl=0.0)
        disabled.put("a", {"x": torch.zeros(1)})
        disabled.reserve("b")
        assert len(disabled) == 0
    run(go())


def _tree(rs):
    """A snapshot-shaped tree: bf16, f32, int8, int64, bool, uint8 leaves,
    a QTensor, a list and a tuple."""
    return {"kv": {"k": rs.randn(2, 3, 4).astype(ml_dtypes.bfloat16),
                   "scale": rs.randn(2, 3).astype(np.float32),
                   "q": rs.randint(-128, 127, (2, 5)).astype(np.int8)},
            "offset": np.arange(3, dtype=np.int64), "mask": rs.rand(4) > 0.5,
            "codes": rs.randint(0, 255, (3,)).astype(np.uint8),
            "layers": [rs.randn(2).astype(np.float32), rs.randn(1).astype(ml_dtypes.bfloat16)]}


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_torch_tree(v) for v in t]
    if t.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(t.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(t))


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_numpy_tree(v) for v in t]
    if isinstance(t, QTensor):
        return {"q": _numpy_tree(t.q), "scale": _numpy_tree(t.scale)}
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    if hasattr(t, "q") and hasattr(t, "scale"):
        return {"q": _numpy_tree(t.q), "scale": _numpy_tree(t.scale)}
    return np.asarray(t)


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


def test_snapshot_bytes_load_in_both_packages():
    """The port's serialize_snapshot bytes load in the JAX package's
    deserialize_snapshot to equal arrays (bf16 included) and meta, and the
    JAX package's bytes in the port's; a QTensor leaf survives both ways."""
    rs = np.random.RandomState(0)
    tree, meta = _tree(rs), {"msgs": [{"type": "Word", "text": "w3"}], "step": 7}
    jtree = {**tree, "w": jsnap_qtensor(rs)}
    got, got_meta = jsnap.deserialize_snapshot(tsnap.serialize_snapshot(
        {**_torch_tree(tree), "w": QTensor(*_torch_qtensor(jtree["w"]))}, meta))
    assert got_meta == meta
    _assert_same(_numpy_tree(got), _numpy_tree(jtree))
    back, back_meta = tsnap.deserialize_snapshot(jsnap.serialize_snapshot(jtree, meta))
    assert back_meta == meta and isinstance(back["w"], QTensor)
    _assert_same(_numpy_tree(back), _numpy_tree(jtree))


def jsnap_qtensor(rs):
    from moshi_tpu.utils.quantize import QTensor as JQTensor
    return JQTensor(jnp.asarray(rs.randint(-128, 127, (8, 4)).astype(np.int8)),
                    jnp.asarray(rs.rand(4).astype(np.float32)))


def _torch_qtensor(q):
    return torch.from_numpy(np.asarray(q.q).copy()), torch.from_numpy(np.asarray(q.scale).copy())


# ---------------------------------------------------------------- msgpack
PROTOCOL_MESSAGES = [
    {"type": "Init"}, {"type": "Ready"}, {"type": "Ready", "resume_id": "0f" * 8,
                                          "resumed": False},
    {"type": "Marker", "id": 5}, {"type": "Marker", "id": -300},
    {"type": "Marker", "id": 2 ** 40}, {"type": "Audio", "pcm": [0.0, -0.5, 1e-8, 3.25]},
    {"type": "Audio", "pcm": [float(x) for x in np.linspace(-1, 1, 1920)]},
    {"type": "OggOpus", "data": b"OggS" + bytes(range(256)) * 300},
    {"type": "Word", "text": "héllo wörld", "start_time": 1.28},
    {"type": "Word", "text": "x" * 40, "start_time": 0.0},
    {"type": "EndWord", "stop_time": 2.56},
    {"type": "Step", "step_idx": 70000, "prs": [0.125, 0.875], "buffered_pcm": 1920},
    {"type": "Error", "message": "server full"}, {"type": "Error", "message": "é" * 70000},
    {"k": None, "t": True, "f": False, "neg": [-1, -32, -33, -129, -40000, -2 ** 40],
     "big": [127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63], "nested": {"a": [[], {}]},
     "tuple": (1, 2)},
]


@pytest.mark.parametrize("msg", PROTOCOL_MESSAGES, ids=lambda m: str(m.get("type", "mixed")))
def test_msgpack_matches_the_package(msg):
    """packb is byte-equal to msgpack.packb(use_single_float=True), and each
    side unpacks the other's bytes to the same object."""
    want = msgpack.packb(msg, use_single_float=True)
    assert packb(msg) == want
    assert unpackb(want) == msgpack.unpackb(want)
    double = msgpack.packb(msg)  # floats as float64
    assert unpackb(double) == msgpack.unpackb(double)


def test_msgpack_refuses_malformed_bytes():
    good = packb({"type": "Audio", "pcm": [1.0, 2.0]})
    for bad in (good[:-3], good + b"\x00", b"\xc1", b"\xd4\x00\x00", b"\x81\x01\x02"):
        with pytest.raises(ValueError):
            unpackb(bad)


objects = st.recursive(
    st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
    | st.floats(allow_nan=False, width=32) | st.text(max_size=40) | st.binary(max_size=300),
    lambda children: st.lists(children, max_size=20)
    | st.dictionaries(st.text(max_size=10), children, max_size=8),
    max_leaves=40)


@settings(max_examples=150, deadline=None)
@given(objects)
def test_msgpack_round_trip(obj):
    """Generated objects: the package's bytes, and a round trip through the
    port's codec that gives the object back."""
    data = packb(obj)
    assert data == msgpack.packb(obj, use_single_float=True)
    assert unpackb(data) == obj
