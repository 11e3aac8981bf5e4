"""The single-session server's fleet features in the port
(moshi_tpu_torch/serve/server.py), held against the JAX package's server
over scripts/make_tiny_checkpoint.py: session resume (4 frames, a drop,
then 3 resumed ones equal an unbroken 7-frame session, greedy and sampled;
the JAX server's greedy session logs, file for file; a resume survives an
intervening session; a wrong id gives a fresh session; the restore writes
the live buffers in place), the HTTP queue API over the session lock,
`--log-dir`, MT 8 image embeddings on the tiny vision config of
tests/test_server.py, and `--tp`'s refusal.  The tiny checkpoint's Mimi
decodes NaN for most samples (ROADMAP C.8): PCM is compared as bytes.
Tolerance: none (bytes and exact tokens), but the MT 8 cross K/V rows
against the JAX package's, within 1e-5 (f32 products on two backends)."""

import asyncio
import json
import struct
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import WSMsgType, web
from aiohttp.test_utils import TestClient, TestServer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import make_tiny_checkpoint  # noqa: E402
from moshi_tpu.models.lm import LMModel as JLM  # noqa: E402
from moshi_tpu.models.loaders import CheckpointInfo as JInfo  # noqa: E402
from moshi_tpu.models.mimi import MimiModel as JMimi  # noqa: E402
from moshi_tpu.serve.server import QueueAPI as JQueueAPI  # noqa: E402
from moshi_tpu.serve.server import ServerState as JServerState  # noqa: E402
from moshi_tpu_torch.models.lm import LMModel as TLM  # noqa: E402
from moshi_tpu_torch.models.loaders import CheckpointInfo  # noqa: E402
from moshi_tpu_torch.models.mimi import MimiModel as TMimi  # noqa: E402
from moshi_tpu_torch.serve import protocol as proto  # noqa: E402
from moshi_tpu_torch.serve import server as tserver  # noqa: E402
from moshi_tpu_torch.serve.server import QueueAPI, ServerState  # noqa: E402
from moshi_tpu_torch.text.spm import SentencePieceTokenizer  # noqa: E402
from moshi_tpu_torch.utils.params import from_jax  # noqa: E402
from moshi_tpu_torch.utils.safetensors import load_file  # noqa: E402
from test_lm import tiny_lm_config  # noqa: E402
from test_mimi import tiny_mimi_config  # noqa: E402
from test_torch_port import port_lm_config, port_mimi_config  # noqa: E402

RECV_TIMEOUT = 60
CROSS_TOL = 1e-5
KINDS = {"greedy": {"use_sampling": False}, "sampled": {}}  # the checkpoint's config samples


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny models run faster without torch's
    pool beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_checkpoint.make(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def models(ckpt):
    info = CheckpointInfo.from_dir(ckpt)
    return info, info.get_mimi(device="cpu"), info.get_moshi(device="cpu")


def port_state(models, **kw) -> ServerState:
    info, (mimi, mimi_params), (lm, lm_params) = models
    state = ServerState(mimi, mimi_params, lm, lm_params, info=info,
                        text_tokenizer=SentencePieceTokenizer(info.tokenizer_path),
                        device="cpu", **{**info.lm_gen_config, **kw})
    state.warmup()
    return state


RAW_PCM = proto.msg(proto.MT_METADATA, b'{"raw_pcm": true}')


async def start_session(client, query: str):
    ws = await client.ws_connect("/api/chat" + query)
    assert (await ws.receive_bytes(timeout=RECV_TIMEOUT))[:1] == b"\x00"
    meta = json.loads((await ws.receive_bytes(timeout=RECV_TIMEOUT))[1:])
    await ws.send_bytes(RAW_PCM)
    assert json.loads((await ws.receive_bytes(timeout=RECV_TIMEOUT))[1:])["raw_pcm"] is True
    return ws, meta


async def drive(ws, frames, out):
    """Each frame and a ping; every reply but the pings, in order."""
    for f in frames:
        await ws.send_bytes(proto.msg(proto.MT_PCM, f.tobytes()))
        await ws.send_bytes(proto.msg(proto.MT_PING))
        while True:
            m = await ws.receive(timeout=RECV_TIMEOUT)
            assert m.type == WSMsgType.BINARY
            if m.data[0] == proto.MT_PING:
                break
            out.append(m.data)


async def closed(ws, state):
    await ws.close()
    for _ in range(100):  # the session's end: snapshot and log written
        if not state.lock.locked() and (state._push_task is None or state._push_task.done()):
            break
        await asyncio.sleep(0.02)


def with_client(state, fn):
    async def run():
        app = web.Application()
        app.router.add_get("/api/chat", state.handle_chat)
        async with TestClient(TestServer(app)) as client:
            return await fn(client)
    return asyncio.run(run())


def frames(n, size, seed=0):
    return (0.3 * np.random.RandomState(seed).randn(n, size)).astype(np.float32)


def split_sessions(state, logs: Path, pcm, query=""):
    """An unbroken session of all of `pcm`, then one of its first 5 frames
    (the skipped one and 4), dropped, a session of another seed between,
    and the first resumed for the rest; each session's log in its own
    directory (the JAX server names a log by the second it was written).
    Returns (unbroken replies, split replies, the two echoes of the
    split)."""
    def log_to(name):
        state.log_dir = str(logs / name)

    async def run(client):
        log_to("unbroken")
        ws, _ = await start_session(client, f"?resume_support=1{query}")
        full = []
        await drive(ws, pcm, full)
        await closed(ws, state)
        log_to("first")
        ws, meta = await start_session(client, f"?resume_support=1{query}")
        split = []
        await drive(ws, pcm[:5], split)
        await closed(ws, state)
        log_to("between")
        ws, _ = await start_session(client, "?text_seed=77")
        await drive(ws, pcm[::-1][:4], [])
        await closed(ws, state)
        log_to("resumed")
        ws, meta2 = await start_session(client, f"?resume={meta['resume_id']}")
        await drive(ws, pcm[5:], split)
        await closed(ws, state)
        return full, split, (meta, meta2)
    return with_client(state, run)


def read_log(d: Path) -> dict:
    files = list(d.glob("session-*.safetensors"))
    assert len(files) == 1, files
    return load_file(files[0])


@pytest.mark.parametrize("kind", KINDS)
def test_resume_equals_the_unbroken_session(models, kind, tmp_path):
    """4 + (resume, after another session) 3 frames give the unbroken 7's
    replies byte for byte and the same tokens: the restore brings back the
    generator's state too; the resumed echo says so; a wrong id starts a
    fresh session."""
    state = port_state(models, **KINDS[kind])
    pcm = frames(8, state.frame_size)
    query = "&text_seed=4" if kind == "sampled" else ""
    full, split, (meta, meta2) = split_sessions(state, tmp_path, pcm, query)
    assert meta["resumed"] is False and meta["resume_id"]
    assert meta2["resumed"] is True and meta2["resume_id"] != meta["resume_id"]
    assert meta2["seed"] == meta["seed"]
    assert split == full and sum(m[0] == proto.MT_PCM for m in full) >= 3
    unbroken = read_log(tmp_path / "unbroken")
    for key in ("text_tokens", "audio_tokens"):
        parts = [read_log(tmp_path / d)[key] for d in ("first", "resumed")]
        assert torch.equal(torch.cat(parts, dim=-1), unbroken[key])

    async def wrong(client):
        ws, m = await start_session(client, "?resume=deadbeef")
        await closed(ws, state)
        return m
    assert with_client(state, wrong)["resumed"] is False


def test_resume_and_logs_match_jax(ckpt, models, tmp_path):
    """The same greedy split session through the JAX server: the same
    replies but the PCM (whose floats the packages round apart), and the
    session logs' keys, dtypes and values equal, file for file."""
    info = JInfo.from_dir(ckpt)
    (mimi, mimi_params), (lm, lm_params) = info.get_mimi(), info.get_moshi()
    from moshi_tpu.text.spm import SentencePieceTokenizer as JTokenizer
    jstate = JServerState(info, mimi, mimi_params, lm, lm_params,
                          JTokenizer(info.tokenizer_path), use_sampling=False)
    jstate.warmup()
    tstate = port_state(models, use_sampling=False)
    pcm = frames(8, tstate.frame_size, seed=1)
    got = {}
    for name, state in (("port", tstate), ("jax", jstate)):
        full, split, _ = split_sessions(state, tmp_path / name, pcm)
        got[name] = [m for m in split if m[0] != proto.MT_PCM]
        assert split == full
    assert got["port"] == got["jax"]
    for d in ("unbroken", "first", "resumed"):
        t, j = read_log(tmp_path / "port" / d), read_log(tmp_path / "jax" / d)
        assert set(t) == set(j) == {"text_tokens", "audio_tokens"}
        for k in t:
            assert t[k].dtype == j[k].dtype == torch.int32
            assert torch.equal(t[k], j[k])


def test_resume_survives_an_intervening_session(models):
    """The store keeps several snapshots: A's resume works after B ran and
    left one too, and B's after A's."""
    state = port_state(models)
    pcm = frames(4, state.frame_size)

    async def session(client, query, n):
        ws, meta = await start_session(client, query)
        await drive(ws, pcm[:n], [])
        await closed(ws, state)
        return meta

    async def run(client):
        a = await session(client, "?resume_support=1", 4)
        b = await session(client, "?resume_support=1", 2)
        a2 = await session(client, f"?resume={a['resume_id']}", 2)
        b2 = await session(client, f"?resume={b['resume_id']}", 0)
        return a, b, a2, b2

    a, b, a2, b2 = with_client(state, run)
    assert b["resumed"] is False and a2["resumed"] is True and b2["resumed"] is True


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_restore_writes_the_live_buffers_in_place(models):
    """A resume (here from a snapshot of another override set) writes the
    snapshot into the tensors the steps were captured with; the generator
    is the server's, its state the snapshot's."""
    state = port_state(models)
    pcm = frames(6, state.frame_size)
    buffers = {id(t): t.data_ptr() for t in _leaves(
        [state.enc_state, state.dec_state, state.gen_state])}

    async def run(client):
        ws, meta = await start_session(client, "?resume_support=1&text_temperature=0.5")
        await drive(ws, pcm, [])
        await closed(ws, state)
        rng = state._snapshots[meta["resume_id"]][0]["rng"]
        gen_buffers = {id(t): t.data_ptr() for t in _leaves(state.gen_state)}
        ws, meta2 = await start_session(client, f"?resume={meta['resume_id']}")
        assert meta2["text_temperature"] == 0.5
        live = _leaves([state.enc_state, state.dec_state, state.gen_state])
        assert torch.equal(state.generator.get_state(), rng)
        await closed(ws, state)
        return gen_buffers, live

    gen_buffers, live = with_client(state, run)
    for t in live:
        assert gen_buffers.get(id(t), buffers.get(id(t))) == t.data_ptr()
    assert state.generator is state.gen_state["generator"]


def test_queue_api_matches_jax(ckpt, models):
    """The HTTP queue over the session lock answers as the JAX server's
    does (auth ids aside): tickets FIFO, ready with the address while the
    lock is free, wait while it is held, 404 for a wrong ticket, 400 for a
    bad id, feedback acked."""
    state = port_state(models)

    class Locked:  # the JAX QueueAPI reads only the state's lock
        lock = asyncio.Lock()

    async def run(api_cls, st):
        app = web.Application()
        api_cls(st, "ws://test/api/chat").add_routes(app)
        out = []
        async with TestClient(TestServer(app)) as client:
            async def check(t, auth=None):
                r = await client.get("/check_user", params={
                    "session_id": str(t["session_id"]),
                    "session_auth_id": auth or t["session_auth_id"]})
                if r.status != 200:
                    return r.status, await r.text()
                c = await r.json()
                assert c["worker_auth_id"] in (None, t["session_auth_id"])
                return {**c, "worker_auth_id": c["worker_auth_id"] is not None}

            t1 = await (await client.get("/add_user", params={"queue_id": "q"})).json()
            t2 = await (await client.get("/add_user", params={"queue_id": "q"})).json()
            assert set(t1) == {"session_id", "session_auth_id"}
            out += [await check(t2), await check(t1)]
            await st.lock.acquire()
            out.append(await check(t2))
            st.lock.release()
            out += [await check(t2), await check(t1, "nope")]
            r = await client.get("/check_user", params={"session_id": "x"})
            out.append((r.status, await r.text()))
            out.append(await (await client.get("/user_feedback", params={"f": "1"})).json())
        return out

    port = asyncio.run(run(QueueAPI, state))
    jax_ = asyncio.run(run(JQueueAPI, Locked()))
    assert port == jax_
    assert port[0]["status"] == "wait" and port[0]["current_position"] == "1"
    assert port[1]["status"] == "ready" and port[1]["worker_addr"] == "ws://test/api/chat"
    assert port[2]["status"] == "wait" and port[3]["status"] == "ready"
    assert port[4][0] == 404 and port[5][0] == 400


@pytest.fixture(scope="module")
def vision():
    """The tiny vision config of tests/test_server.py in both packages, on
    the same weights."""
    cfg = tiny_lm_config(cross_attention=True,
                         cross_attention_gating="conditional_gated_sigmoid")
    jlm = JLM(cfg)
    lm_params = jlm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    mcfg = tiny_mimi_config()
    jmimi = JMimi(mcfg)
    mimi_params = jmimi.init_params(jax.random.PRNGKey(1))
    jstate = JServerState(JInfo({"model_type": "moshi"}), jmimi, mimi_params, jlm, lm_params,
                          None, use_sampling=False)
    tmcfg = port_mimi_config(mcfg)
    tstate = ServerState(TMimi(tmcfg), from_jax(jax.device_get(mimi_params), mimi_config=tmcfg),
                         TLM(port_lm_config(cfg)), from_jax(jax.device_get(lm_params)),
                         device="cpu", use_sampling=False)
    tstate.warmup()
    return jstate, tstate, cfg


def image(t, dim, seed):
    emb = np.random.RandomState(seed).randn(t, dim).astype(np.float32)
    return emb, proto.msg(proto.MT_IMAGE, struct.pack("<II", t, dim) + emb.tobytes())


def test_image_embeddings_mt8_match_jax(vision):
    """MT 8 answers {"image": "ok", "frames": T} as the JAX server does; the
    cross K/V rows equal the JAX server's; a second image of the same T is
    written into the same tensors, one of another T into new ones; frames
    keep flowing; a bad image gets MT 5; a new session starts without
    one."""
    jstate, tstate, cfg = vision
    jstate.warmup()
    emb, msg = image(3, cfg.dim, 0)
    pcm = frames(6, tstate.frame_size, seed=2)

    async def run(client):
        ws, _ = await start_session(client, "?text_seed=1")
        out = []
        await ws.send_bytes(msg)
        out.append(await ws.receive_bytes(timeout=RECV_TIMEOUT))
        tr = tstate.gen_state["transformer"]
        rows = {k: tr[k].clone() for k in ("k_cross", "v_cross")}
        first = tr["k_cross"]
        await drive(ws, pcm, out)
        await ws.send_bytes(image(3, cfg.dim, 1)[1])
        out.append(await ws.receive_bytes(timeout=RECV_TIMEOUT))
        same = tr["k_cross"] is first
        await ws.send_bytes(image(5, cfg.dim, 1)[1])
        out.append(await ws.receive_bytes(timeout=RECV_TIMEOUT))
        other = tr["k_cross"] is not first and tr["k_cross"].shape[-3] == 5
        await ws.send_bytes(proto.msg(proto.MT_IMAGE, b"\x01"))
        out.append(await ws.receive_bytes(timeout=RECV_TIMEOUT))
        await closed(ws, tstate)
        ws, _ = await start_session(client, "?text_seed=1")
        fresh = "k_cross" not in tstate.gen_state["transformer"]
        await closed(ws, tstate)
        return out, rows, same, other and fresh

    out, rows, same, other = with_client(tstate, run)
    ack = proto.msg(proto.MT_METADATA, json.dumps({"image": "ok", "frames": 3}).encode())
    assert out[0] == ack and same and other
    assert out[-3] == ack and out[-2][0] == proto.MT_METADATA and out[-1][0] == proto.MT_ERROR
    assert sum(m[0] == proto.MT_PCM for m in out) == len(pcm) - 1 - tstate.lm.config.max_delay

    jstate.set_image_embeddings(emb)
    jtr = jstate.gen_state["transformer"]
    for k, v in rows.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jtr[k]), atol=CROSS_TOL, rtol=0)


def test_tp_is_refused():
    with pytest.raises(NotImplementedError, match="A.13"):
        tserver.main(["--checkpoint-dir", "/nonexistent", "--tp", "2", "--device", "cpu"])
