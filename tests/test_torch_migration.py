"""Cross-worker session migration in the port: the snapshot wire format and
the vault client (`serve/snapshots.py` `vault_push` / `vault_pull`) against
both packages' vaults, and a session migrated through the port's
dispatcher and its vault: worker A replicates every frame, dies without a
disconnect snapshot, the client re-queues, is handed worker B, resumes
there, and A's frames and B's equal an unbroken session's, PCM bytes and
token logs, greedy and sampled (tests/test_migration.py's end-to-end test
on the port's servers over scripts/make_tiny_checkpoint.py).  The tiny
checkpoint's Mimi decodes NaN for most samples (ROADMAP C.8), so PCM is
compared as bytes.  Tolerance: none, bytes throughout."""

import asyncio
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp import WSMsgType, web
from aiohttp.test_utils import TestClient, TestServer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import make_tiny_checkpoint  # noqa: E402
from moshi_tpu.serve import dispatcher as jdisp  # noqa: E402
from moshi_tpu_torch.models.loaders import CheckpointInfo  # noqa: E402
from moshi_tpu_torch.serve import dispatcher as tdisp  # noqa: E402
from moshi_tpu_torch.serve import protocol as proto  # noqa: E402
from moshi_tpu_torch.serve.server import ServerState  # noqa: E402
from moshi_tpu_torch.serve.snapshots import (deserialize_snapshot, serialize_snapshot,  # noqa: E402
                                             snapshot_chunks, vault_pull, vault_push)
from moshi_tpu_torch.utils.quantize import QTensor  # noqa: E402
from moshi_tpu_torch.utils.safetensors import load_file  # noqa: E402

AUTH = "fleet-secret"
RECV_TIMEOUT = 60


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


def test_snapshot_wire_roundtrip():
    """serialize / deserialize keep the tree and its values, QTensor and
    bf16 leaves included; the streamed chunks join to the same blob."""
    arrays = {"kv": QTensor(torch.arange(16, dtype=torch.int8).reshape(4, 4),
                            torch.linspace(0.1, 0.4, 4)),
              "conv": {"tail": torch.full((2, 3), 0.5, dtype=torch.bfloat16)},
              "pos": torch.tensor([7], dtype=torch.int32), "rng": torch.arange(16).byte()}
    meta = {"steps": 42, "max_steps": 4500, "overrides": {"temp": 0.65}, "seed": 3}
    blob = serialize_snapshot(arrays, meta)
    chunks, nbytes = snapshot_chunks(arrays, meta)
    assert b"".join(chunks) == blob and nbytes == len(blob)
    back, meta2 = deserialize_snapshot(blob)
    assert meta2 == meta
    assert torch.equal(back["kv"].q, arrays["kv"].q)
    assert torch.equal(back["kv"].scale, arrays["kv"].scale)
    assert back["conv"]["tail"].dtype == torch.bfloat16
    assert torch.equal(back["conv"]["tail"], arrays["conv"]["tail"])
    assert torch.equal(back["pos"], arrays["pos"]) and torch.equal(back["rng"], arrays["rng"])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_vault_client_against_the_vaults(package):
    """The port's thread-side vault client against each package's vault
    routes: the streamed push arrives whole, the pull is one-shot, a wrong
    token is refused."""
    mod = {"jax": jdisp, "port": tdisp}[package]
    arrays = {"k": torch.randn(3, 5, dtype=torch.float32), "b": torch.ones(4, dtype=torch.bfloat16)}
    meta = {"steps": 5, "max_steps": 9, "overrides": {}}

    async def run():
        vault = mod.SnapshotVault()
        app = web.Application(client_max_size=1 << 20)
        mod.add_vault_routes(app, vault, AUTH)
        async with TestClient(TestServer(app)) as client:
            url = f"http://127.0.0.1:{client.server.port}"
            nbytes = await asyncio.to_thread(vault_push, url, "r1", AUTH, arrays, meta)
            stored = vault._items["r1"][1]
            got = await asyncio.to_thread(vault_pull, url, "r1", AUTH)
            again = await asyncio.to_thread(vault_pull, url, "r1", AUTH)
            with pytest.raises(RuntimeError, match="403"):
                await asyncio.to_thread(vault_push, url, "r2", "wrong", arrays, meta)
        return nbytes, stored, got, again

    nbytes, stored, got, again = asyncio.run(run())
    assert stored == serialize_snapshot(arrays, meta) and nbytes == len(stored)
    assert again is None and got[1] == meta
    assert all(torch.equal(got[0][k], arrays[k]) for k in arrays)


KINDS = {"greedy": {"use_sampling": False}, "sampled": {}}  # the checkpoint's config samples


async def negotiate(ws) -> dict:
    """Handshake, the config echo, raw PCM; returns the echo."""
    assert (await ws.receive_bytes(timeout=RECV_TIMEOUT))[:1] == b"\x00"
    cfg = json.loads((await ws.receive_bytes(timeout=RECV_TIMEOUT))[1:])
    await ws.send_bytes(proto.msg(proto.MT_METADATA, b'{"raw_pcm": true}'))
    while True:
        m = await ws.receive_bytes(timeout=RECV_TIMEOUT)
        if m[0] == proto.MT_METADATA and json.loads(m[1:]).get("raw_pcm"):
            return cfg


async def feed(ws, chunk, collect):
    """One frame and a ping; the PCM replies up to the ping."""
    await ws.send_bytes(proto.msg(proto.MT_PCM, chunk.tobytes()))
    await ws.send_bytes(proto.msg(proto.MT_PING))
    while True:
        m = await ws.receive(timeout=RECV_TIMEOUT)
        assert m.type == WSMsgType.BINARY
        if m.data[0] == proto.MT_PING:
            return
        if m.data[0] == proto.MT_PCM:
            collect.append(m.data[1:])


def token_log(log_dir: Path) -> np.ndarray:
    """The [T, 1 + dep_q] tokens of every session log in `log_dir`, in the
    order they were written."""
    rows = []
    for f in sorted(log_dir.glob("*.safetensors"), key=lambda p: p.stat().st_mtime_ns):
        t = load_file(f)
        rows.append(np.concatenate([t["text_tokens"].numpy()[:, None],
                                    t["audio_tokens"].numpy().T], axis=1))
    return np.concatenate(rows)


@pytest.mark.parametrize("kind", KINDS)
def test_cross_worker_migration_bit_exact(ckpt, kind, tmp_path):
    """Worker A replicates every frame to the dispatcher's vault; A dies
    mid-session (the vault has only the live pushes); the client re-queues,
    is handed B, resumes there with its resume id, and A's PCM and tokens
    followed by B's equal an unbroken session's."""
    info = CheckpointInfo.from_dir(ckpt)
    mimi, mimi_params = info.get_mimi(device="cpu")
    lm, lm_params = info.get_moshi(device="cpu")

    def make_state(name):
        state = ServerState(mimi, mimi_params, lm, lm_params, info=info, device="cpu",
                            fleet_auth=AUTH, replicate_every=1, log_dir=str(tmp_path / name),
                            **{**info.lm_gen_config, **KINDS[kind]})
        state.warmup()
        return state

    state_a, state_b, state_ref = (make_state(n) for n in ("a", "b", "ref"))
    n1, n2 = 5, 4  # frames before and after the kill, after the skipped one
    rs = np.random.RandomState(0)
    chunks = [(rs.randn(state_a.frame_size) * 0.3).astype(np.float32)
              for _ in range(1 + n1 + n2)]

    async def serve(state):
        app = web.Application()
        app.router.add_get("/api/chat", state.handle_chat)
        client = TestClient(TestServer(app))
        await client.start_server()
        return client, f"ws://127.0.0.1:{client.server.port}/api/chat"

    async def run():
        client_a, addr_a = await serve(state_a)
        client_b, addr_b = await serve(state_b)
        client_r, _ = await serve(state_ref)
        workers = [tdisp.Worker(addr_a, 1), tdisp.Worker(addr_b, 1)]
        vault = tdisp.SnapshotVault()
        disp_app = web.Application(client_max_size=1 << 30)
        tdisp.add_routes(disp_app, tdisp.Dispatcher(workers))
        tdisp.add_vault_routes(disp_app, vault, AUTH)
        disp = TestClient(TestServer(disp_app))
        await disp.start_server()
        state_a.vault_url = state_b.vault_url = f"http://127.0.0.1:{disp.server.port}"

        async def ticket():
            t = await (await disp.get("/add_user")).json()
            return await (await disp.get("/check_user", params={
                "session_id": str(t["session_id"]),
                "session_auth_id": t["session_auth_id"]})).json()

        try:
            ws = await client_r.ws_connect("/api/chat?resume_support=1")
            await negotiate(ws)
            ref = []
            for c in chunks:
                await feed(ws, c, ref)
            await ws.close()

            r = await ticket()
            assert r["status"] == "ready" and r["worker_addr"] == addr_a
            ws = await client_a.ws_connect("/api/chat?resume_support=1")
            rid = (await negotiate(ws))["resume_id"]
            got_a = []
            for c in chunks[:1 + n1]:
                await feed(ws, c, got_a)
                # the frame's push lands before the next frame (the test's
                # pacing; a server skips a push while the last one runs)
                if state_a._push_task is not None:
                    await state_a._push_task
            assert len(vault) == 1 and [p["steps"] for p in state_a.pushes] == list(
                range(1, n1 + 1))

            # A dies: nothing it does from here reaches the vault
            state_a.vault_url = None
            await client_a.close()
            workers[0].reachable = False
            r = await ticket()
            assert r["status"] == "ready" and r["worker_addr"] == addr_b
            ws = await client_b.ws_connect(f"/api/chat?resume_support=1&resume={rid}")
            echo = await negotiate(ws)
            assert echo["resumed"] is True and len(vault) == 0
            got_b = []
            for c in chunks[1 + n1:]:
                await feed(ws, c, got_b)
            await ws.close()
            await asyncio.sleep(0.1)  # the session's end writes its log
            return ref, got_a, got_b
        finally:
            await client_b.close()
            await client_r.close()
            await disp.close()

    ref, got_a, got_b = asyncio.run(run())
    skip = lm.config.max_delay
    assert len(got_a) == n1 - skip and len(got_b) == n2
    assert got_a + got_b == ref
    ref_tokens = token_log(tmp_path / "ref")
    assert len(ref_tokens) == n1 + n2 - skip
    np.testing.assert_array_equal(np.concatenate([token_log(tmp_path / "a"),
                                                  token_log(tmp_path / "b")]), ref_tokens)
