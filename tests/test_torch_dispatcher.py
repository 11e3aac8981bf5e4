"""The port's fleet dispatcher (moshi_tpu_torch/serve/dispatcher.py) held
against the JAX package's: the cases of tests/test_dispatcher.py run through
both packages' classes and HTTP routes, and their JSON answers compared
(values equal, the random auth ids aside); the snapshot vault's auth,
one-shot take, TTL and size cap over both packages' routes; the port's
`main` as a subprocess in front of a fake worker, vault included.
Tolerance: none, every answer is compared exactly."""

import asyncio
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
from aiohttp import ClientSession, web
from aiohttp.test_utils import TestClient, TestServer

from moshi_tpu.serve import dispatcher as jdisp
from moshi_tpu_torch.serve import dispatcher as tdisp

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jdisp, "port": tdisp}


def each(fn):
    """fn(module) for each package; asserts the records are equal and
    returns the port's."""
    got = {name: fn(mod) for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def no_auth(d):
    """An answer with its random auth ids replaced by their presence."""
    if d is None:
        return None
    return {k: (v is not None and len(v) == 32 if k.endswith("auth_id") else v)
            for k, v in d.items()}


def test_metrics_url():
    def run(mod):
        with pytest.raises(ValueError):
            mod.metrics_url("http://h/")
        return [mod.metrics_url("ws://h:8998/api/chat"), mod.metrics_url("wss://h/api/chat")]
    assert each(run) == ["http://h:8998/metrics", "https://h/metrics"]


def test_fifo_and_capacity():
    def run(mod):
        w = mod.Worker("ws://a:1/api/chat", capacity=1, lease_ttl=0.2)
        d = mod.Dispatcher([w])
        t1, t2 = d.add_user(), d.add_user()
        out = [no_auth(t1), no_auth(t2)]
        check = lambda t, auth=None: no_auth(  # noqa: E731
            d.check_user(t["session_id"], auth or t["session_auth_id"]))
        out.append(check(t2))          # FIFO: t2 waits behind t1
        c1 = d.check_user(t1["session_id"], t1["session_auth_id"])
        assert c1["worker_auth_id"] == t1["session_auth_id"]
        out.append(no_auth(c1))
        out.append(check(t2))          # at the head, the worker full (lease)
        time.sleep(0.25)               # the lease expires
        out.append(check(t2))
        out += [d.check_user(999, "x"), check(t1, "wrong")]
        return out

    out = each(run)
    assert out[2]["status"] == "wait" and out[2]["current_position"] == "1"
    assert out[3]["status"] == "ready" and out[3]["worker_addr"] == "ws://a:1/api/chat"
    assert out[4]["status"] == "wait" and out[4]["current_position"] == "0"
    assert out[5]["status"] == "ready" and out[6:] == [None, None]


def test_least_loaded_and_polled_counts():
    def run(mod):
        w1, w2 = mod.Worker("ws://a:1/api/chat", capacity=4), mod.Worker("ws://b:1/api/chat", 4)
        w1.open, w2.open = 2, 0
        d = mod.Dispatcher([w1, w2])
        t = d.add_user()
        out = [no_auth(d.check_user(t["session_id"], t["session_auth_id"]))]
        w1.open = w2.open = 4          # polled counts at capacity
        t = d.add_user()
        out.append(no_auth(d.check_user(t["session_id"], t["session_auth_id"])))
        w1.open = w2.open = 0
        w1.reachable = False           # unreachable workers are skipped
        out.append(no_auth(d.check_user(t["session_id"], t["session_auth_id"])))
        out.append(d.stats())
        return out

    out = each(run)
    assert out[0]["worker_addr"] == "ws://b:1/api/chat" and out[1]["status"] == "wait"
    assert out[2]["worker_addr"] == "ws://b:1/api/chat"


async def until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "the poll loop never saw the expected metrics"
        await asyncio.sleep(0.02)


def fake_worker(text):
    async def metrics(_):
        return web.Response(text=text())
    app = web.Application()
    app.router.add_get("/metrics", metrics)
    return app


def test_http_with_live_metrics():
    """Fake workers expose /metrics; each package's poll loop feeds their
    load into its routes' assignments."""
    async def run(mod):
        opens = {"a": 1, "b": 0}
        wa = TestServer(fake_worker(lambda: f"open_channels {opens['a']}\n"))
        wb = TestServer(fake_worker(lambda: f"open_channels {opens['b']}\n"))
        await wa.start_server()
        await wb.start_server()
        workers = [mod.Worker(f"ws://127.0.0.1:{wa.port}/api/chat", capacity=2),
                   mod.Worker(f"ws://127.0.0.1:{wb.port}/api/chat", capacity=2)]
        app = web.Application()
        mod.add_routes(app, mod.Dispatcher(workers))
        client = TestClient(TestServer(app))
        await client.start_server()
        poll = asyncio.create_task(mod.poll_workers(workers, interval=0.05))
        out = []
        try:
            await until(lambda: workers[0].open == 1 and workers[1].open == 0)
            for _ in range(2):
                t = await (await client.get("/add_user", params={"queue_id": "q"})).json()
                c = await (await client.get("/check_user", params={
                    "session_id": str(t["session_id"]),
                    "session_auth_id": t["session_auth_id"]})).json()
                out.append([no_auth(t), {**no_auth(c), "worker_addr": c["worker_addr"] and
                                         workers.index(next(w for w in workers
                                                            if w.addr == c["worker_addr"]))}])
                opens["a"] = opens["b"] = 2
                await until(lambda: workers[0].open == 2 and workers[1].open == 2)
            stats = await (await client.get("/stats")).json()
            out.append([{**w, "addr": i, "load": w["load"]} for i, w in
                        enumerate(stats["workers"])] + [stats["queued"]])
            r = await client.get("/check_user", params={"session_id": "x"})
            out.append([r.status, await r.text()])
            r = await client.get("/check_user", params={"session_id": "7",
                                                        "session_auth_id": "nope"})
            out.append([r.status, await r.text()])
            r = await client.get("/user_feedback", params={"feedback": "1"})
            out.append(await r.json())
        finally:
            poll.cancel()
            await client.close()
            await wa.close()
            await wb.close()
        return out

    out = each(lambda mod: asyncio.run(run(mod)))
    assert out[0][1]["status"] == "ready" and out[0][1]["worker_addr"] == 1
    assert out[1][1]["status"] == "wait" and out[2][-1] == 1
    assert out[3][0] == 400 and out[4][0] == 404 and out[5] == {"ok": True}


def test_skips_draining_worker():
    async def run(mod):
        srv = TestServer(fake_worker(lambda: "open_channels 1\ndraining 1\n"))
        await srv.start_server()
        w = mod.Worker(f"ws://127.0.0.1:{srv.port}/api/chat", capacity=8)
        task = asyncio.create_task(mod.poll_workers([w], interval=0.05))
        try:
            await until(lambda: w.open == 1)
            await asyncio.sleep(0.1)
            return [w.open, w.reachable, w.has_room()]
        finally:
            task.cancel()
            await srv.close()

    assert each(lambda mod: asyncio.run(run(mod))) == [1, False, False]


def test_vault_auth_and_one_shot():
    """Both packages' vault routes give the same statuses and bodies: a push
    with the fleet token, refusals without it, a one-shot pull, an empty
    push refused; entries expire after the TTL and the oldest go first
    past `cap_bytes`."""
    async def run(mod):
        vault = mod.SnapshotVault(ttl=120.0)
        app = web.Application()
        mod.add_vault_routes(app, vault, "sekrit")
        out = []
        async with TestClient(TestServer(app)) as client:
            hdr = {"X-Fleet-Auth": "sekrit"}
            for method, path, kw in (
                    ("post", "/snapshot/abc", {"data": b"blob-bytes", "headers": hdr}),
                    ("post", "/snapshot/x", {"data": b"y", "headers": {"X-Fleet-Auth": "no"}}),
                    ("get", "/snapshot/abc", {}),
                    ("get", "/snapshot/abc", {"headers": hdr}),
                    ("get", "/snapshot/abc", {"headers": hdr}),
                    ("post", "/snapshot/e", {"data": b"", "headers": hdr})):
                r = await getattr(client, method)(path, **kw)
                out.append([r.status, await r.read()])
        return out

    out = each(lambda mod: asyncio.run(run(mod)))
    assert [s for s, _ in out] == [200, 403, 403, 200, 404, 400]
    assert out[3][1] == b"blob-bytes"

    def expiry(mod):
        v = mod.SnapshotVault(ttl=120.0, cap_bytes=10)
        v.put("old", b"x")
        v._items["old"] = (0.0, b"x")  # expired
        v.put("a", b"12345")
        v.put("b", b"123456")          # 11 bytes > 10: "a" goes
        return [v.take("old"), v.take("a"), v.take("b"), len(v)]
    assert each(expiry) == [None, None, b"123456", 0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dispatcher_main_fronts_a_worker_with_a_vault():
    """`python -m moshi_tpu_torch.serve.dispatcher` (as a fleet runs it):
    --help, then a live dispatcher in front of a fake worker's /metrics,
    handing out its address and keeping a snapshot in its vault."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    helped = subprocess.run([sys.executable, "-m", "moshi_tpu_torch.serve.dispatcher",
                             "--help"], cwd=ROOT, env=env, capture_output=True, text=True,
                            timeout=60)
    assert helped.returncode == 0 and "--fleet-auth" in helped.stdout

    async def run():
        worker = TestServer(fake_worker(lambda: "open_channels 0\n"))
        await worker.start_server()
        addr = f"ws://127.0.0.1:{worker.port}/api/chat"
        port = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "moshi_tpu_torch.serve.dispatcher", "--host", "127.0.0.1",
             "--port", str(port), "--worker", f"{addr}=1", "--poll", "0.1",
             "--fleet-auth", "s3"], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        base = f"http://127.0.0.1:{port}"
        try:
            async with ClientSession() as http:
                deadline = time.monotonic() + 60
                while True:
                    try:
                        stats = await (await http.get(f"{base}/stats")).json()
                        if stats["workers"][0]["open"] == 0:
                            break
                    except OSError:
                        pass
                    assert time.monotonic() < deadline and proc.poll() is None
                    await asyncio.sleep(0.1)
                t = await (await http.get(f"{base}/add_user")).json()
                c = await (await http.get(f"{base}/check_user", params={
                    "session_id": str(t["session_id"]),
                    "session_auth_id": t["session_auth_id"]})).json()
                hdr = {"X-Fleet-Auth": "s3"}
                pushed = await (await http.post(f"{base}/snapshot/r", data=b"abc",
                                                headers=hdr)).json()
                pulled = await (await http.get(f"{base}/snapshot/r", headers=hdr)).read()
        finally:
            proc.kill()
            proc.wait()
            await worker.close()
        return c, pushed, pulled

    c, pushed, pulled = asyncio.run(run())
    assert c["status"] == "ready" and c["worker_addr"].endswith("/api/chat")
    assert pushed == {"ok": True, "bytes": 3} and pulled == b"abc"
