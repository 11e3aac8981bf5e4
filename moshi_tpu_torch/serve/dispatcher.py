"""Multi-worker session dispatcher, the fleet front: a copy of
moshi_tpu/serve/dispatcher.py (which imports no JAX), its workers the
port's servers; the vault reads a snapshot into one buffer of its
Content-Length (`read_body`), the answers are the JAX module's.

The reference web client queues through a hosted service
(client/src/pages/Queue/api/client.ts polls add_user/check_user on
kyutai's closed infra; the repo ships only the client half).  This module
is that service: one dispatcher fronts N moshi_tpu_torch workers (single-session
servers, batched servers, or worker.py deployments) and hands queued
clients a `worker_addr` via the same HTTP API with validator-exact
response shapes (`serve/server.py:QueueAPI` is the single-server variant).

Load tracking: each worker's live `open_channels` gauge is polled from its
/metrics endpoint (derived from the ws address) every `--poll` seconds;
sessions the dispatcher just handed out are counted as short-lived
"leases" until the polled gauge absorbs them (or they expire).  Workers
whose /metrics is unreachable fall back to lease-only accounting; workers
that fail to answer at all are skipped.

Usage:
    python -m moshi_tpu_torch.serve.dispatcher --port 8090 \\
        --worker ws://host1:8998/api/chat=16 \\
        --worker ws://host2:8998/api/chat=16

Each --worker is ADDR=CAPACITY (capacity = the worker's --batch-size, or
1 for a single-session server).
"""

import argparse
import asyncio
import re
import time


def log(level: str, msg: str):
    print(f"[{level}] {msg}", flush=True)


def metrics_url(ws_addr: str) -> str:
    """ws://host:port/any/path -> http://host:port/metrics."""
    m = re.match(r"^ws(s?)://([^/]+)", ws_addr)
    if not m:
        raise ValueError(f"not a ws url: {ws_addr}")
    return f"http{m.group(1)}://{m.group(2)}/metrics"


class Worker:
    def __init__(self, addr: str, capacity: int, lease_ttl: float = 20.0):
        self.addr = addr
        self.capacity = capacity
        self.metrics_url = metrics_url(addr)
        self.lease_ttl = lease_ttl
        self.open: int | None = None   # last polled open_channels (None=unknown)
        self.reachable = True          # poll ever succeeded / last poll ok
        self._leases: list[float] = []  # expiry timestamps

    def lease(self):
        self._leases.append(time.time() + self.lease_ttl)

    def load(self) -> int:
        now = time.time()
        self._leases = [t for t in self._leases if t > now]
        # leases cover the assignment-to-connect gap.  polled + leases can
        # briefly double-count a just-connected session (until its lease
        # expires) — conservative by design: a max() would instead let two
        # head-of-queue polls inside one stale poll window both read
        # capacity-1 and overcommit the worker.
        return (self.open or 0) + len(self._leases)

    def has_room(self) -> bool:
        return self.reachable and self.load() < self.capacity


class TicketQueue:
    """FIFO ticket store with expiry and validator-exact responses — the
    shared core of the single-server QueueAPI (serve/server.py) and the
    fleet Dispatcher below."""

    def __init__(self, ttl: float = 30.0):
        self.ttl = ttl  # ticket expiry without a check_user poll
        self._tickets: dict[int, dict] = {}
        self._counter = 0

    def __len__(self):
        return len(self._tickets)

    def _expire(self):
        now = time.time()
        for sid in [s for s, t in self._tickets.items()
                    if now - t["last_seen"] > self.ttl]:
            del self._tickets[sid]

    def add(self) -> dict:
        import secrets
        self._expire()
        sid = self._counter
        self._counter += 1
        self._tickets[sid] = {"auth": secrets.token_hex(16),
                              "last_seen": time.time()}
        return {"session_id": sid,
                "session_auth_id": self._tickets[sid]["auth"]}

    def check(self, sid: int, auth: str, try_assign) -> dict | None:
        """None = unknown ticket/auth.  `try_assign() -> worker_addr | None`
        is consulted only when `sid` is at the head of the queue."""
        self._expire()
        ticket = self._tickets.get(sid)
        if ticket is None or ticket["auth"] != auth:
            return None
        ticket["last_seen"] = time.time()
        ahead = sum(1 for s in self._tickets if s < sid)
        addr = try_assign() if ahead == 0 else None
        if addr is not None:
            del self._tickets[sid]
            return {"session_id": sid, "status": "ready",
                    "worker_auth_id": auth, "worker_addr": addr,
                    "current_position": "0"}
        return {"session_id": sid, "status": "wait", "worker_auth_id": None,
                "worker_addr": None, "current_position": str(ahead)}


class SnapshotVault:
    """Fleet-level session-snapshot store for cross-worker migration
    (beyond the reference, which scales only by whole replicas —
    moshi-server/src/main.rs:293-302).  Workers push serialized session
    snapshots here (periodically during live sessions, and at disconnect);
    when a worker dies, the client re-queues through check_user, lands on a
    different worker, and that worker pulls the snapshot by resume_id.
    Entries are opaque bytes (serialize_snapshot blobs), TTL'd and
    size-capped; access requires the shared fleet auth token."""

    def __init__(self, ttl: float = 120.0, cap_bytes: int = 2 << 30):
        self.ttl = ttl
        self.cap_bytes = cap_bytes
        self._items: dict[str, tuple[float, bytes]] = {}  # rid -> (exp, blob)

    def _sweep(self):
        now = time.time()
        for k in [k for k, (exp, _) in self._items.items() if now > exp]:
            del self._items[k]
        while sum(len(b) for _, b in self._items.values()) > self.cap_bytes \
                and self._items:
            del self._items[next(iter(self._items))]

    def put(self, rid: str, blob: bytes):
        self._sweep()
        self._items[rid] = (time.time() + self.ttl, blob)

    def take(self, rid: str) -> bytes | None:
        """One-shot, like SnapshotStore.take: streaming state must resume
        exactly once (a second taker would fork the session)."""
        self._sweep()
        item = self._items.pop(rid, None)
        return item[1] if item else None

    def __len__(self):
        self._sweep()
        return len(self._items)


class Dispatcher:
    """FIFO ticket queue over a worker pool (transport-independent core)."""

    def __init__(self, workers: list[Worker], ttl: float = 30.0):
        self.workers = workers
        self.queue = TicketQueue(ttl)

    def add_user(self) -> dict:
        return self.queue.add()

    def _assign(self) -> str | None:
        worker = min((w for w in self.workers if w.has_room()),
                     key=lambda w: w.load() / max(w.capacity, 1),
                     default=None)
        if worker is None:
            return None
        worker.lease()
        return worker.addr

    def check_user(self, sid: int, auth: str) -> dict | None:
        return self.queue.check(sid, auth, self._assign)

    def stats(self) -> dict:
        return {"queued": len(self.queue),
                "workers": [{"addr": w.addr, "capacity": w.capacity,
                             "open": w.open, "reachable": w.reachable,
                             "load": w.load()} for w in self.workers]}


async def poll_workers(workers: list[Worker], interval: float = 2.0):
    """Refresh every worker's open_channels from its /metrics.  Workers are
    polled concurrently so a dead host's timeout never stalls the fleet's
    gauge refresh."""
    import aiohttp

    async def poll_one(sess, w):
        try:
            async with sess.get(w.metrics_url,
                                timeout=aiohttp.ClientTimeout(
                                    total=interval)) as r:
                text = await r.text()
            m = re.search(r"^open_channels (\d+(?:\.\d+)?)$", text,
                          re.MULTILINE)
            w.open = int(float(m.group(1))) if m else None
            d = re.search(r"^draining (\d+(?:\.\d+)?)$", text, re.MULTILINE)
            # a draining worker 503s new sessions — stop assigning to it
            w.reachable = not (d and float(d.group(1)) > 0)
        except Exception:
            # connection failure: the ws address is dead too — skip this
            # worker until a poll succeeds.  (A reachable host without
            # /metrics gets a 404 above: lease-only accounting, still
            # assignable.)
            w.open = None
            w.reachable = False

    async with aiohttp.ClientSession() as sess:
        while True:
            await asyncio.gather(*(poll_one(sess, w) for w in workers))
            await asyncio.sleep(interval)


MAX_BODY = 4 << 30  # the app's client_max_size: a snapshot up to 4 GiB


async def read_body(request) -> bytes | bytearray:
    """The request's body.  With a Content-Length it is read into one
    buffer of that size, where `request.read()` grows its buffer chunk by
    chunk, copying a snapshot of GBs again and again.  Anything else, a
    larger body included, goes through `request.read()` and its limits."""
    n = request.content_length
    if n is None or n > MAX_BODY:
        return await request.read()
    buf, pos = bytearray(n), 0
    view = memoryview(buf)
    async for chunk in request.content.iter_any():
        view[pos:pos + len(chunk)] = chunk
        pos += len(chunk)
    return buf


def add_vault_routes(app, vault: SnapshotVault, auth: str):
    """POST /snapshot/{rid} (body = blob) and GET /snapshot/{rid}, both
    requiring the shared fleet token in X-Fleet-Auth."""
    import hmac
    from aiohttp import web

    def authed(request) -> bool:
        got = request.headers.get("X-Fleet-Auth", "")
        return bool(auth) and hmac.compare_digest(got, auth)

    async def push(request):
        if not authed(request):
            return web.Response(status=403, text="bad fleet auth")
        rid = request.match_info["rid"]
        blob = await read_body(request)
        if not blob:
            return web.Response(status=400, text="empty snapshot")
        vault.put(rid, blob)
        return web.json_response({"ok": True, "bytes": len(blob)})

    async def pull(request):
        if not authed(request):
            return web.Response(status=403, text="bad fleet auth")
        blob = vault.take(request.match_info["rid"])
        if blob is None:
            return web.Response(status=404, text="no snapshot")
        return web.Response(body=blob,
                            content_type="application/octet-stream")

    app.router.add_post("/snapshot/{rid}", push)
    app.router.add_get("/snapshot/{rid}", pull)


def add_routes(app, disp: Dispatcher):
    from aiohttp import web

    async def add_user(request):
        out = disp.add_user()
        log("info", f"queue: ticket {out['session_id']} issued "
                    f"(queue_id={request.rel_url.query.get('queue_id')})")
        return web.json_response(out)

    async def check_user(request):
        q = request.rel_url.query
        try:
            sid = int(q.get("session_id", ""))
        except ValueError:
            return web.Response(status=400, text="bad session_id")
        out = disp.check_user(sid, q.get("session_auth_id"))
        if out is None:
            return web.Response(status=404, text="unknown session")
        return web.json_response(out)

    async def user_feedback(request):
        log("info", f"user_feedback: {dict(request.rel_url.query)}")
        return web.json_response({"ok": True})

    async def stats(_):
        return web.json_response(disp.stats())

    app.router.add_get("/add_user", add_user)
    app.router.add_get("/check_user", check_user)
    app.router.add_get("/user_feedback", user_feedback)
    app.router.add_get("/stats", stats)


def main():
    from aiohttp import web

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--worker", action="append", required=True,
                        metavar="ADDR=CAPACITY",
                        help="ws address + session capacity, repeatable")
    parser.add_argument("--poll", type=float, default=2.0)
    parser.add_argument("--ticket-ttl", type=float, default=30.0)
    parser.add_argument("--fleet-auth", default=None,
                        help="shared secret enabling the cross-worker "
                             "session-snapshot vault (workers push live "
                             "snapshots; a replacement worker pulls them "
                             "by resume_id)")
    parser.add_argument("--snapshot-ttl", type=float, default=120.0)
    args = parser.parse_args()

    workers = []
    for spec in args.worker:
        addr, _, cap = spec.partition("=")
        workers.append(Worker(addr, int(cap or "1")))
    disp = Dispatcher(workers, ttl=args.ticket_ttl)

    app = web.Application(client_max_size=MAX_BODY)
    add_routes(app, disp)
    if args.fleet_auth:
        add_vault_routes(app, SnapshotVault(ttl=args.snapshot_ttl),
                         args.fleet_auth)

    async def on_startup(app_):
        app_["poll_task"] = asyncio.create_task(
            poll_workers(workers, args.poll))

    app.on_startup.append(on_startup)
    log("info", f"dispatching over {len(workers)} workers")
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
