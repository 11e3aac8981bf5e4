"""Session-resume snapshots (counterpart of moshi_tpu/serve/snapshots.py),
shared by the batched servers.

A snapshot is (a tree of tensors, host metadata), kept under a resume id
that a client learns at the start of its session when it asked for one
(the `resume_support` or `resume` query parameter; other sessions never
fill the store).  Entries expire after a TTL, the store holds at most
`cap` of them, and their tensors move to host memory on a worker thread,
so that no card memory stays pinned for the TTL.  `take` is one-shot and
waits for that move first, so a restore always reads host copies.

`serialize_snapshot` / `deserialize_snapshot` are the wire format of a
snapshot that leaves the process, byte-compatible with the JAX
package's: one safetensors blob of native_ckpt's flattened tree, bf16
leaves as U16 named in the `__meta__` header.  `vault_push` / `vault_pull`
move such blobs to and from the fleet dispatcher's vault
(serve/dispatcher.py) with the standard library's HTTP client, so a
worker thread can stream a snapshot of GBs without holding up an event
loop; `host_copy` brings a snapshot's card copies to host memory on a
stream of its own, so the copy runs beside the frames' kernels.
"""

import asyncio
import http.client
import json
import secrets
import time
from urllib.parse import urlsplit

import numpy as np
import torch

from ..models.native_ckpt import flatten_tree, unflatten_tree
from ..utils.safetensors import dump_chunks, loads
from ..utils.trees import copy_into, map_tensors, to_device


def new_resume_id() -> str:
    return secrets.token_hex(8)


def wants_resume(query) -> bool:
    return "resume_support" in query or "resume" in query


# ------------------------------------------------------------ wire format
def serialize_snapshot(arrays, meta: dict) -> bytes:
    """(a tree of tensors, JSON-able meta) -> one safetensors blob."""
    return b"".join(snapshot_chunks(arrays, meta)[0])


def snapshot_chunks(arrays, meta: dict) -> tuple[list, int]:
    """serialize_snapshot's blob as a list of buffers (views of the host
    tensors) and its length."""
    flat, bf16_keys = {}, []
    for k, v in flatten_tree({"state": arrays}).items():
        t = torch.as_tensor(v).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
            bf16_keys.append(k)
        flat[k] = t.contiguous()
    header = json.dumps({"meta": meta, "bf16": bf16_keys}).encode("utf-8")
    flat["__meta__"] = torch.from_numpy(np.frombuffer(header, np.uint8).copy())
    return dump_chunks(flat)


def deserialize_snapshot(data: bytes):
    """Inverse of serialize_snapshot: (tree of host tensors, meta)."""
    flat = loads(data)
    header = json.loads(bytes(flat.pop("__meta__").numpy()).decode("utf-8"))
    for k in header["bf16"]:
        flat[k] = flat[k].view(torch.bfloat16)
    return unflatten_tree(flat)["state"], header["meta"]


# ------------------------------------------------------------ the vault
def _vault_request(method: str, url: str, rid: str, auth: str, timeout: float,
                   chunks=None, nbytes: int = 0) -> tuple[int, bytes]:
    """One request to `{url}/snapshot/{rid}` with the fleet token; (HTTP
    status, body)."""
    u = urlsplit(url)
    conn_cls = http.client.HTTPSConnection if u.scheme == "https" else http.client.HTTPConnection
    conn = conn_cls(u.hostname, u.port, timeout=timeout)
    try:
        headers = {"X-Fleet-Auth": auth}
        if chunks is not None:
            headers["Content-Length"] = str(nbytes)
            headers["Content-Type"] = "application/octet-stream"
        conn.request(method, f"{u.path.rstrip('/')}/snapshot/{rid}",
                     body=iter(chunks) if chunks is not None else None, headers=headers)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def vault_push(url: str, rid: str, auth: str, arrays, meta: dict,
               timeout: float = 30.0) -> int:
    """POST a snapshot (host tensors) to the vault, streamed from the
    tensors' memory.  Returns its bytes; raises unless the vault took it."""
    chunks, nbytes = snapshot_chunks(arrays, meta)
    status, body = _vault_request("POST", url, rid, auth, timeout, chunks, nbytes)
    if status != 200:
        raise RuntimeError(f"vault push {rid}: HTTP {status} {body[:80]!r}")
    return nbytes


def vault_pull(url: str, rid: str, auth: str, timeout: float = 30.0):
    """GET (and so take: the vault's entries are one-shot) a snapshot:
    (tree of host tensors, meta), or None."""
    status, body = _vault_request("GET", url, rid, auth, timeout)
    return deserialize_snapshot(body) if status == 200 else None


def pinned_like(tree):
    """Host tensors of `tree`'s leaves' shapes and dtypes: pinned for the
    leaves on a CUDA device (the staging buffers of `host_copy`)."""
    return map_tensors(tree, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                   pin_memory=t.is_cuda))


def same_layout(a, b) -> bool:
    """Whether two trees have the same paths, shapes and dtypes."""
    if a is None or b is None:
        return False
    fa, fb = flatten_tree({"t": a}), flatten_tree({"t": b})
    return fa.keys() == fb.keys() and all(
        fa[k].shape == fb[k].shape and fa[k].dtype == fb[k].dtype for k in fa)


def host_copy(tree, ready=None, stream=None, out=None):
    """`tree` with every tensor on the host.  With `ready` (a CUDA event
    recorded after the copies in `tree` were made), `stream` and `out`
    (pinned_like(tree)), the copies run on `stream` once `ready` has
    passed, into `out`, which is returned: beside the work the producer
    queued since, and into pinned memory, so that no other thread's
    launches wait for them (a copy to pageable memory holds them up for
    all of its length)."""
    if ready is None:
        return to_device(tree, "cpu")
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        stream.wait_event(ready)
        return copy_into(out, tree)


# -------------------------------------------------------------- slot ids
class RidRegistry(dict):
    """slot -> resume id; popping a slot's id (its session was released and
    its snapshot reserved) wakes whoever waits for that id."""

    def __init__(self):
        super().__init__()
        self._released: dict[str, asyncio.Event] = {}

    def _event(self, rid: str) -> asyncio.Event:
        ev = self._released.get(rid)
        if ev is None:
            ev = self._released[rid] = asyncio.Event()
        return ev

    def pop(self, slot, default=None):
        rid = super().pop(slot, default)
        if rid is not None:
            ev = self._released.pop(rid, None)
            if ev is not None:
                ev.set()
        return rid


async def await_pending_release(slot_resume_id: dict, rid: str | None,
                                timeout: float = 1.0):
    """Wait (at most `timeout` s) until the slot that owns `rid` has been
    released, i.e. its snapshot reserved.  A reconnect can win the event
    loop over the dropped session's release; without the wait it would
    find no snapshot and start fresh.  Call it before taking the server's
    lock (the release needs it).  No-op for an unknown or released id."""
    if not rid or rid not in slot_resume_id.values():
        return
    if isinstance(slot_resume_id, RidRegistry):
        try:
            await asyncio.wait_for(slot_resume_id._event(rid).wait(), timeout)
        except asyncio.TimeoutError:
            pass
        return
    deadline = time.monotonic() + timeout
    while rid in slot_resume_id.values() and time.monotonic() < deadline:
        await asyncio.sleep(0.01)


def _on_host(tree):
    return to_device(tree, "cpu")


# ------------------------------------------------------------------ store
class SnapshotStore:
    def __init__(self, ttl: float = 60.0, cap: int = 4):
        self.ttl, self.cap = ttl, cap
        # rid -> [expires, arrays, meta, offload task or None, filled event or None]
        self._items: dict[str, list] = {}

    def __len__(self):
        return len(self._items)

    def __contains__(self, rid) -> bool:
        item = self._items.get(rid)
        return item is not None and item[1] is not None

    def __getitem__(self, rid):
        """(arrays, meta) of a filled entry, left in the store."""
        item = self._items[rid]
        if item[1] is None:
            raise KeyError(f"{rid}: reserved, not filled yet")
        return item[1], item[2]

    def sweep(self):
        now = time.time()
        for k in [k for k, it in self._items.items() if now > it[0]]:
            del self._items[k]

    def _make_room(self):
        self.sweep()
        while len(self._items) >= self.cap:
            del self._items[next(iter(self._items))]

    def reserve(self, rid: str):
        """A placeholder for a snapshot whose extraction is still queued
        behind a frame: a client reconnecting faster than one frame waits
        in `take` for `put` instead of starting fresh.  No-op when ttl <= 0."""
        if self.ttl <= 0:
            return
        self._make_room()
        try:
            event = asyncio.Event()
        except RuntimeError:
            event = None
        self._items[rid] = [time.time() + self.ttl, None, None, None, event]

    def put(self, rid: str, arrays, meta: dict | None = None):
        """Store under `rid` (filling its reservation if there is one) and
        move `arrays` to host memory: on a worker thread under a running
        event loop, else at once.  No-op when ttl <= 0."""
        if self.ttl <= 0:
            return
        item = self._items.get(rid)
        if item is None:
            self._make_room()
            item = self._items[rid] = [time.time() + self.ttl, None, None, None, None]
        item[1], item[2] = arrays, dict(meta or {})
        if item[4] is not None:
            item[4].set()
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            item[1] = _on_host(arrays)
            return

        async def offload():
            # written after an eviction or a take too (the list is then
            # unreferenced); take() awaits this task and reads item[1]
            item[1] = await asyncio.to_thread(_on_host, arrays)

        item[3] = asyncio.ensure_future(offload())

    def pop(self, rid: str | None):
        """One-shot, without waiting: (arrays, meta) of a filled entry, or
        None (the serving loop's synchronous form of `take`)."""
        self.sweep()
        item = self._items.get(rid) if rid else None
        if item is None or item[1] is None or (item[3] is not None and not item[3].done()):
            return None
        del self._items[rid]
        return item[1], item[2]

    async def take(self, rid: str | None, fill_timeout: float = 5.0):
        """One-shot: (arrays on the host, meta), or None.  Waits for a
        reserved entry to be filled (its extraction runs between frames)
        and for the move to host memory."""
        self.sweep()
        # looked up without popping: put() fills a reservation by its id
        item = self._items.get(rid) if rid else None
        if item is None:
            return None
        if item[1] is None and item[4] is not None:
            try:
                await asyncio.wait_for(item[4].wait(), fill_timeout)
            except asyncio.TimeoutError:
                pass
            # the reservation may have been evicted at the cap and made
            # anew by put() while we waited: look the id up again
            item = self._items.get(rid, item)
        self._items.pop(rid, None)
        if item[1] is None:
            return None
        task = item[3]
        if task is not None and not task.done():
            try:
                await task
            except Exception:
                pass
        return item[1], item[2]
