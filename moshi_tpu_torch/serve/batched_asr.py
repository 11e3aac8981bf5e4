"""The batched speech-to-text server (counterpart of
moshi_tpu/serve/batched_asr.py), wire-compatible with the reference
moshi-server's BatchedAsr module: B slots, one listener each, stepped
together one 80 ms frame at a time.

    python -m moshi_tpu_torch.serve.batched_asr --checkpoint-dir DIR [--batch-size 8]

The engine: each slot has an audio backlog, an outbox of protocol
messages and a list of pending markers.  `tick` applies the queued slot
ops (reset, snapshot, restore), runs one frame over the slots whose
backlog holds a whole frame (the others are frozen by the exec mask),
dispatches the engine's messages to the outboxes and flushes the markers
that are due.  On a CUDA device the frame runs as replays of
StreamingASR's two graphs; `warmup()` comes first (and `capture()` when
other engines' threads share the card).

The transport: `handle_asr_socket` speaks the reference's MessagePack
protocol (serve/msgpack_codec.py; maps tagged by "type"):
    in:  Init | Marker{id} | Audio{pcm: [f32]} | OggOpus{data: bin}, and the
         legacy framing b"\\x01" + ogg-opus / b"\\x08" + f32le PCM;
    out: Ready (with resume_id / resumed when asked) | Word{text, start_time}
         | EndWord{stop_time} | Marker{id} | Step{step_idx, prs,
         buffered_pcm} | Error{message}.
A malformed message earns its client an Error and never reaches the loop;
a backlog past 30 s is cut (one Error says so); a full batch answers
"server full".  `run_loop` is the shared loop: the slot ops on the event
loop's thread, then each frame on a worker thread, so that the graphs'
read-back does not block the sockets.

Session resume: a session given a resume id (`?resume_support=1`) leaves
a snapshot when its slot is released: its word state, its undelivered
messages, unprocessed audio and pending markers, and its device rows,
moved to host memory (serve/snapshots.py, TTL 60 s).  A later session
with `?resume=<id>` goes on from it on any slot.

`serve_asr` plays the loop's role over a scripted schedule of PCM frames,
with no socket.  Not ported: `mimi_chunks` (models/asr.py).
"""

import argparse
import asyncio
import collections
import copy
import time
import traceback

import numpy as np

from ..models.asr import AsrEndWord, AsrStep, AsrWord
from ..utils.graphs import run_on_device
from .metrics import CONNECT_COUNT, MODEL_STEP_DURATION, OPEN_CHANNELS, TOTAL_STEPS
from .msgpack_codec import packb, unpackb
from .snapshots import (RidRegistry, SnapshotStore, await_pending_release, new_resume_id,
                        wants_resume)


class BatchedAsrState:
    # Backlog cap: a client sending audio faster than real time would grow
    # its slot's backlog without limit; the excess past the cap is dropped.
    MAX_BUFFERED_SECONDS = 30.0

    def __init__(self, asr, mimi_params, lm_params, generator=None):
        self.asr = asr
        self.mimi_params, self.lm_params = mimi_params, lm_params
        self.batch_size = asr.batch_size
        self.frame_size = asr.mimi.frame_size
        self.state = asr.init_state(generator)
        self.slots_free = list(range(self.batch_size))
        self.slot_pcm: dict[int, np.ndarray] = {}
        self.slot_outbox: dict[int, list] = {}
        # slot -> [(due model step, marker id)], first in first out
        self.slot_markers: dict[int, list] = {}
        # the transport's per-session queues, filled from the outboxes
        self.slot_queues: dict[int, asyncio.Queue] = {}
        # queued slot ops, applied in order before the next frame:
        # ("reset", slot), ("snapshot", slot, resume id, leftovers),
        # ("restore", slot, item, device rows)
        self.pending_ops: list[tuple] = []
        self.slot_resume_id = RidRegistry()
        self.slot_resumed: dict[int, bool] = {}
        self.snapshots = SnapshotStore(ttl=60.0, cap=max(8, self.batch_size))
        self.lock = asyncio.Lock()
        self.frame_ms = 0.0  # host ms of the last tick's frame
        # run_loop's frames, host ms each (what MODEL_STEP_DURATION observes)
        self.frame_times = collections.deque(maxlen=10_000)

    def warmup(self):
        """StreamingASR.warmup on this engine's state; a graphed engine needs
        it before its first tick."""
        self.asr.warmup(self.mimi_params, self.lm_params, self.state)

    def capture(self):
        """Capture the graphs now, with one frame in which every slot is
        frozen, then reset every slot and set the step clock back: a server
        whose card other engines' threads use captures nothing while
        serving.  Eager engines do nothing."""
        if not self.asr.graphed:
            return
        clock = self.asr.model_step_idx
        B = self.batch_size
        self.asr.step_pcm(self.mimi_params, self.lm_params, self.state,
                          np.zeros((B, 1, self.frame_size), np.float32), np.zeros(B, bool))
        self.asr.model_step_idx = clock
        for slot in range(B):
            self.asr.reset_batch_idx(self.state, slot)

    def issue_resume_id(self, slot: int) -> str:
        """Let the session on `slot` leave a snapshot when it is released;
        the id opens it again."""
        rid = new_resume_id()
        self.slot_resume_id[slot] = rid
        return rid

    # ---------------------------------------------------------- slots, sync
    def open_slot(self, slot: int | None = None, resume: str | None = None,
                  snapshot=None) -> int | None:
        """Open a session: on `slot`, or on a free slot of the server's
        choosing (None when the batch is full).  With the id of a snapshot
        (or the snapshot itself), the session goes on from it (restored
        before the next frame; its leftovers are back in the slot's
        backlog, outbox and markers), else it starts fresh (reset then);
        `slot_resumed` says which."""
        if slot is None:
            if not self.slots_free:
                return None
            slot = self.slots_free.pop()
        else:
            self.slots_free.remove(slot)
        if snapshot is None and resume is not None:
            if any(op[0] == "snapshot" and op[2] == resume for op in self.pending_ops):
                self._apply_ops()  # the session left since the last tick
            snapshot = self.snapshots.pop(resume)
        if snapshot is None:
            self.slot_pcm[slot] = np.zeros((0,), np.float32)
            self.slot_outbox[slot] = []
            self.slot_markers[slot] = []
            self.pending_ops.append(("reset", slot))
        else:
            arrays, meta = snapshot
            self.slot_pcm[slot] = meta["pcm"]
            self.slot_outbox[slot] = list(meta["msgs"])
            self.slot_markers[slot] = list(meta["markers"])
            self.pending_ops.append(("restore", slot, meta["item"], arrays))
        self.slot_resumed[slot] = snapshot is not None
        return slot

    def close_slot(self, slot: int):
        """Close the session on `slot`.  With a resume id, what it has not
        been sent, its unprocessed audio and its pending markers go into its
        snapshot (taken before the next frame); without one they are
        dropped."""
        rid = self.slot_resume_id.pop(slot, None)
        leftovers = {"pcm": self.slot_pcm.pop(slot), "markers": self.slot_markers.pop(slot),
                     "msgs": self.slot_outbox.pop(slot)}
        if rid is not None:
            self.pending_ops.append(("snapshot", slot, rid, leftovers))
        self.slot_resumed.pop(slot, None)
        self.slots_free.append(slot)

    # ------------------------------------------------------ slots, transport
    async def acquire_slot(self, resume: str | None = None) -> int | None:
        """The transport's open_slot: waits for a resumed session's release
        and for its snapshot (host copies), then opens a slot with a queue
        of its own.  None when the batch is full."""
        await await_pending_release(self.slot_resume_id, resume)
        async with self.lock:
            if not self.slots_free:
                return None
            snapshot = await self.snapshots.take(resume)
            slot = self.open_slot(snapshot=snapshot)
            self.slot_queues[slot] = asyncio.Queue()
            self._deliver(slot)
            OPEN_CHANNELS.inc()
            return slot

    async def release_slot(self, slot: int):
        """The transport's close_slot: the queue's undelivered messages go
        into the snapshot too, which is reserved at once, so a reconnect
        faster than one frame waits for it instead of starting fresh."""
        async with self.lock:
            q = self.slot_queues.pop(slot, None)
            msgs = []
            while q is not None and not q.empty():
                msgs.append(q.get_nowait())
            self.slot_outbox[slot][:0] = msgs
            rid = self.slot_resume_id.get(slot)
            if rid is not None:
                self.snapshots.reserve(rid)
            self.close_slot(slot)
            OPEN_CHANNELS.dec()

    def _deliver(self, slot: int):
        """Move the slot's outbox into its transport queue."""
        q, box = self.slot_queues.get(slot), self.slot_outbox.get(slot)
        if q is None or not box:
            return
        for payload in box:
            q.put_nowait(payload)
        box.clear()

    # ---------------------------------------------------------------- audio
    def feed_pcm(self, slot: int, pcm: np.ndarray) -> bool:
        """Append audio to the slot's backlog.  Returns False, dropping the
        excess, once the backlog would pass MAX_BUFFERED_SECONDS."""
        cap = int(self.MAX_BUFFERED_SECONDS * self.asr.mimi.config.sample_rate)
        buf = self.slot_pcm[slot]
        fits = buf.shape[-1] + pcm.shape[-1] <= cap
        if not fits:
            pcm = pcm[:max(0, cap - buf.shape[-1])]
        self.slot_pcm[slot] = np.concatenate([buf, pcm])
        return fits

    def add_marker(self, slot: int, marker_id: int):
        """Register a time-alignment marker: it comes back once the audio
        buffered now has been processed and the ASR delay has passed."""
        buffered_frames = self.slot_pcm.get(slot, np.zeros(0)).shape[-1] // self.frame_size
        due = self.asr.model_step_idx + self.asr.asr_delay_in_tokens + buffered_frames
        self.slot_markers.setdefault(slot, []).append((due, int(marker_id)))

    # --------------------------------------------------------------- frames
    def _apply_ops(self):
        """Apply the queued slot ops in order, in place (no frame is in
        flight between ticks)."""
        asr, state = self.asr, self.state
        while self.pending_ops:
            op = self.pending_ops.pop(0)
            if op[0] == "reset":
                asr.reset_batch_idx(state, op[1])
            elif op[0] == "snapshot":
                _, slot, rid, leftovers = op
                self.snapshots.put(rid, asr.extract_slot_arrays(state, slot),
                                   {"item": copy.deepcopy(asr.items[slot]), **leftovers})
            else:
                _, slot, item, rows = op
                asr.items[slot] = item
                asr.restore_slot_arrays(state, rows, slot)

    def _next_frame(self):
        """The next frame's (PCM [B, 1, frame_size], exec mask [B]) from the
        backlogs holding a whole frame, or None."""
        fs, B = self.frame_size, self.batch_size
        ready = [s for s, buf in self.slot_pcm.items() if buf.shape[-1] >= fs]
        if not ready:
            return None
        mask = np.zeros(B, bool)
        chunk = np.zeros((B, 1, fs), np.float32)
        for s in ready:
            mask[s] = True
            chunk[s, 0] = self.slot_pcm[s][:fs]
            self.slot_pcm[s] = self.slot_pcm[s][fs:]
        return chunk, mask

    def _step(self, chunk, mask) -> list:
        msgs, self.state = self.asr.step_pcm(self.mimi_params, self.lm_params, self.state,
                                             chunk, mask)
        return msgs

    def _after_frame(self, msgs, mask):
        for m in msgs:
            self._dispatch(m, mask)
        self._flush_markers()

    def tick(self) -> np.ndarray | None:
        """One turn of the server's loop: apply the queued slot ops, then one
        frame over the slots holding a whole frame of audio.  Returns the
        frame's exec mask [B] bool, or None when no slot was ready."""
        self._apply_ops()
        frame = self._next_frame()
        if frame is None:
            return None
        t0 = time.perf_counter()
        self._after_frame(self._step(*frame), frame[1])
        self.frame_ms = (time.perf_counter() - t0) * 1e3
        return frame[1]

    async def run_loop(self):
        """The shared loop, as a background task: an exception is printed,
        then raised."""
        try:
            await self._run_loop()
        except asyncio.CancelledError:
            raise
        except Exception:
            traceback.print_exc()
            raise

    async def _run_loop(self):
        device = self.asr.device
        while True:
            self._apply_ops()  # no frame is in flight here
            frame = self._next_frame()
            if frame is None:
                await asyncio.sleep(0.005)
                continue
            t0 = time.perf_counter()
            msgs = await asyncio.to_thread(run_on_device, device, self._step, *frame)
            self._after_frame(msgs, frame[1])
            self.frame_ms = (time.perf_counter() - t0) * 1e3
            self.frame_times.append(self.frame_ms)
            MODEL_STEP_DURATION.observe(self.frame_ms / 1e3)
            TOTAL_STEPS.inc()
            for slot in list(self.slot_queues):
                self._deliver(slot)
            await asyncio.sleep(0)

    def _dispatch(self, m, mask):
        if isinstance(m, AsrWord):
            self._send(m.batch_idx, {"type": "Word", "text": m.text or "",
                                     "start_time": m.start_time})
        elif isinstance(m, AsrEndWord):
            self._send(m.batch_idx, {"type": "EndWord", "stop_time": m.stop_time})
        elif isinstance(m, AsrStep):
            # each executing slot's column of the [num_heads, B] probabilities
            for b in np.nonzero(mask)[0]:
                b = int(b)
                self._send(b, {"type": "Step", "step_idx": int(m.step_idx),
                               "prs": [float(p) for p in m.prs[:, b]],
                               "buffered_pcm": int(self.slot_pcm.get(
                                   b, np.zeros(0)).shape[-1])})

    def _flush_markers(self):
        step_idx = self.asr.model_step_idx
        for slot, markers in self.slot_markers.items():
            while markers and markers[0][0] <= step_idx:
                _, marker_id = markers.pop(0)
                self._send(slot, {"type": "Marker", "id": marker_id})

    def _send(self, slot: int, payload: dict):
        box = self.slot_outbox.get(slot)
        if box is not None:
            box.append(payload)


def _parse(data: bytes, opus_pcm):
    """One client message -> ("pcm", f32 array) | ("init", None) |
    ("marker", id) | None (discarded).  Raises on a malformed one."""
    kind = data[0]
    if kind == 1:  # legacy framing: ogg-opus audio
        return "pcm", opus_pcm(data[1:])
    if kind == 8:  # legacy framing: raw f32le PCM
        return "pcm", np.frombuffer(data[1:len(data) - (len(data) - 1) % 4], np.float32)
    try:
        msg = unpackb(data)
        mtype = msg.get("type")
    except Exception:
        return None  # unknown messages are discarded (protocol.md:32)
    if mtype == "Init":
        return "init", None
    if mtype == "Marker":
        return "marker", int(msg["id"])
    if mtype == "Audio":
        return "pcm", np.asarray(msg["pcm"], np.float32).reshape(-1)
    if mtype == "OggOpus":
        return "pcm", opus_pcm(msg["data"])
    return None


async def handle_asr_socket(request, state: BatchedAsrState):
    """aiohttp handler of the batched ASR route."""
    from aiohttp import WSMsgType, web

    ws = web.WebSocketResponse(autoping=True, heartbeat=10.0)
    await ws.prepare(request)
    CONNECT_COUNT.inc()
    query = dict(request.rel_url.query)
    want_resume = wants_resume(query)
    slot = await state.acquire_slot(query.get("resume"))
    if slot is None:
        await ws.send_bytes(packb({"type": "Error", "message": "server full"}))
        await ws.close()
        return ws
    try:
        ready = {"type": "Ready"}
        if want_resume:
            ready["resume_id"] = state.issue_resume_id(slot)
            ready["resumed"] = state.slot_resumed.get(slot, False)
        await ws.send_bytes(packb(ready))
    except Exception:
        # a client gone during the handshake still releases its slot
        await state.release_slot(slot)
        raise

    reader = None  # the opus decoder, made at the first opus message

    def opus_pcm(data: bytes) -> np.ndarray:
        nonlocal reader
        if reader is None:
            from ..native import load
            reader = load().OpusStreamReader(state.asr.mimi.config.sample_rate)
        return np.frombuffer(reader.append_bytes(bytes(data)), np.float32)

    async def sender():
        q = state.slot_queues[slot]
        while True:
            await ws.send_bytes(packb(await q.get()))

    send_task = asyncio.create_task(sender())
    backlog_warned = False
    try:
        async for message in ws:
            if message.type != WSMsgType.BINARY or not message.data:
                continue
            # a malformed message (bad field types, truncated data, PCM of
            # the wrong shape) earns an Error and never reaches the loop
            try:
                parsed = _parse(message.data, opus_pcm)
            except Exception as e:
                await ws.send_bytes(packb({"type": "Error", "message": f"bad message: {e}"}))
                continue
            if parsed is None:
                continue
            kind, value = parsed
            if kind == "init":
                await ws.send_bytes(packb({"type": "Ready"}))
            elif kind == "marker":
                state.add_marker(slot, value)
            elif value.size and not state.feed_pcm(slot, value) and not backlog_warned:
                backlog_warned = True
                await ws.send_bytes(packb({"type": "Error", "message":
                                           "audio backlog cap reached; excess dropped"}))
    finally:
        send_task.cancel()
        await state.release_slot(slot)
    return ws


def serve_asr(state: BatchedAsrState, schedule, frames):
    """Play the batched ASR server's loop over a script.

    schedule: one dict per tick, {slot: action}.  "join" opens a new session
    on the slot (closing the one before) and feeds its next frame; "send"
    feeds the slot's next frame; "leave" closes the slot's session, keeping
    its snapshot, and feeds nothing; ("resume", src) opens a session on the
    slot from the snapshot that the last "leave" of slot `src` kept, and
    feeds the slot's next frame.  A slot not named sends nothing and is
    frozen that tick.  Then one tick runs.  frames: {slot: float32 [n,
    frame_size]}, the PCM each slot sends, in order.

    Returns (sessions, ms): sessions[slot] holds one (text tokens [executed
    frames] int64, messages) per session of the slot, and ms the host time
    of each batched frame, from handing its audio to the device to the
    messages dispatched."""
    taken = dict.fromkeys(frames, 0)
    sessions = {s: [] for s in range(state.batch_size)}
    left: dict[int, str] = {}  # slot -> resume id of its last session that left
    ms = []

    for tick in schedule:
        for s, action in tick.items():
            if action == "leave":
                left[s] = state.issue_resume_id(s)
                state.close_slot(s)
                continue
            if action == "join" or (isinstance(action, tuple) and action[0] == "resume"):
                if s in state.slot_outbox:   # the outbox was emptied after the last tick
                    state.close_slot(s)
                state.open_slot(s, None if action == "join" else left.pop(action[1]))
                sessions[s].append(([], []))
            elif action != "send":
                raise ValueError(f"tick action {action!r}")
            state.feed_pcm(s, frames[s][taken[s]])
            taken[s] += 1
        mask = state.tick()
        if mask is None:
            continue
        ms.append(state.frame_ms)
        for s in np.nonzero(mask)[0]:
            sessions[s][-1][0].append(state.asr.items[s].text_token)
        for s, box in state.slot_outbox.items():
            sessions[s][-1][1].extend(box)
            box.clear()
    return ({s: [(np.array(t, dtype=np.int64), m) for t, m in sess]
             for s, sess in sessions.items()}, ms)


def build_state(info, *, batch_size: int, device="cuda", asr_delay_in_tokens=None,
                temperature: float = 0.0, kv_cache=None, context=None, weights=None,
                mimi_dtype=None, conditioning_delay=None,
                conditioning_learnt_padding: bool = False, text_tokenizer=None,
                rng_seed: int = 0) -> BatchedAsrState:
    """A BatchedAsrState over the checkpoint of `info` (a CheckpointInfo),
    its weights on `device`, with the serving knobs applied
    (utils/serving.py); not warmed up.  The ASR delay defaults to the
    checkpoint's stt_config (0.5 s), the conditioning delay too."""
    from ..models.asr import StreamingASR, asr_sum_condition
    from ..utils.serving import apply_serving_overrides

    mimi, mimi_params = info.get_mimi(device=device)
    lm, lm_params = info.get_moshi(device=device)
    lm, lm_params, mimi_params, md = apply_serving_overrides(
        lm, lm_params, mimi_params, kv_cache=kv_cache, context=context, weights=weights,
        mimi_dtype=mimi_dtype)
    if asr_delay_in_tokens is None:
        asr_delay_in_tokens = int(info.stt_config.get("audio_delay_seconds", 0.5)
                                  * mimi.config.frame_rate)
    if conditioning_delay is None:
        conditioning_delay = info.stt_config.get("conditioning_delay")
    cond = asr_sum_condition(info, lm.config.dim, conditioning_delay=conditioning_delay,
                             learnt_padding=conditioning_learnt_padding, device=device)
    asr = StreamingASR(mimi, lm, batch_size, asr_delay_in_tokens=int(asr_delay_in_tokens),
                       temperature=temperature, text_tokenizer=text_tokenizer,
                       mimi_dtype=md, sum_condition=cond, device=device, rng_seed=rng_seed)
    return BatchedAsrState(asr, mimi_params, lm_params)


def main(argv=None):
    import gc

    from aiohttp import web

    from ..models.loaders import CheckpointInfo
    from ..utils.serving import serving_device
    from .metrics import REGISTRY

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8999)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-cache", default=None, choices=["model", "int8", "int4"],
                    help="the temporal transformer's KV cache dtype")
    ap.add_argument("--context", type=int, default=None,
                    help="the attention window (per-user KV memory scales with it)")
    ap.add_argument("--weights", default=None, choices=["int8", "int4"],
                    help="quantize the LM's linears after loading")
    ap.add_argument("--mimi-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--conditioning-delay", type=float, default=None,
                    help="the `delay` condition's value, for checkpoints with a delay "
                         "conditioner (the checkpoint's stt_config by default)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = serving_device(args.device)
    info = CheckpointInfo.from_dir(args.checkpoint_dir)
    state = build_state(info, batch_size=args.batch_size, device=device,
                        temperature=args.temperature, kv_cache=args.kv_cache,
                        context=args.context, weights=args.weights,
                        mimi_dtype=args.mimi_dtype, conditioning_delay=args.conditioning_delay,
                        text_tokenizer=info.get_text_tokenizer())
    state.warmup()
    state.capture()
    gc.freeze()  # what the warm-up made lives as long as the server

    async def metrics(_):
        return web.Response(text=REGISTRY.expose(), content_type="text/plain")

    async def on_startup(app):
        app["loop_task"] = asyncio.create_task(state.run_loop())

    app = web.Application()
    app["state"] = state
    app.router.add_get("/api/asr-streaming", lambda req: handle_asr_socket(req, state))
    app.router.add_get("/metrics", metrics)
    app.on_startup.append(on_startup)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
