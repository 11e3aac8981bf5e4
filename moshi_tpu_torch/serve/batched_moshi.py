"""The batched full-duplex Moshi server (counterpart of
moshi_tpu/serve/batched_moshi.py): B slots, one user each, stepped together
one 80 ms frame at a time.  A slot with no audio ready is frozen by its
exec_mask entry: it computes, but its streaming state does not advance and
it outputs nothing.

    python -m moshi_tpu_torch.serve.batched_moshi --checkpoint-dir DIR [--batch-size 4]

On a CUDA device the frame runs as replays of one CUDA graph.  Each
websocket session (`handle_chat`, the reference's binary protocol: the
handshake, ogg-opus audio as MT 1 both ways, text as MT 2, pause / start /
restart, ping, error; opus only, as in the JAX package) holds a slot:
its audio goes into the slot's backlog (cut at 30 s), and `run_loop`, the
shared loop, applies the queued slot ops (reset, snapshot, restore) on the
event loop's thread and runs each frame on a worker thread, then queues
each slot's PCM and tokens for its session.

Session resume (`?resume_support=1`, then `?resume=<id>`): a session that
leaves with a resume id leaves its slot's rows of the LM's, the encoder's
and the decoder's streaming state (moved to host memory,
serve/snapshots.py), its undelivered frames and its unprocessed audio; a
later session goes on from them on any slot, written back in place, so
the captured graph stays valid.  The batch's generator is not a slot's:
a resumed session goes on with the conversation, not with the same draws.

`serve_batched` plays the loop's role over a scripted schedule of PCM
frames, with no socket.  Not ported: the multi-card mesh (`--tp`).
"""

import argparse
import asyncio
import collections
import json
import time
import traceback

import numpy as np
import torch

from ..models.lm import UNGENERATED_TOKEN
from ..models.lm_gen import LMGen, LMGenConfig
from ..utils.graphs import GraphedStep, run_on_device
from ..utils.trees import masked_reset, put_slots, state_batch_axes, take_slots
from . import protocol as proto
from .metrics import CONNECT_COUNT, MODEL_STEP_DURATION, OPEN_CHANNELS, TOTAL_STEPS
from .snapshots import (RidRegistry, SnapshotStore, await_pending_release, new_resume_id,
                        wants_resume)

_GEN_KEYS = ("cache", "offsets", "transformer")  # the per-slot part of LMGen's state


class BatchedMoshiState:
    """One model, one LMGen, B streaming slots on `device`.  The codec runs
    in the dtype of its parameters; the LM's KV cache follows its config
    (`kv_cache_dtype`).  Streaming state is updated in place.

    `graphed` (the default on a CUDA device) captures the whole frame as
    one CUDA graph at the first frame after `warmup()` (the JAX package's
    one jitted frame) and replays it at every frame after: PCM and
    exec_mask are copied into static input buffers first, and the returned
    tensors are the graph's static outputs.  Per-slot resets stay between
    frames, outside the graph, writing in place.  `graphed=False` runs the
    same function eagerly (the CPU's only path).

    `text_tokenizer` (text/spm.py, or None) turns the sessions' text
    tokens into MT 2 pieces; `lm_gen_kwargs` is the checkpoint's
    lm_gen_config."""

    # Backlog cap: a client sending audio faster than real time would grow
    # its slot's backlog without limit; the excess past the cap is dropped.
    MAX_BUFFERED_SECONDS = 30

    def __init__(self, mimi, mimi_params, lm, lm_params, batch_size: int, *,
                 text_tokenizer=None, device="cuda", rng_seed: int = 0,
                 graphed: bool | None = None, **lm_gen_kwargs):
        self.mimi, self.mimi_params = mimi, mimi_params
        self.lm, self.lm_params = lm, lm_params
        self.text_tokenizer = text_tokenizer
        self.batch_size = batch_size
        self.device = dev = torch.device(device)
        self.graphed = dev.type == "cuda" if graphed is None else graphed
        if self.graphed and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        self.mimi_dtype = md = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        self.frame_size = mimi.frame_size
        self.lm_gen = LMGen(lm, LMGenConfig.from_dict(lm_gen_kwargs))
        self._n_in = lm.config.num_codebooks - lm.config.dep_q - 1
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(rng_seed)
        self.enc_state = mimi.init_encode_state(batch_size, md, dev)
        self.dec_state = mimi.init_decode_state(batch_size, md, dev)
        self.gen_state = self.lm_gen.init_state(batch_size, self.generator, torch.bfloat16,
                                                dev)
        self.pcm_in = torch.zeros((batch_size, 1, self.frame_size), dtype=torch.float32,
                                  device=dev)
        self.mask_in = torch.zeros(batch_size, dtype=torch.bool, device=dev)
        self.step = GraphedStep(self._frame, graphed=self.graphed, device=dev,
                                generators=(self.generator,))
        # frames still to drop after a slot's reset (the first-frame skip)
        self.skip_frames = np.zeros(batch_size, np.int64)
        # exact per-leaf batch axes: a shape rule mistakes the layer axis of
        # a [L, B, ...] cache for the batch axis when B == L
        self._ax_gen = state_batch_axes(
            lambda b, d: self.lm_gen.init_state(b, None, torch.bfloat16, d))
        self._ax_enc = state_batch_axes(lambda b, d: mimi.init_encode_state(b, md, d))
        self._ax_dec = state_batch_axes(lambda b, d: mimi.init_decode_state(b, md, d))
        # the transport: sessions' slots, backlogs and queues of (PCM,
        # tokens); slot ops queued for the loop, applied between frames:
        # ("reset", slot), ("snapshot", slot, resume id, leftovers),
        # ("restore", slot, rows)
        self.slots_free = list(range(batch_size))
        self.slot_queues: dict[int, asyncio.Queue] = {}
        self.slot_pcm: dict[int, np.ndarray] = {}
        self.pending_ops: list[tuple] = []
        self.slot_resume_id = RidRegistry()
        self.slot_resumed: dict[int, bool] = {}
        self.snapshots = SnapshotStore(ttl=60.0, cap=max(8, batch_size))
        self.lock = asyncio.Lock()
        self.frame_ms = 0.0  # host ms of the loop's last frame, to its read-back
        # run_loop's frames, host ms each (what MODEL_STEP_DURATION observes)
        self.frame_times = collections.deque(maxlen=10_000)

    def _frame(self, pcm, mask):
        codes, _ = self.mimi.encode_step(self.mimi_params, self.enc_state,
                                         pcm.to(self.mimi_dtype), mask)
        out, _ = self.lm_gen.step(self.lm_params, self.gen_state, codes[:, :self._n_in],
                                  mask)
        audio = out[:, 1:1 + self.mimi.num_codebooks].clamp(min=0)
        pcm_out, _ = self.mimi.decode_step(self.mimi_params, self.dec_state, audio, mask)
        return out, pcm_out.float()

    def _inputs(self, pcm, exec_mask):
        self.pcm_in.copy_(torch.as_tensor(pcm, dtype=torch.float32))
        self.mask_in.copy_(torch.as_tensor(exec_mask, dtype=torch.bool))
        return self.pcm_in, self.mask_in

    def frame(self, pcm, exec_mask):
        """One batched frame: pcm [B, 1, frame_size] float32 (numpy or
        tensor), exec_mask [B] bool.  Mimi encode -> LMGen.step -> Mimi
        decode, state in place.  Returns (out [B, 1 + dep_q, 1] int64, pcm
        [B, 1, frame_size] float32), on the device; a frozen slot's out is
        UNGENERATED_TOKEN.  Graphed, the next frame overwrites both: read
        them first."""
        return self.step(*self._inputs(pcm, exec_mask))

    def warmup(self):
        """Three zero frames on every slot, eagerly (on the graph's side
        stream when graphed), then reset them all.  A graphed engine needs
        it before its first frame."""
        B = self.batch_size
        for _ in range(3):
            self.step.warm_up(*self._inputs(np.zeros((B, 1, self.frame_size), np.float32),
                                            np.ones(B, bool)))
        self.reset_all()

    def _reset(self, mask):
        dev, md = self.device, self.mimi_dtype
        fresh = self.lm_gen.init_state(1, None, torch.bfloat16, dev)
        for key in _GEN_KEYS:
            masked_reset(self.gen_state[key], fresh[key], mask, self._ax_gen[key])
        masked_reset(self.enc_state, self.mimi.init_encode_state(1, md, dev), mask,
                     self._ax_enc)
        masked_reset(self.dec_state, self.mimi.init_decode_state(1, md, dev), mask,
                     self._ax_dec)

    def reset_all(self):
        self._reset(np.ones(self.batch_size, bool))
        self.skip_frames[:] = 0

    def reset_slot(self, slot: int):
        """A new session on `slot`: fresh streaming state, and the first
        frame it sends is dropped, as the server does after a reset
        (moshi_tpu serve/batched_moshi.py:343-350)."""
        mask = np.zeros(self.batch_size, bool)
        mask[slot] = True
        self._reset(mask)
        self.skip_frames[slot] = 1

    def capture(self):
        """Capture the graph now, with one frame in which every slot is
        frozen, then reset every slot: a server whose card other engines'
        threads use captures nothing while serving.  Eager engines do
        nothing."""
        if self.graphed:
            self.frame(np.zeros((self.batch_size, 1, self.frame_size), np.float32),
                       np.zeros(self.batch_size, bool))
            self.reset_all()

    # ------------------------------------------------------------- resume
    def issue_resume_id(self, slot: int) -> str:
        """Let the session on `slot` leave a snapshot when it is released;
        the client learns the id at the start of its session."""
        rid = new_resume_id()
        self.slot_resume_id[slot] = rid
        return rid

    def snapshot_slot(self, slot: int):
        """Slot `slot`'s rows of the LM's, the encoder's and the decoder's
        streaming state, each a state at batch size 1 (copies)."""
        idx = [int(slot)]
        gen = {key: take_slots(self.gen_state[key], idx, self._ax_gen[key])
               for key in _GEN_KEYS}
        return (gen, take_slots(self.enc_state, idx, self._ax_enc),
                take_slots(self.dec_state, idx, self._ax_dec))

    def restore_slot(self, slot: int, rows):
        """Write rows from snapshot_slot (on any device) into slot `slot`,
        in place; the stream goes on mid-conversation, so no first-frame
        skip."""
        gen, enc, dec = rows
        idx = [int(slot)]
        for key, v in gen.items():
            put_slots(self.gen_state[key], v, idx, self._ax_gen[key])
        put_slots(self.enc_state, enc, idx, self._ax_enc)
        put_slots(self.dec_state, dec, idx, self._ax_dec)
        self.skip_frames[slot] = 0

    # ------------------------------------------------------- the transport
    async def acquire_slot(self, resume: str | None = None) -> int | None:
        """Open a session on a free slot (None when the batch is full): from
        the snapshot of `resume` when there is one (its undelivered frames
        queued again, its audio back in the backlog), else fresh.  The
        reset or restore is queued for the loop."""
        await await_pending_release(self.slot_resume_id, resume)
        async with self.lock:
            if not self.slots_free:
                return None
            snap = await self.snapshots.take(resume)
            slot = self.slots_free.pop()
            q = self.slot_queues[slot] = asyncio.Queue()
            self.slot_pcm[slot] = np.zeros((0,), np.float32)
            if snap is not None:
                rows, meta = snap
                for m in meta.get("msgs", []):
                    q.put_nowait(m)
                if meta.get("pcm") is not None and meta["pcm"].size:
                    self.slot_pcm[slot] = meta["pcm"]
                self.pending_ops.append(("restore", slot, rows))
            else:
                self.pending_ops.append(("reset", slot))
            self.slot_resumed[slot] = snap is not None
            OPEN_CHANNELS.inc()
            return slot

    async def release_slot(self, slot: int):
        """Close the session on `slot`.  With a resume id, its snapshot is
        reserved at once (a reconnect faster than one frame waits for it)
        and taken before the next frame."""
        async with self.lock:
            q = self.slot_queues.pop(slot, None)
            pcm = self.slot_pcm.pop(slot, None)
            rid = self.slot_resume_id.get(slot)
            if rid is not None:
                msgs = []
                while q is not None and not q.empty():
                    msgs.append(q.get_nowait())
                self.snapshots.reserve(rid)
                self.pending_ops.append(("snapshot", slot, rid, {"msgs": msgs, "pcm": pcm}))
            self.slot_resume_id.pop(slot, None)
            self.slot_resumed.pop(slot, None)
            self.slots_free.append(slot)
            OPEN_CHANNELS.dec()

    def feed_pcm(self, slot: int, pcm: np.ndarray):
        """Append audio to the slot's backlog, the excess past
        MAX_BUFFERED_SECONDS dropped."""
        cap = self.MAX_BUFFERED_SECONDS * self.mimi.config.sample_rate
        buf = self.slot_pcm[slot]
        if buf.shape[-1] + pcm.size > cap:
            pcm = pcm[:max(0, cap - buf.shape[-1])]
        self.slot_pcm[slot] = np.concatenate([buf, pcm])

    def _apply_ops(self):
        while self.pending_ops:
            op = self.pending_ops.pop(0)
            if op[0] == "reset":
                self.reset_slot(op[1])
            elif op[0] == "snapshot":
                _, slot, rid, leftovers = op
                self.snapshots.put(rid, self.snapshot_slot(slot), leftovers)
            else:
                self.restore_slot(op[1], op[2])

    def _frame_to_host(self, chunk, mask):
        out, pcm = self.frame(chunk, mask)
        return out.cpu().numpy(), pcm.cpu().numpy()

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
        B, fs = self.batch_size, self.frame_size
        next_sweep = 0.0
        while True:
            if len(self.snapshots) and time.time() > next_sweep:
                self.snapshots.sweep()  # expired snapshots free their memory
                next_sweep = time.time() + 5.0
            self._apply_ops()  # no frame is in flight here
            ready = [s for s, buf in self.slot_pcm.items() if buf.shape[-1] >= fs]
            if not ready:
                await asyncio.sleep(0.005)
                continue
            mask = np.zeros(B, bool)
            chunk = np.zeros((B, 1, fs), np.float32)
            for s in ready:
                chunk[s, 0] = self.slot_pcm[s][:fs]
                self.slot_pcm[s] = self.slot_pcm[s][fs:]
                if self.skip_frames[s] > 0:
                    # the first-frame skip of a new session: the frame is
                    # dropped (the reference encodes it and resets the
                    # encoder, which leaves the state as it was)
                    self.skip_frames[s] -= 1
                    continue
                mask[s] = True
            if not mask.any():
                await asyncio.sleep(0)
                continue
            # the sessions the frame is for: a slot released and taken again
            # while the frame runs gets none of it
            queues = {s: self.slot_queues.get(s) for s in np.nonzero(mask)[0].tolist()}
            t0 = time.perf_counter()
            out, pcm = await asyncio.to_thread(run_on_device, self.device,
                                               self._frame_to_host, chunk, mask)
            self.frame_ms = (time.perf_counter() - t0) * 1e3
            self.frame_times.append(self.frame_ms)
            MODEL_STEP_DURATION.observe(self.frame_ms / 1e3)
            TOTAL_STEPS.inc()
            for s, q in queues.items():
                if q is None or q is not self.slot_queues.get(s) \
                        or (out[s] == UNGENERATED_TOKEN).any():
                    continue
                q.put_nowait((pcm[s, 0], out[s, :, 0]))
            await asyncio.sleep(0)


def serve_batched(state: BatchedMoshiState, schedule, frames):
    """Play the batched server's loop over a script.

    schedule: one dict per tick, {slot: "join" | "send"}.  "join" starts a
    new session on the slot (reset_slot, whose first-frame skip drops the
    frame sent with it) and sends its next frame; "send" sends the next
    frame; a slot not named has no audio ready and is frozen that tick.
    frames: {slot: float32 [n, frame_size]}, the PCM each slot sends, in
    order.  A tick where no slot executes runs no frame.

    Returns (sessions, ms): sessions[slot] holds one (tokens [generated
    frames, 1 + dep_q] int64, list of PCM frames) per session of the slot,
    and ms the host time of each batched frame, from handing its input to
    the device to reading its tokens and PCM back."""
    B, fs = state.batch_size, state.frame_size
    width = 1 + state.lm.config.dep_q
    taken = dict.fromkeys(frames, 0)
    sessions = {s: [] for s in range(B)}
    ms = []
    for tick in schedule:
        chunk = np.zeros((B, 1, fs), np.float32)
        mask = np.zeros(B, bool)
        for s, action in tick.items():
            if action == "join":
                state.reset_slot(s)
                sessions[s].append(([], []))
            elif action != "send":
                raise ValueError(f"tick action {action!r}")
            elif not sessions[s]:
                sessions[s].append(([], []))
            chunk[s, 0] = frames[s][taken[s]]
            taken[s] += 1
            if state.skip_frames[s] > 0:
                state.skip_frames[s] -= 1
                continue
            mask[s] = True
        if not mask.any():
            continue
        t0 = time.perf_counter()
        out, pcm = state.frame(chunk, mask)
        out_np, pcm_np = out.cpu().numpy(), pcm.cpu().numpy()
        ms.append((time.perf_counter() - t0) * 1e3)
        for s in np.nonzero(mask)[0]:
            if (out_np[s] == UNGENERATED_TOKEN).any():
                continue
            tokens, audio = sessions[s][-1]
            tokens.append(out_np[s, :, 0])
            audio.append(pcm_np[s, 0])
    return ({s: [(np.array(t, dtype=np.int64).reshape(-1, width), a) for t, a in sess]
             for s, sess in sessions.items()}, ms)



async def handle_chat(request, state: BatchedMoshiState):
    """aiohttp handler of the batched chat route."""
    from aiohttp import web

    ws = web.WebSocketResponse()
    await ws.prepare(request)
    CONNECT_COUNT.inc()
    query = dict(request.rel_url.query)
    want_resume = wants_resume(query)
    slot = await state.acquire_slot(query.get("resume"))
    if slot is None:
        await ws.close(code=1013, message=b"server full")
        return ws
    try:
        # everything after the acquire is under the try: a client gone
        # during the handshake still releases its slot
        from ..native import load
        codec = load()
        rate = state.mimi.config.sample_rate
        reader, writer = codec.OpusStreamReader(rate), codec.OpusStreamWriter(rate)
        await ws.send_bytes(proto.handshake())
        if want_resume:
            await ws.send_bytes(proto.msg(proto.MT_METADATA, json.dumps(
                {"resume_id": state.issue_resume_id(slot),
                 "resumed": state.slot_resumed.get(slot, False)}).encode()))
        await _chat_loop(ws, state, slot, reader, writer)
    finally:
        await state.release_slot(slot)
    return ws


async def _chat_loop(ws, state: BatchedMoshiState, slot: int, reader, writer):
    from aiohttp import WSMsgType

    async def sender():
        q = state.slot_queues[slot]
        while True:
            pcm, tokens = await q.get()
            data = writer.append_pcm(np.ascontiguousarray(pcm, np.float32))
            if data:
                await ws.send_bytes(proto.msg(proto.MT_AUDIO, data))
            text = int(tokens[0])
            if text not in (0, 3) and state.text_tokenizer is not None:
                piece = state.text_tokenizer.id_to_piece(text).replace("\u2581", " ")
                await ws.send_bytes(proto.msg(proto.MT_TEXT, piece.encode("utf-8")))

    send_task = asyncio.create_task(sender())
    paused = False
    try:
        async for message in ws:
            if message.type != WSMsgType.BINARY or not message.data:
                continue
            data = message.data
            kind = data[0]
            if kind == proto.MT_AUDIO:
                pcm = np.frombuffer(reader.append_bytes(data[1:]), np.float32)
                if pcm.size and not paused:
                    state.feed_pcm(slot, pcm)
            elif kind == proto.MT_CONTROL and len(data) >= 2:
                ctrl = data[1]
                if ctrl == proto.CTRL_PAUSE:
                    paused = True
                    state.slot_pcm[slot] = np.zeros((0,), np.float32)
                elif ctrl == proto.CTRL_START:
                    paused = False
                elif ctrl == proto.CTRL_RESTART:
                    # a fresh streaming state for this user only, before the
                    # next frame
                    state.pending_ops.append(("reset", slot))
                    state.slot_pcm[slot] = np.zeros((0,), np.float32)
                    paused = False
                    await ws.send_bytes(proto.msg(proto.MT_METADATA,
                                                  json.dumps({"event": "restarted"}).encode()))
            elif kind == proto.MT_PING:
                await ws.send_bytes(proto.msg(proto.MT_PING))
            elif kind == proto.MT_ERROR:
                await ws.close()
                break
            # other and unknown message types are discarded (protocol.md:32)
    finally:
        send_task.cancel()


def build_state(info, *, batch_size: int, device="cuda", kv_cache=None, context=None,
                mimi_dtype=None, text_tokenizer=None, rng_seed: int = 0) -> BatchedMoshiState:
    """A BatchedMoshiState over the checkpoint of `info` (a CheckpointInfo),
    its weights on `device`, the KV cache and codec knobs applied
    (utils/serving.py) and the checkpoint's lm_gen_config; not warmed up."""
    from ..utils.serving import apply_serving_overrides

    mimi, mimi_params = info.get_mimi(device=device)
    lm, lm_params = info.get_moshi(device=device)
    lm, lm_params, mimi_params, _ = apply_serving_overrides(
        lm, lm_params, mimi_params, kv_cache=kv_cache, context=context,
        mimi_dtype=mimi_dtype)
    return BatchedMoshiState(mimi, mimi_params, lm, lm_params, batch_size,
                             text_tokenizer=text_tokenizer, device=device, rng_seed=rng_seed,
                             **info.lm_gen_config)


def main(argv=None):
    import gc

    from aiohttp import web

    from ..models.loaders import CheckpointInfo
    from ..utils.serving import serving_device
    from .metrics import REGISTRY

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8998)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--kv-cache", default=None, choices=["model", "int8", "int4"],
                    help="the temporal transformer's KV cache dtype (int4 quarters it)")
    ap.add_argument("--mimi-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = serving_device(args.device)
    info = CheckpointInfo.from_dir(args.checkpoint_dir)
    state = build_state(info, batch_size=args.batch_size, device=device,
                        kv_cache=args.kv_cache, mimi_dtype=args.mimi_dtype,
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
    app.router.add_get("/api/chat", lambda req: handle_chat(req, state))
    app.router.add_get("/metrics", metrics)
    app.on_startup.append(on_startup)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
