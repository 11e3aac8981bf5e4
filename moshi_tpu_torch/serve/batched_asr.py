"""The batched speech-to-text engine (counterpart of the engine half of
moshi_tpu/serve/batched_asr.py): B slots, one user each, stepped together
one 80 ms frame at a time by `BatchedAsrState.tick`.

Each slot has an audio backlog, an outbox of protocol messages (the dicts
the websocket server sends: Word, EndWord, Step, Marker) and a list of
pending markers.  A Word's "text" is the engine's decoding of the word
(StreamingASR's `text_tokenizer`; "" without one), as in the reference
protocol.  A tick applies the queued slot ops (reset, snapshot, restore),
runs one frame over the slots whose backlog holds a whole frame (the
others are frozen by the exec mask), dispatches the engine's messages to
the slots' outboxes and flushes the markers that are due.  On a CUDA
device the frame runs as replays of StreamingASR's two graphs; `warmup()`
comes first.

Session resume: a session given a resume id (`issue_resume_id`) leaves a
snapshot when its slot is released: its host word state, its undelivered
messages, unprocessed audio and pending markers, and its device rows
moved to host memory (as the JAX package's store offloads them).  A later
`acquire_slot(resume=id)` on any slot restores it in place of a reset.
The store is a dict without expiry; the websocket/msgpack handlers, the
asyncio loop and the store's TTL, cap and wire format are not ported yet.
`serve_asr` plays the loop's role over a scripted schedule of PCM frames.
"""

import copy
import secrets
import time

import numpy as np

from ..models.asr import AsrEndWord, AsrStep, AsrWord
from ..utils.trees import to_device


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
        # queued slot ops, applied in order at the start of the next tick:
        # ("reset", slot), ("snapshot", slot, resume id, leftovers),
        # ("restore", slot, item, device rows)
        self.pending_ops: list[tuple] = []
        self.slot_resume_id: dict[int, str] = {}
        self.slot_resumed: dict[int, bool] = {}
        self.snapshots: dict[str, tuple] = {}  # resume id -> (device rows on the host, meta)
        self.frame_ms = 0.0  # host ms of the last tick's frame

    def warmup(self):
        """StreamingASR.warmup on this engine's state; a graphed engine needs
        it before its first tick."""
        self.asr.warmup(self.mimi_params, self.lm_params, self.state)

    def issue_resume_id(self, slot: int) -> str:
        """Let the session on `slot` leave a snapshot when it is released;
        the id opens it again."""
        rid = secrets.token_hex(8)
        self.slot_resume_id[slot] = rid
        return rid

    def acquire_slot(self, slot: int | None = None, resume: str | None = None) -> int | None:
        """Open a session: on `slot`, or on a free slot of the server's
        choosing (None when the batch is full).  With the id of a snapshot,
        the session goes on from it (restored at the start of the next
        tick; its leftovers are back in the slot's backlog, outbox and
        markers), else it starts fresh (reset then); `slot_resumed` says
        which."""
        if slot is None:
            if not self.slots_free:
                return None
            slot = self.slots_free.pop()
        else:
            self.slots_free.remove(slot)
        if resume is not None and any(op[0] == "snapshot" and op[2] == resume
                                      for op in self.pending_ops):
            self._apply_ops()  # the session left since the last tick
        snap = self.snapshots.pop(resume, None) if resume is not None else None
        if snap is None:
            self.slot_pcm[slot] = np.zeros((0,), np.float32)
            self.slot_outbox[slot] = []
            self.slot_markers[slot] = []
            self.pending_ops.append(("reset", slot))
        else:
            arrays, meta = snap
            self.slot_pcm[slot] = meta["pcm"]
            self.slot_outbox[slot] = meta["msgs"]
            self.slot_markers[slot] = meta["markers"]
            self.pending_ops.append(("restore", slot, meta["item"], arrays))
        self.slot_resumed[slot] = snap is not None
        return slot

    def release_slot(self, slot: int):
        """Close the session on `slot`.  With a resume id, what it has not
        been sent, its unprocessed audio and its pending markers go into its
        snapshot (taken at the start of the next tick); without one they are
        dropped."""
        rid = self.slot_resume_id.pop(slot, None)
        leftovers = {"pcm": self.slot_pcm.pop(slot), "markers": self.slot_markers.pop(slot),
                     "msgs": self.slot_outbox.pop(slot)}
        if rid is not None:
            self.pending_ops.append(("snapshot", slot, rid, leftovers))
        self.slot_resumed.pop(slot, None)
        self.slots_free.append(slot)

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
                rows = to_device(asr.extract_slot_arrays(state, slot), "cpu")
                self.snapshots[rid] = (rows, {"item": copy.deepcopy(asr.items[slot]),
                                              **leftovers})
            else:
                _, slot, item, rows = op
                asr.items[slot] = item
                asr.restore_slot_arrays(state, rows, slot)

    def tick(self) -> np.ndarray | None:
        """One turn of the server's loop: apply the queued slot ops, then one
        frame over the slots holding a whole frame of audio.  Returns the
        frame's exec mask [B] bool, or None when no slot was ready."""
        self._apply_ops()
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
        t0 = time.perf_counter()
        msgs, self.state = self.asr.step_pcm(self.mimi_params, self.lm_params, self.state,
                                             chunk, mask)
        for m in msgs:
            self._dispatch(m, mask)
        self._flush_markers()
        self.frame_ms = (time.perf_counter() - t0) * 1e3
        return mask

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
                state.release_slot(s)
                continue
            if action == "join" or (isinstance(action, tuple) and action[0] == "resume"):
                if s in state.slot_outbox:   # the outbox was emptied after the last tick
                    state.release_slot(s)
                state.acquire_slot(s, None if action == "join" else left.pop(action[1]))
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
