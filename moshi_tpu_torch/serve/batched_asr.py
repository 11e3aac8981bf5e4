"""The batched speech-to-text engine (counterpart of the engine half of
moshi_tpu/serve/batched_asr.py): B slots, one user each, stepped together
one 80 ms frame at a time by `BatchedAsrState.tick`.

Each slot has an audio backlog, an outbox of protocol messages (the dicts
the websocket server sends: Word, EndWord, Step, Marker) and a list of
pending markers.  A Word's "text" is the engine's decoding of the word
(StreamingASR's `text_tokenizer`; "" without one), as in the reference
protocol.  A tick applies the queued slot resets, runs one frame over the
slots whose backlog holds a whole frame (the others are frozen by the exec
mask), dispatches the engine's messages to the slots' outboxes and flushes
the markers that are due.

The websocket/msgpack handlers, the asyncio loop and session resume
(snapshots) are not ported yet; `serve_asr` plays the loop's role over a
scripted schedule of PCM frames.
"""

import time

import numpy as np

from ..models.asr import AsrEndWord, AsrStep, AsrWord


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
        self.pending_resets: list[int] = []
        self.frame_ms = 0.0  # host ms of the last tick's frame

    def acquire_slot(self, slot: int | None = None) -> int | None:
        """Open a session: on `slot`, or on a free slot of the server's
        choosing (None when the batch is full).  Its reset runs at the start
        of the next tick."""
        if slot is None:
            if not self.slots_free:
                return None
            slot = self.slots_free.pop()
        else:
            self.slots_free.remove(slot)
        self.slot_pcm[slot] = np.zeros((0,), np.float32)
        self.slot_outbox[slot] = []
        self.slot_markers[slot] = []
        self.pending_resets.append(slot)
        return slot

    def release_slot(self, slot: int):
        """Close the session on `slot`, dropping what it has not been sent."""
        for per_slot in (self.slot_pcm, self.slot_markers, self.slot_outbox):
            del per_slot[slot]
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

    def tick(self) -> np.ndarray | None:
        """One turn of the server's loop: apply the queued resets, then one
        frame over the slots holding a whole frame of audio.  Returns the
        frame's exec mask [B] bool, or None when no slot was ready."""
        while self.pending_resets:
            self.state = self.asr.reset_batch_idx(self.state, self.pending_resets.pop(0))
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

    schedule: one dict per tick, {slot: "join" | "send"}.  "join" opens a
    new session on the slot (closing the one before) and feeds its next
    frame; "send" feeds the slot's next frame; a slot not named sends
    nothing and is frozen that tick.  Then one tick runs.  frames: {slot:
    float32 [n, frame_size]}, the PCM each slot sends, in order.

    Returns (sessions, ms): sessions[slot] holds one (text tokens [executed
    frames] int64, messages) per session of the slot, and ms the host time
    of each batched frame, from handing its audio to the device to the
    messages dispatched."""
    taken = dict.fromkeys(frames, 0)
    sessions = {s: [] for s in range(state.batch_size)}
    ms = []

    for tick in schedule:
        for s, action in tick.items():
            if action == "join":
                if s in state.slot_outbox:   # the outbox was emptied after the last tick
                    state.release_slot(s)
                state.acquire_slot(s)
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
