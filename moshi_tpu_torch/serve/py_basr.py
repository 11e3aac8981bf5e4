"""User-python batched ASR module ("PyBatchedAsr"): a copy of
moshi_tpu/serve/py_basr.py (which imports no JAX) over the port's metrics
and `batched_asr.handle_asr_socket`.

Behavioral reference: `rust/moshi-server/src/py_basr_module.rs` (650 LoC) +
the flag contract of `py_module.rs:16-21` / the embedded default script
`rust/moshi-server/batched_asr.py`:

- a user script defines `init(batch_size, config) -> app`; every batch frame
  the server calls `app.step(batch_pcm, flags_out, tokens_out, extra_heads,
  updates)` where
    batch_pcm   f32 [B*1920]  input pcm, one frame per slot;
    flags_out   u8  [B]       OUT: per-slot mask the script writes —
                              ACTIVE=1, MARKER_RECEIVED=2, END_OF_STREAM=4;
    tokens_out  u32 [B]       OUT: one text token per slot;
    extra_heads f32 [B, 4]    OUT: per-slot extra-head probabilities;
    updates     list[int]     per-slot control: NODATA=0, ACTIVE=-1,
                              RESET=-2, >0 = marker received with that many
                              frames still buffered (py_basr_module.rs:27-29,
                              164-170);
- the SERVER assembles words from the token stream (0/3 end a word ->
  Word{tokens decoded, start_time=start_step/12.5} + EndWord{stop_time=
  steps/12.5}, py_basr_module.rs:283-316) and emits Step messages with the
  extra-head rows; markers echo once `step_idx + asr_delay_in_tokens +
  buffered` has passed (py_basr_module.rs:163-170, 400-412);
- the wire protocol is the same msgpack ASR protocol as BatchedAsr
  (`asr.rs:15-33`), so the websocket side is shared with
  `serve/batched_asr.handle_asr_socket`.
"""

import asyncio
import time
from pathlib import Path

import numpy as np

from .metrics import MODEL_STEP_DURATION, OPEN_CHANNELS, TOTAL_STEPS

FRAME_SIZE = 1920  # py_basr_module.rs:19 (24 kHz / 12.5 Hz)
FRAME_RATE = 12.5

# updates control values (py_basr_module.rs:27-29)
NODATA, ACTIVE, RESET = 0, -1, -2
# flags_out bits (py_basr_module.rs:23-25)
MASK_ACTIVE = 1 << 0
MASK_MARKER_RECEIVED = 1 << 1
MASK_END_OF_STREAM = 1 << 2


class _Facade:
    """Just enough of StreamingASR's surface for handle_asr_socket."""

    def __init__(self, batch_size, sample_rate=24000):
        self.batch_size = batch_size
        import types
        self.mimi = types.SimpleNamespace(
            sample_rate=sample_rate,
            config=types.SimpleNamespace(sample_rate=sample_rate))


class PyBatchedAsrState:
    """Duck-types the slice of BatchedAsrState that handle_asr_socket uses
    (acquire/release_slot, feed_pcm, add_marker, slot_queues); the model
    step is the user app instead of a StreamingASR.  Session resume
    is not offered (the user script owns the model state)."""

    MAX_BUFFERED_SECONDS = 30.0

    def __init__(self, app, batch_size: int, asr_delay_in_tokens: int,
                 text_tokenizer=None, num_extra_heads: int = 4):
        self.app = app
        self.batch_size = batch_size
        self.asr_delay_in_tokens = asr_delay_in_tokens
        self.text_tokenizer = text_tokenizer
        self.asr = _Facade(batch_size)
        B = batch_size
        self.slots_free = list(range(B))
        self.slot_queues: dict[int, asyncio.Queue] = {}
        self.slot_pcm: dict[int, np.ndarray] = {}
        self.slot_markers: dict[int, list] = {}  # [(due_step, id)] FIFO
        self.slot_resumed: dict[int, bool] = {}
        self.pending_updates: dict[int, int] = {}  # RESET / marker counts
        self.step_idx = 0
        self.steps = [0] * B            # per-slot step clocks
        self.current_word = [[] for _ in range(B)]
        self.word_start_step = [0] * B
        self.lock = asyncio.Lock()
        self._flags = np.zeros((B,), np.uint8)
        self._tokens = np.zeros((B,), np.uint32)
        self._extra = np.zeros((B, num_extra_heads), np.float32)
        self._pcm = np.zeros((B * FRAME_SIZE,), np.float32)

    # ---------------------------------------------------------- slot mgmt
    async def acquire_slot(self, resume: str | None = None) -> int | None:
        async with self.lock:
            if not self.slots_free:
                return None
            slot = self.slots_free.pop()
            self.slot_queues[slot] = asyncio.Queue()
            self.slot_pcm[slot] = np.zeros((0,), np.float32)
            self.slot_markers[slot] = []
            self.pending_updates[slot] = RESET  # rust InMsg::Init path
            self.slot_resumed[slot] = False
            self.steps[slot] = 0
            self.current_word[slot] = []
            self.word_start_step[slot] = 0
            OPEN_CHANNELS.inc()
            return slot

    def issue_resume_id(self, slot: int) -> str:  # resume unsupported here
        return ""

    async def release_slot(self, slot: int):
        async with self.lock:
            self.slot_queues.pop(slot, None)
            self.slot_pcm.pop(slot, None)
            self.slot_markers.pop(slot, None)
            self.pending_updates.pop(slot, None)
            self.slot_resumed.pop(slot, None)
            self.slots_free.append(slot)
            OPEN_CHANNELS.dec()

    def feed_pcm(self, slot: int, pcm: np.ndarray) -> bool:
        cap = int(self.MAX_BUFFERED_SECONDS * 24000)
        buf = self.slot_pcm[slot]
        if buf.shape[-1] + pcm.shape[-1] > cap:
            pcm = pcm[:max(0, cap - buf.shape[-1])]
            self.slot_pcm[slot] = np.concatenate([buf, pcm])
            return False
        self.slot_pcm[slot] = np.concatenate([buf, pcm])
        return True

    def add_marker(self, slot: int, marker_id: int):
        buffered = self.slot_pcm.get(slot, np.zeros(0)).shape[-1] // FRAME_SIZE
        due = self.step_idx + self.asr_delay_in_tokens + buffered
        self.slot_markers.setdefault(slot, []).append((due, int(marker_id)))
        # the script learns about the marker through a positive update
        # (py_basr_module.rs:166: update = buffered frame count)
        if self.pending_updates.get(slot, NODATA) == NODATA:
            self.pending_updates[slot] = max(1, buffered)

    # ----------------------------------------------------------- the loop
    async def run_loop(self):
        import traceback
        try:
            await self._run_loop()
        except asyncio.CancelledError:
            raise
        except Exception:
            traceback.print_exc()
            raise

    async def _run_loop(self):
        B = self.batch_size
        while True:
            updates = [NODATA] * B
            any_data = False
            for s in list(self.slot_queues):
                pend = self.pending_updates.get(s, NODATA)
                if pend != NODATA:
                    # control updates (RESET / marker count) take this
                    # frame; audio resumes next frame (rust: one InMsg per
                    # pre_process call)
                    updates[s] = pend
                    self.pending_updates[s] = NODATA
                    any_data = True
                    continue
                buf = self.slot_pcm.get(s)
                if buf is not None and buf.shape[-1] >= FRAME_SIZE:
                    self._pcm[s * FRAME_SIZE:(s + 1) * FRAME_SIZE] = \
                        buf[:FRAME_SIZE]
                    self.slot_pcm[s] = buf[FRAME_SIZE:]
                    updates[s] = ACTIVE
                    any_data = True
            if not any_data:
                await asyncio.sleep(0.005)
                continue
            t0 = time.perf_counter()
            # the user app may sync a device — keep the event loop free
            await asyncio.to_thread(
                self.app.step, self._pcm, self._flags, self._tokens,
                self._extra, updates)
            MODEL_STEP_DURATION.observe(time.perf_counter() - t0)
            TOTAL_STEPS.inc()
            self._post_process()
            self.step_idx += 1
            await asyncio.sleep(0)

    def _post_process(self):
        """Word assembly + Step/Marker emission (py_basr_module.rs:283-412)."""
        for s in list(self.slot_queues):
            flags = int(self._flags[s])
            if flags & (MASK_ACTIVE | MASK_MARKER_RECEIVED):
                self.steps[s] += 1
                token = int(self._tokens[s])
                if token in (0, 3):  # pad/epad end the current word
                    if self.current_word[s]:
                        ids = self.current_word[s]
                        self.current_word[s] = []
                        text = (self.text_tokenizer.decode(ids)
                                if self.text_tokenizer else "")
                        self._send(s, {
                            "type": "Word", "text": text,
                            "start_time": self.word_start_step[s] / FRAME_RATE})
                        self._send(s, {
                            "type": "EndWord",
                            "stop_time": self.steps[s] / FRAME_RATE})
                else:
                    if not self.current_word[s]:
                        self.word_start_step[s] = self.steps[s]
                    self.current_word[s].append(token)
                self._send(s, {
                    "type": "Step", "step_idx": self.step_idx,
                    "prs": [float(p) for p in self._extra[s]],
                    "buffered_pcm": int(self.slot_pcm.get(
                        s, np.zeros(0)).shape[-1]),
                })
            elif flags & MASK_END_OF_STREAM:
                self.current_word[s] = []
        for s, markers in self.slot_markers.items():
            while markers and markers[0][0] <= self.step_idx:
                _, marker_id = markers.pop(0)
                self._send(s, {"type": "Marker", "id": marker_id})

    def _send(self, slot: int, payload: dict):
        q = self.slot_queues.get(slot)
        if q is not None:
            q.put_nowait(payload)


def build_py_batched_asr(name: str, mcfg: dict):
    """Worker factory for `type = "py_batched_asr"` (reference tag
    "PyBatchedAsr", main.rs:173-177 PyAsrConfig: script, batch_size,
    text_tokenizer_file, asr_delay_in_tokens, [py] table).  The info
    holds the state too, as the port's other modules' do (the worker's
    /api/modules_info leaves it out)."""
    import importlib.util
    from .batched_asr import handle_asr_socket

    route = mcfg["route"]
    if "script" not in mcfg:
        raise ValueError(
            f"module {name}: py_batched_asr requires `script` (the rust "
            "worker embeds a default batched_asr.py; supply your own here)")
    script = Path(mcfg["script"])
    spec = importlib.util.spec_from_file_location(
        f"moshi_tpu_torch_py_basr_{name}", script)
    if spec is None or spec.loader is None:
        raise ValueError(f"module {name}: cannot load script {script}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "init"):
        raise ValueError(f"module {name}: {script} defines no init()")
    batch_size = int(mcfg["batch_size"])
    app = mod.init(batch_size, dict(mcfg.get("config", {})))
    if hasattr(app, "warmup"):
        app.warmup()

    tokenizer = None
    tok_path = mcfg.get("text_tokenizer_file")
    if tok_path and Path(tok_path).exists():
        from ..text.spm import SentencePieceTokenizer
        tokenizer = SentencePieceTokenizer(tok_path)

    state = PyBatchedAsrState(app, batch_size,
                              int(mcfg["asr_delay_in_tokens"]),
                              text_tokenizer=tokenizer)

    async def startup():
        return asyncio.create_task(state.run_loop())

    return route, (lambda req: handle_asr_socket(req, state)), startup, \
        {"type": "py_batched_asr", "script": str(script),
         "batch_size": batch_size, "state": state}
