"""The batched text-to-speech server (counterpart of
moshi_tpu/serve/batched_tts.py): B slots, one client each, stepped together
one 80 ms frame at a time, each slot with its own DSM state machine, word
queue and frame offset.

A slot whose words have run out (and whose client has not said it is done)
is starved: it pauses, frozen by the exec mask, instead of padding.  Slot
ops (reset, voice change, snapshot, restore) are queued (`pending_ops`)
and applied in place between frames.  A slot's voice conditions the LM
through cross-attention: the engine keeps one cross K/V pair [L, B_model,
Ts, H, D] and rewrites it in place on every voice change; voiceless slots
among voiced ones take the null condition.  While no slot has a voice the
frame runs without the cross block, as the JAX package's does when its
state holds no cross K/V.

A frame is graph 1 (scatter, the temporal step, text sampling), the slots'
state machines on the host, then graph 2 (depformer, commit, Mimi
decode): the JAX package's two jitted programs.  On a CUDA device both run
as CUDA-graph replays (graph 1 once for each mode, with and without the
cross block) over static token, mask, zero-mask and decode-mask buffers;
`warmup()` comes first (and `capture()` when other engines' threads share
the card), and an engine whose slots take voices needs `voice_frames`
(the frames of one speaker embedding) to size the cross K/V before it.
`graphed=False` runs the same functions eagerly (the CPU's only path).

The transport: each websocket session (`handle_batched_tts_socket`, the
JAX package's protocol: JSON "Text" / "Voice" / "Eos" in; b"\\x01" +
ogg-opus audio, JSON "Text" word events with `start_s`, "Error" and "Eos"
out) holds a slot through the async `acquire_slot` / `release_slot`; the
frames' events and PCM go from the slot's outbox to the session's
asyncio queue.  `run_loop`, the shared loop, applies the queued ops on
the event loop's thread and runs each frame on a worker thread.  Session
resume (`?resume_support=1`, then `?resume=<id>`): a session that leaves
with a resume id leaves its DSM state, its undelivered items and its
slot's rows of the LM's and the decoder's streaming state (moved to host
memory, serve/snapshots.py); a later session goes on from them on any
slot, written back in place.  The cross K/V are not in a snapshot: a
restore rebuilds them from the slot's voice.

`serve_tts` plays the loop's role over a script, with no socket, through
the synchronous `open_slot` / `close_slot` / `tick`.

One deliberate difference from the JAX package: on a CFG-distilled model
`load_tts` gives `cfg_coef` to the voices as their `cfg` condition and
leaves the model batch undoubled (what `TTSModel.simple_generate` does in
both packages), where the JAX package's engine runs true CFG on a doubled
batch and leaves the voices' `cfg` to its padding.  On a model without
that condition, true CFG runs B slots as 2B model rows through the same
two graphs; the int8 linears take any row count (16-row `int8_mma` chunks
above 16, ops/qmatmul.py).
"""

import asyncio
import collections
import json
import time
import traceback

import numpy as np
import torch

from ..conditioners import dropout_all_conditions
from ..models.lm import UNGENERATED_TOKEN, ZERO_TOKEN
from ..models.lm_gen import LMGen, LMGenConfig
from ..models.tts import Entry
from ..utils.graphs import GraphedStep, run_on_device
from ..utils.trees import masked_reset, put_slots, state_batch_axes, take_slots
from .metrics import CONNECT_COUNT, MODEL_STEP_DURATION, OPEN_CHANNELS, TOTAL_STEPS
from .snapshots import (RidRegistry, SnapshotStore, await_pending_release, new_resume_id,
                        wants_resume)

_GEN_KEYS = ("cache", "offsets", "text_history", "hist_pos")  # LMGen's per-slot rows


class _TtsSlot:
    def __init__(self, machine):
        self.state = machine.new_state([])
        self.offset = 0
        self.eos = False
        self.done = False
        self.outbox: list = []  # ("event", dict) | ("pcm", [frame_size]) | ("eos", None)


class BatchedTTSState:
    """B TTS slots of `tts` (a models/tts.py TTSModel) on `device`.  The
    codec runs in the dtype of its parameters; the LM's KV cache follows its
    config, in bf16 for a model-dtype cache.  With temp > 0 the draws come
    from the engine's generator, seeded with `rng_seed`.  `cfg_condition`,
    for a CFG-distilled model, is the coefficient its voices' `cfg`
    condition carries (None: the condition's padding)."""

    def __init__(self, tts, lm_params, mimi_params, batch_size: int, *,
                 condition_params: dict | None = None, voice_frames: int | None = None,
                 device="cuda", graphed: bool | None = None, rng_seed: int = 0,
                 cfg_condition: float | None = None):
        self.tts = tts
        self.cfg_condition = cfg_condition
        self.lm_params, self.mimi_params = lm_params, mimi_params
        self.cp_params = condition_params
        self.batch_size = B = batch_size
        self.device = dev = torch.device(device)
        self.graphed = dev.type == "cuda" if graphed is None else graphed
        if self.graphed and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        lm, mimi = tts.lm, tts.mimi
        c = lm.config
        self.mimi_dtype = md = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        self.machine = tts.machine
        self.gen = LMGen(lm, LMGenConfig(
            use_sampling=tts.temp > 0.0, temp=tts.temp, temp_text=tts.temp,
            cfg_coef=tts.cfg_coef, padding_bonus=tts.padding_bonus))
        self.mult = self.gen.model_batch_mult
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(rng_seed)
        self.gen_state = self.gen.init_state(B, self.generator, torch.bfloat16, dev)
        self.dec_state = mimi.init_decode_state(B, md, dev)
        self.voice_frames = voice_frames
        # conditioning, written in place on a voice change: the summed
        # condition [B_model, 1, dim], and the cross K/V inside the state
        # view the cross mode's graph steps
        self.cond_sum = None
        self.gen_state_cross = None
        self.slot_attrs: list = [None] * B
        # the graphs' static inputs
        self.input_tokens = torch.full((B, max(c.num_codebooks - c.dep_q - 1, 1), 1),
                                       ZERO_TOKEN, dtype=torch.long, device=dev)
        self.mask_in = torch.ones(B, dtype=torch.bool, device=dev)
        self.text_in = torch.zeros(B, dtype=torch.long, device=dev)
        self.zero_in = torch.zeros((B, c.dep_q), dtype=torch.bool, device=dev)
        self.dec_in = torch.zeros(B, dtype=torch.bool, device=dev)
        self.h = torch.zeros((B * self.mult, 1, c.dim), dtype=lm_params["text_emb"]["weight"]
                             .dtype, device=dev)
        gens = (self.generator,)
        # graph 1 by mode: unconditioned, conditioned (the cross block)
        self.main = {mode: GraphedStep(self._main, graphed=self.graphed, device=dev,
                                       generators=gens) for mode in (False, True)}
        self.depth = GraphedStep(self._depth_decode, graphed=self.graphed, device=dev,
                                 generators=gens)
        self._gen_delays = np.asarray(c.delays[c.audio_offset:c.audio_offset + c.dep_q])
        self._valid_after = max(self.gen.max_delay, tts.delay_steps)
        self.slots: list[_TtsSlot | None] = [None] * B
        # ("reset", slot), ("voice", slot, embedding [1, T, D]), ("snapshot",
        # slot, resume id, session, its attributes) and ("restore", slot,
        # rows, attributes), applied in order between frames; a slot stays
        # out of the frames until its reset or restore has applied
        self.pending_ops: list[tuple] = []
        self.unready: set[int] = set()
        # the transport: each session's queue, filled from its outbox; resume
        self.slot_queues: dict[int, asyncio.Queue] = {}
        self.slot_resume_id = RidRegistry()
        self.slot_resumed: dict[int, bool] = {}
        self.snapshots = SnapshotStore(ttl=60.0, cap=max(8, B))
        self.lock = asyncio.Lock()
        # run_loop's frames, host ms each (what MODEL_STEP_DURATION observes),
        # and the host ms of each turn that applied queued slot ops
        self.frame_times = collections.deque(maxlen=10_000)
        self.ops_times = collections.deque(maxlen=10_000)
        # host ms of the last tick's parts: the queued ops ("ops"), graph 1
        # and graph 2 each up to its outputs read back ("main", "depth"), the
        # state machines between them ("machines")
        self.frame_ms = dict.fromkeys(("ops", "main", "machines", "depth"), 0.0)
        self.warm_modes = None  # the modes of graph 1 warmup() warmed
        # exact per-leaf batch axes: a shape rule mistakes the layer axis of
        # a [L, B, ...] cache for the batch axis when B == L
        self._ax_gen = state_batch_axes(
            lambda b, d: self.gen.init_state(b, None, torch.bfloat16, d))
        self._ax_tr = state_batch_axes(
            lambda b, d: lm.transformer.init_state(b, torch.bfloat16, d))
        self._ax_dec = state_batch_axes(lambda b, d: mimi.init_decode_state(b, md, d))

    @property
    def conditioned(self) -> bool:
        """Whether some slot has a voice: the frame then runs the
        conditioned mode (cross block, summed condition)."""
        return any(a is not None for a in self.slot_attrs)

    # ------------------------------------------------------------- device part
    def _main(self, lm_params, gen_state, input_tokens, exec_mask, cond_sum, h_out):
        """Graph 1: the temporal step and the text token's choice; h goes
        into h_out for graph 2.  Returns the sampled text tokens [B]."""
        text_token, _, h = self.gen.main_step(lm_params, gen_state, input_tokens, exec_mask,
                                              cond_sum)
        h_out.copy_(h)
        return text_token

    def _depth_decode(self, lm_params, mimi_params, gen_state, dec_state, text_token, h,
                      exec_mask, zero_mask, dec_mask):
        """Graph 2: depformer, audio zeroing, commit, Mimi decode of the
        slots in dec_mask.  Returns (out [B, 1 + dep_q, 1], pcm [B, 1,
        frame_size] f32)."""
        out = self.gen.depth_step(lm_params, gen_state, text_token, h, exec_mask, None,
                                  zero_mask)
        codes = out[:, 1:self.tts.n_q + 1, :].clamp(min=0)
        pcm, _ = self.tts.mimi.decode_step(mimi_params, dec_state, codes, dec_mask)
        return out, pcm.float()

    def _frame_args(self, conditioned: bool):
        cross = conditioned and self.gen_state_cross is not None
        state = self.gen_state_cross if cross else self.gen_state
        main = (self.lm_params, state, self.input_tokens, self.mask_in,
                self.cond_sum if conditioned else None, self.h)
        depth = (self.lm_params, self.mimi_params, self.gen_state, self.dec_state,
                 self.text_in, self.h, self.mask_in, self.zero_in, self.dec_in)
        return main, depth

    def warmup(self):
        """Two frames of every slot in each mode the engine can run (the
        conditioned one needs voice_frames), eagerly, on the graphs' side
        streams when graphed; then every slot reset.  A graphed engine needs
        it before its first frame."""
        modes = [False]
        if self._takes_voices() and self.voice_frames is not None:
            self._write_conditions([self._null_attrs()] * self.batch_size)
            modes.append(True)
        self.mask_in.fill_(True)
        self.dec_in.fill_(True)
        for conditioned in modes:
            main, depth = self._frame_args(conditioned)
            for _ in range(2):
                self.main[conditioned].warm_up(*main)
                self.depth.warm_up(*depth)
        self.warm_modes = modes
        self._reset(np.ones(self.batch_size, bool))

    def capture(self):
        """Capture the graphs now (graph 1 in each mode warmup() warmed, then
        graph 2), with one frame in which every slot is frozen, then reset
        every slot: a server whose card other engines' threads use captures
        nothing while serving.  Eager engines do nothing."""
        if not self.graphed:
            return
        for t in (self.mask_in, self.dec_in, self.zero_in):
            t.fill_(False)
        self.text_in.zero_()
        for conditioned in self.warm_modes:
            main, depth = self._frame_args(conditioned)
            self.main[conditioned](*main)
        self.depth(*depth)
        self._reset(np.ones(self.batch_size, bool))

    # --------------------------------------------------------------- slot ops
    def open_slot(self, slot: int | None = None, resume: str | None = None,
                  snapshot=None) -> int | None:
        """Open a session: on `slot`, or on the first free slot (None when
        the batch is full).  With the id of a snapshot (or the snapshot
        itself) the session goes on from it (its rows restored before the
        next frame, its undelivered items back in its outbox, an "eos" added
        when it had ended), else it starts fresh (reset then);
        `slot_resumed` says which."""
        if slot is None:
            slot = next((b for b, s in enumerate(self.slots) if s is None), None)
            if slot is None:
                return None
        elif self.slots[slot] is not None:
            raise ValueError(f"slot {slot} is taken")
        if snapshot is None and resume is not None:
            if any(op[0] == "snapshot" and op[2] == resume for op in self.pending_ops):
                self.apply_pending_ops()  # the session left since the last frame
            snapshot = self.snapshots.pop(resume)
        self.unready.add(slot)
        if snapshot is None:
            self.pending_ops.append(("reset", slot))
            self.slots[slot] = _TtsSlot(self.machine)
        else:
            rows, meta = snapshot
            s = meta["slot"]
            if s.done and not any(kind == "eos" for kind, _ in s.outbox):
                s.outbox.append(("eos", None))
            self.pending_ops.append(("restore", slot, rows, meta["attrs"]))
            self.slots[slot] = s
        self.slot_resumed[slot] = snapshot is not None
        return slot

    def close_slot(self, slot: int):
        """Close the session on `slot`; its queued voice changes are dropped,
        so they cannot reach the slot's next session.  With a resume id its
        snapshot is taken before the next frame."""
        s = self.slots[slot]
        if s is None:
            return
        self.pending_ops = [op for op in self.pending_ops
                            if not (op[0] == "voice" and op[1] == slot)]
        rid = self.slot_resume_id.pop(slot, None)
        if rid is not None:
            self.pending_ops.append(("snapshot", slot, rid, s, self.slot_attrs[slot]))
        self.slots[slot] = None
        self.slot_resumed.pop(slot, None)

    def issue_resume_id(self, slot: int) -> str:
        """Let the session on `slot` leave a snapshot when it is closed; the
        id opens it again."""
        rid = new_resume_id()
        self.slot_resume_id[slot] = rid
        return rid

    def snapshot_slot(self, slot: int):
        """Slot `slot`'s rows of LMGen's per-slot state (CFG's null rows
        too) and of the decoder's, each at batch size 1 (copies); the cross
        K/V are left out."""
        idx, idx_m = [slot], [slot + i * self.batch_size for i in range(self.mult)]
        gen = {key: take_slots(self.gen_state[key], idx, self._ax_gen[key])
               for key in _GEN_KEYS if key in self.gen_state}
        tr = self.gen_state["transformer"]
        gen["transformer"] = take_slots({k: tr[k] for k in self._ax_tr}, idx_m, self._ax_tr)
        return gen, take_slots(self.dec_state, idx, self._ax_dec)

    def restore_slot(self, slot: int, rows):
        """Write rows from snapshot_slot (on any device) into slot `slot`, in
        place."""
        gen, dec = rows
        idx, idx_m = [slot], [slot + i * self.batch_size for i in range(self.mult)]
        for key, v in gen.items():
            if key == "transformer":
                tr = self.gen_state["transformer"]
                put_slots({k: tr[k] for k in v}, v, idx_m, self._ax_tr)
            else:
                put_slots(self.gen_state[key], v, idx, self._ax_gen[key])
        put_slots(self.dec_state, dec, idx, self._ax_dec)

    def set_slot_voice(self, slot: int, voice_embedding: np.ndarray):
        """The voice of `slot`: a speaker embedding [voice_frames, D], queued
        for the start of the next tick.  An engine made without voice_frames
        takes the first voice's frames.  A voice of another shape raises
        here, before anything is queued: the cross K/V are sized once."""
        if not self._takes_voices():
            return
        emb = np.asarray(voice_embedding, np.float32)
        if self.graphed and self.warm_modes is not None and True not in self.warm_modes:
            raise ValueError("this graphed engine was warmed up without voice_frames: it "
                             "takes no voice")
        if self.voice_frames is None and emb.ndim == 2:
            self.voice_frames = emb.shape[0]
        want = (self.voice_frames, self._voice_dim())
        if emb.shape != want:
            raise ValueError(f"a voice of shape {emb.shape} for an engine whose voices are "
                             f"{want} (voice_frames x the speaker embedding's width)")
        self.pending_ops.append(("voice", slot, emb[None]))

    def apply_pending_ops(self):
        """Apply the queued slot ops in order, in place (no frame is in
        flight between ticks).  The conditions are a function of the slots'
        attributes alone, so they are recomputed once, after the last op,
        however many voices changed."""
        changed = False
        while self.pending_ops:
            op = self.pending_ops.pop(0)
            if op[0] == "reset":
                changed |= self._reset_slot(op[1])
                self.unready.discard(op[1])
            elif op[0] == "voice":
                _, slot, emb = op
                self.slot_attrs[slot] = self.tts.make_condition_attributes(
                    [emb], self.cfg_condition)
                changed = True
            elif op[0] == "snapshot":
                _, slot, rid, session, attrs = op
                self.snapshots.put(rid, self.snapshot_slot(slot),
                                   {"slot": session, "attrs": attrs})
            else:
                _, slot, rows, attrs = op
                self.restore_slot(slot, rows)
                changed |= attrs is not None or self.slot_attrs[slot] is not None
                self.slot_attrs[slot] = attrs
                self.unready.discard(slot)
        if changed:
            self._recompute_conditioning()

    def _reset(self, mask: np.ndarray):
        dev = self.device
        fresh = self.gen.init_state(1, None, torch.bfloat16, dev)
        for key in _GEN_KEYS:
            if key in self.gen_state:
                masked_reset(self.gen_state[key], fresh[key], mask, self._ax_gen[key])
        tr = self.gen_state["transformer"]
        tr_fresh = self.tts.lm.transformer.init_state(1, torch.bfloat16, dev)
        masked_reset({k: tr[k] for k in tr_fresh}, tr_fresh, np.tile(mask, self.mult),
                     self._ax_tr)
        masked_reset(self.dec_state, self.tts.mimi.init_decode_state(1, self.mimi_dtype, dev),
                     mask, self._ax_dec)

    def _reset_slot(self, slot: int) -> bool:
        """Fresh streaming state for `slot`, in place; a voice it had is
        cleared, so a voiceless next session attends no one's voice.
        Returns whether the conditions need a recompute."""
        mask = np.zeros(self.batch_size, bool)
        mask[slot] = True
        self._reset(mask)
        had_voice = self.slot_attrs[slot] is not None
        self.slot_attrs[slot] = None
        return had_voice

    # ------------------------------------------------------------- conditions
    def _takes_voices(self) -> bool:
        tts = self.tts
        return tts.condition_provider is not None and self.cp_params is not None

    def _voice_dim(self) -> int:
        return self.tts.condition_provider.conditioners["speaker_wavs"].dim

    def _null_attrs(self):
        """The attributes of a zero voice of voice_frames frames."""
        return self.tts.make_condition_attributes(
            [np.zeros((1, self.voice_frames, self._voice_dim()), np.float32)], None)

    def _recompute_conditioning(self):
        """The conditions of every slot from its attributes (voiceless slots
        among voiced ones take the null condition, CFG's null rows follow),
        written in place; with no voice left the engine runs unconditioned."""
        if self.tts.fuser is None or not self.conditioned:
            return
        template = next(a for a in self.slot_attrs if a is not None)
        null = dropout_all_conditions([template])[0]
        self._write_conditions([a if a is not None else null for a in self.slot_attrs])

    def _write_conditions(self, attrs):
        total, cross = self.tts.conditions(attrs, self.cp_params, self.mult == 2)
        if total is not None:
            if self.cond_sum is None:
                self.cond_sum = total.clone()
            self.cond_sum.copy_(total)
        if cross is None:
            return
        if self.gen_state_cross is None:
            self.gen_state_cross = {**self.gen_state,
                                    "transformer": dict(self.gen_state["transformer"])}
        self.gen.init_cross_state(self.gen_state_cross, self.lm_params, cross)

    # ------------------------------------------------------------------ words
    def feed_words(self, slot: int, words: list[str]):
        """Normalize and queue text for `slot`: words become entries,
        `<break time="Ns"/>` an entry of padding."""
        from ..text.tts_preprocess import MAX_BREAK_S, BreakTime, normalize, parse_segments
        s = self.slots[slot]
        if s is None:
            return
        for w in words:
            for seg in parse_segments(w):
                if isinstance(seg, BreakTime):
                    if seg.seconds > 0:
                        npad = max(int(min(seg.seconds, MAX_BREAK_S) * self.tts.frame_rate), 1)
                        s.state.entries.append(Entry(tokens=[], text="", padding=npad))
                    continue
                for word in normalize(seg).split():
                    s.state.entries.append(Entry(tokens=list(self.tts.tokenizer.encode(word)),
                                                 text=word))

    def feed_eos(self, slot: int):
        if self.slots[slot] is not None:
            self.slots[slot].eos = True

    # --------------------------------------------------------------- stepping
    def _starved(self, s: _TtsSlot) -> bool:
        return (not s.eos and not s.state.entries and not s.state.queued
                and s.state.forced_padding <= 0)

    def _finished(self, s: _TtsSlot) -> bool:
        return (s.state.end_step is not None
                and s.offset >= s.state.end_step + self.tts.delay_steps + self.tts.final_padding)

    def steppable(self) -> list[int]:
        """Apply the queued ops, then the slots the next frame runs: open,
        ready, not finished (a finished slot gets its "eos" now) and not
        starved."""
        self.apply_pending_ops()
        out = []
        for b, s in enumerate(self.slots):
            if s is None or s.done or b in self.unready:
                continue
            if self._finished(s):
                s.done = True
                s.outbox.append(("eos", None))
            elif not self._starved(s):
                out.append(b)
        return out

    def step_batch(self, active: list[int], sessions: list | None = None):
        """One batched frame over the slots `active`: graph 1, the state
        machines, graph 2; each slot's Text events and PCM go to the outbox
        of its session (`sessions`, the slots' sessions when the frame was
        started; by default those open now).  Returns (out [B, 1 + dep_q,
        1] int64, pcm [B, 1, frame_size] f32) on the host."""
        tts, B = self.tts, self.batch_size
        if sessions is None:
            sessions = [self.slots[b] for b in active]
        session = dict(zip(active, sessions))
        exec_np = np.zeros(B, bool)
        exec_np[active] = True
        self.mask_in.copy_(torch.from_numpy(exec_np))
        main, depth = self._frame_args(self.conditioned)
        t0 = time.perf_counter()
        toks = self.main[self.conditioned](*main).cpu().numpy()
        t1 = time.perf_counter()
        out_tokens = np.zeros(B, np.int64)
        offsets = np.zeros(B, np.int64)
        valid = np.zeros(B, bool)
        events: dict[int, list] = {}
        for b in active:
            s = session[b]
            before = len(s.state.transcript)
            out_tokens[b], _ = self.machine.process(s.offset, s.state, int(toks[b]))
            events[b] = [{"type": "Text", "text": w, "start_s": step / tts.frame_rate}
                         for w, step in s.state.transcript[before:]]
            if not s.eos and s.state.end_step is not None:
                s.state.end_step = None  # out of words, but more may come
            offsets[b] = s.offset
            valid[b] = s.offset + 1 > self._valid_after
        zero_mask = offsets[:, None] < self._gen_delays[None] + tts.delay_steps
        t2 = time.perf_counter()
        self.text_in.copy_(torch.from_numpy(out_tokens))
        self.zero_in.copy_(torch.from_numpy(zero_mask))
        self.dec_in.copy_(torch.from_numpy(valid & exec_np))

        out, pcm = self.depth(*depth)
        out_np, pcm_np = out.cpu().numpy(), pcm.cpu().numpy()
        t3 = time.perf_counter()
        self.frame_ms.update(main=(t1 - t0) * 1e3, machines=(t2 - t1) * 1e3,
                             depth=(t3 - t2) * 1e3)
        for b in active:
            s = session[b]
            s.offset += 1
            s.outbox += [("event", e) for e in events[b]]
            if valid[b] and not (out_np[b] == UNGENERATED_TOKEN).any():
                s.outbox.append(("pcm", np.clip(pcm_np[b, 0], -1, 1)))
        return out_np, pcm_np

    def tick(self):
        """One turn of the server's loop: the queued ops, then one frame over
        the steppable slots.  Returns (exec mask [B] bool, out, pcm) as
        step_batch gives them, or None when no slot could run."""
        t0 = time.perf_counter()
        active = self.steppable()
        self.frame_ms["ops"] = (time.perf_counter() - t0) * 1e3
        if not active:
            return None
        out, pcm = self.step_batch(active)
        mask = np.zeros(self.batch_size, bool)
        mask[active] = True
        return mask, out, pcm

    # -------------------------------------------------------------- transport
    async def acquire_slot(self, resume: str | None = None) -> int | None:
        """The transport's open_slot: waits for a resumed session's release
        and for its snapshot (host copies), then opens a slot with a queue
        of its own.  None when the batch is full."""
        await await_pending_release(self.slot_resume_id, resume)
        async with self.lock:
            if all(s is not None for s in self.slots):
                return None
            snapshot = await self.snapshots.take(resume)
            slot = self.open_slot(snapshot=snapshot)
            self.slot_queues[slot] = asyncio.Queue()
            self._deliver(slot)
            OPEN_CHANNELS.inc()
            CONNECT_COUNT.inc()
            return slot

    async def release_slot(self, slot: int):
        """The transport's close_slot: the queue's undelivered items go back
        into the session's outbox, so into its snapshot, which is reserved
        at once: a reconnect faster than one frame waits for it instead of
        starting fresh."""
        async with self.lock:
            q, s = self.slot_queues.pop(slot, None), self.slots[slot]
            items = []
            while q is not None and not q.empty():
                items.append(q.get_nowait())
            if s is not None:
                s.outbox[:0] = items
            rid = self.slot_resume_id.get(slot)
            if rid is not None:
                self.snapshots.reserve(rid)
            self.close_slot(slot)
            OPEN_CHANNELS.dec()

    def _deliver(self, slot: int):
        """Move the outbox of the session on `slot` into its queue."""
        q, s = self.slot_queues.get(slot), self.slots[slot]
        if q is None or s is None or not s.outbox:
            return
        for item in s.outbox:
            q.put_nowait(item)
        s.outbox.clear()

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
        next_sweep = 0.0
        while True:
            if len(self.snapshots) and time.time() > next_sweep:
                self.snapshots.sweep()  # expired snapshots free their memory
                next_sweep = time.time() + 5.0
            t0, had_ops = time.perf_counter(), bool(self.pending_ops)
            active = self.steppable()  # the queued ops first: no frame is in flight
            if had_ops:
                self.ops_times.append((time.perf_counter() - t0) * 1e3)
            for slot in list(self.slot_queues):
                self._deliver(slot)    # a finished session's "eos"
            if not active:
                await asyncio.sleep(0.005)
                continue
            # the sessions the frame is for: one that leaves while the frame
            # runs gets its outputs in its snapshot, a new one on its slot none
            sessions = [self.slots[b] for b in active]
            t0 = time.perf_counter()
            await asyncio.to_thread(run_on_device, self.device, self.step_batch, active,
                                    sessions)
            ms = (time.perf_counter() - t0) * 1e3
            self.frame_times.append(ms)
            MODEL_STEP_DURATION.observe(ms / 1e3)
            TOTAL_STEPS.inc()
            for slot in list(self.slot_queues):
                self._deliver(slot)
            await asyncio.sleep(0)


def serve_tts(state: BatchedTTSState, schedule):
    """Play the batched TTS server's loop over a script.

    schedule: one dict per tick, {slot: [action, ...]}, the actions applied
    in order before the tick's frame: ("join", voice) opens a new session
    on the slot (closing the one before), with a voice [T, D] or None;
    ("words", [str]) feeds text; "eos" says the client has no more;
    ("voice", embedding) changes the voice; ("refill", n, [str], eos) holds
    the words back until the slot has been starved n ticks in a row, then
    feeds them (and eos when true); "leave" closes the session.  Then one
    tick runs.

    Returns (sessions, ticks): sessions[slot] holds one dict per session of
    the slot: "tokens" [executed frames, 1 + dep_q] int64 (the output frame
    of each, UNGENERATED_TOKEN before the delays), "events" (its Text
    events), "pcm" (its PCM frames) and "eos" (whether it ended); ticks
    holds, per tick that ran a frame, (exec mask, host ms of the frame from
    its inputs to its outputs read back)."""
    B = state.batch_size
    sessions = {s: [] for s in range(B)}
    refills: dict[int, list] = {}  # slot -> [n, words, eos, ticks frozen so far]
    ticks = []
    for tick in schedule:
        for s, actions in tick.items():
            for action in actions:
                kind = action if isinstance(action, str) else action[0]
                if kind == "join":
                    if state.slots[s] is not None:
                        state.close_slot(s)
                    state.open_slot(s)
                    refills.pop(s, None)
                    if action[1] is not None:
                        state.set_slot_voice(s, action[1])
                    sessions[s].append({"tokens": [], "events": [], "pcm": [], "eos": False})
                elif kind == "words":
                    state.feed_words(s, action[1])
                elif kind == "eos":
                    state.feed_eos(s)
                elif kind == "voice":
                    state.set_slot_voice(s, action[1])
                elif kind == "refill":
                    refills[s] = [action[1], action[2], action[3], 0]
                elif kind == "leave":
                    state.close_slot(s)
                    refills.pop(s, None)
                else:
                    raise ValueError(f"tick action {action!r}")
        for s, r in list(refills.items()):
            if state._starved(state.slots[s]):
                if r[3] == r[0]:   # frozen n ticks: this tick runs it again
                    state.feed_words(s, r[1])
                    if r[2]:
                        state.feed_eos(s)
                    del refills[s]
                else:
                    r[3] += 1
        t0 = time.perf_counter()
        ran = state.tick()
        if ran is not None:
            mask, out, _ = ran
            ticks.append((mask, (time.perf_counter() - t0) * 1e3))
            for b in np.nonzero(mask)[0]:
                sessions[b][-1]["tokens"].append(out[b, :, 0])
        for s, slot in enumerate(state.slots):
            if slot is None:
                continue
            for kind, payload in slot.outbox:
                sess = sessions[s][-1]
                if kind == "eos":
                    sess["eos"] = True
                else:
                    sess["events" if kind == "event" else "pcm"].append(payload)
            slot.outbox.clear()
    width = 1 + state.tts.lm.config.dep_q
    for sess_list in sessions.values():
        for sess in sess_list:
            sess["tokens"] = np.array(sess["tokens"], np.int64).reshape(-1, width)
    return sessions, ticks


async def handle_batched_tts_socket(request, state: BatchedTTSState):
    """aiohttp handler of the batched TTS route: a slot per session ("full"
    as an Error when there is none), words and voices in, audio and word
    events out from the slot's queue.  A client that leaves while its slot
    is starved frees the slot."""
    from aiohttp import WSMsgType, web

    from .tts_ws import make_audio_encoder

    ws = web.WebSocketResponse()
    await ws.prepare(request)
    query = dict(request.rel_url.query)
    want_resume = wants_resume(query)
    slot = await state.acquire_slot(query.get("resume"))
    if slot is None:
        await ws.send_str(json.dumps({"type": "Error", "message": "full"}))
        await ws.close()
        return ws
    try:
        writer = make_audio_encoder(state.tts.mimi.config.sample_rate)
        ready = {"type": "Ready"}
        if want_resume:
            ready["resume_id"] = state.issue_resume_id(slot)
            ready["resumed"] = state.slot_resumed.get(slot, False)
        await ws.send_str(json.dumps(ready))
    except BaseException:
        await state.release_slot(slot)
        raise

    async def receiver():
        async for message in ws:
            if message.type != WSMsgType.TEXT:
                continue
            try:
                msg = json.loads(message.data)
                kind = msg.get("type")
                if kind == "Text":
                    state.feed_words(slot, [str(msg["text"])])
                elif kind == "Voice":
                    emb = np.asarray(msg["embeddings"], np.float32).reshape(msg["shape"])
                    state.set_slot_voice(slot, emb)
                elif kind == "Eos":
                    state.feed_eos(slot)
            except Exception as e:
                # one bad message must not end the session, nor reach the loop
                await ws.send_str(json.dumps({"type": "Error", "message": f"bad message: {e}"}))

    recv_task = asyncio.create_task(receiver())
    try:
        q = state.slot_queues[slot]
        while True:
            # the queue raced against the receiver: a client gone while its
            # slot is starved would leave q.get() waiting for ever
            q_task = asyncio.ensure_future(q.get())
            done, _ = await asyncio.wait({q_task, recv_task},
                                         return_when=asyncio.FIRST_COMPLETED)
            if q_task not in done:
                q_task.cancel()
                break
            kind, payload = q_task.result()
            if kind == "eos":
                await ws.send_str(json.dumps({"type": "Eos"}))
                break
            if kind == "event":
                await ws.send_str(json.dumps(payload))
            else:
                data = writer.append_pcm(np.ascontiguousarray(payload, np.float32))
                if data:
                    await ws.send_bytes(b"\x01" + data)
    finally:
        recv_task.cancel()
        await state.release_slot(slot)
        await ws.close()
    return ws


def load_tts(info, *, device="cuda", kv_cache=None, context=None, weights=None,
             mimi_dtype=None, temp: float = 0.6, cfg_coef: float = 1.0, n_q: int = 32,
             max_padding: int | None = None, voice_dir=None, voice_aliases: dict | None = None,
             voice_frames: int | None = None):
    """The checkpoint of `info` (a CheckpointInfo) ready for an engine: (tts,
    LM params, Mimi params, the engine's keywords), its weights on `device`
    with the serving knobs applied (utils/serving.py).  On a CFG-distilled
    model `cfg_coef` is its voices' `cfg` condition, and the batch is not
    doubled; on another model a coefficient other than 1 doubles the model
    batch.  `voice_frames` sizes the cross K/V (by default the frames of
    the first voice file in `voice_dir`, when that is a local directory)."""
    from ..run_tts import DEFAULT_DSM_TTS_VOICE_REPO, build_tts_from_info
    from ..utils.serving import apply_serving_overrides

    kw = {} if max_padding is None else {"max_padding": int(max_padding)}
    tts, lm_params, mimi_params, cp_params = build_tts_from_info(
        info, temp=temp, cfg_coef=cfg_coef, n_q=n_q,
        voice_repo=voice_dir or DEFAULT_DSM_TTS_VOICE_REPO, voice_aliases=voice_aliases,
        device=device, **kw)
    tts.lm, lm_params, mimi_params, _ = apply_serving_overrides(
        tts.lm, lm_params, mimi_params, kv_cache=kv_cache, context=context, weights=weights,
        mimi_dtype=mimi_dtype)
    cfg_condition = None
    if tts.valid_cfg_conditionings and cfg_coef != 1.0:
        if cfg_coef not in tts.valid_cfg_conditionings:
            raise ValueError(f"cfg_coef {cfg_coef} not in "
                             f"{sorted(tts.valid_cfg_conditionings)}")
        tts.cfg_coef, cfg_condition = 1.0, cfg_coef
    if voice_frames is None:
        voice_frames = first_voice_frames(voice_dir)
    return tts, lm_params, mimi_params, {
        "condition_params": cp_params, "voice_frames": voice_frames, "device": device,
        "cfg_condition": cfg_condition}


def build_state(info, *, batch_size: int, rng_seed: int = 0, **knobs) -> BatchedTTSState:
    """A BatchedTTSState of `batch_size` slots over the checkpoint of `info`,
    with load_tts's knobs; not warmed up."""
    tts, lm_params, mimi_params, kw = load_tts(info, **knobs)
    return BatchedTTSState(tts, lm_params, mimi_params, batch_size, rng_seed=rng_seed, **kw)


def first_voice_frames(voice_dir) -> int | None:
    """The frames of the first (by name) voice .safetensors file in the local
    directory `voice_dir`; None without one."""
    from pathlib import Path

    from ..models.tts import TTSModel
    if voice_dir is None or not Path(voice_dir).is_dir():
        return None
    files = sorted(Path(voice_dir).rglob("*.safetensors"))
    return TTSModel.load_voice_embedding(files[0]).shape[1] if files else None
