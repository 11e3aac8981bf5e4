"""The batched full-duplex frame engine (counterpart of `BatchedMoshiState`'s
frame path in moshi_tpu/serve/batched_moshi.py): B slots, one user each,
stepped together one 80 ms frame at a time.  A slot with no audio ready is
frozen by its exec_mask entry: it computes, but its streaming state does not
advance and it outputs nothing.

On a CUDA device the frame runs as replays of one CUDA graph.  The
websocket/opus handlers, the asyncio loop, session resume (snapshots) and
the multi-card mesh are not ported yet; `serve_batched` plays the loop's
role over a scripted schedule of PCM frames.
"""

import time

import numpy as np
import torch

from ..models.lm import UNGENERATED_TOKEN
from ..models.lm_gen import LMGen, LMGenConfig
from ..utils.graphs import GraphedStep
from ..utils.trees import masked_reset, state_batch_axes

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
    same function eagerly (the CPU's only path)."""

    def __init__(self, mimi, mimi_params, lm, lm_params, batch_size: int, *,
                 device="cuda", rng_seed: int = 0, graphed: bool | None = None,
                 **lm_gen_kwargs):
        self.mimi, self.mimi_params = mimi, mimi_params
        self.lm, self.lm_params = lm, lm_params
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

