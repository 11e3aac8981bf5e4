"""Streaming speech-to-text engine with word-level timestamps (counterpart of
moshi_tpu/models/asr.py).

Per 80 ms frame: Mimi encodes B slots' audio into n_q codes, the host
builds each slot's delayed inputs (its previous frame's codes and its last
text token), one temporal step of the LM (dep_q = 0: no depformer) gives
the text logits, and argmax (or a sample from an explicit torch.Generator)
picks each slot's token.  The word state machine runs on the host: after
`asr_delay_in_tokens` steps a pad (3) or end-pad (0) token flushes the
word so far as `AsrWord`, and an end-pad also ends it with `AsrEndWord`;
extra-head probabilities come out as `AsrStep`.

A frozen slot (exec_mask False) gets zero audio and the text start token,
computes, and keeps its offsets and its host state.  Streaming state is
updated in place.

On a CUDA device the frame's device work runs as replays of two CUDA
graphs (the JAX package's two jitted programs): Mimi encode over static
PCM and exec_mask buffers, and the temporal step with the text token's
choice over a static token buffer and the same mask.  The host loops of
`step_tokens` (the delayed inputs before the step, the word tracker after
it) run between them.  Per-slot resets, and the single-slot extract and
restore of session resume, write the state in place between frames, so
the captured graphs stay valid.

With a `text_tokenizer` (text/spm.py) a word's tokens are also decoded to
its `text`, as the reference server does.

Not ported: `mimi_chunks`, a work-around for XLA's rematerialization at
B = 512 whose results do not depend on it.
"""

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.graphs import GraphedStep
from ..utils.sampling import sample_token
from ..utils.trees import masked_reset, put_slots, state_batch_axes, take_slots


@dataclass
class AsrWord:
    tokens: list
    start_time: float
    batch_idx: int
    text: str | None = None


@dataclass
class AsrEndWord:
    stop_time: float
    batch_idx: int


@dataclass
class AsrStep:
    step_idx: int
    prs: np.ndarray  # [num_extra_heads, B]


@dataclass
class _ItemState:
    audio_pad_token: int
    n_codebooks: int
    step_idx: int = 0
    text_token: int = 0
    word_tokens: list = field(default_factory=list)
    unended_word: bool = False
    last_stop_time: float = 0.0
    next_codebooks: np.ndarray = None

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.step_idx = 0
        self.text_token = 0
        self.word_tokens = []
        self.unended_word = False
        self.last_stop_time = 0.0
        self.next_codebooks = np.full((self.n_codebooks,), self.audio_pad_token, np.int32)

    def next_token(self, tokens: np.ndarray) -> np.ndarray:
        """Feed this frame's codes, get the previous frame's (the audio pad
        token on the first step): the one-step delayed audio input."""
        prev = self.next_codebooks.copy()
        self.next_codebooks = tokens.astype(np.int32)
        if self.step_idx == 0:
            return np.full_like(prev, self.audio_pad_token)
        return prev


def asr_sum_condition(provider, params=None, dim: int | None = None,
                      conditioning_delay: float | None = None, learnt_padding: bool = False,
                      device="cuda"):
    """The per-step AddToInput condition of an ASR model, as the reference
    server builds it.  provider: a ConditionProvider (or None) and params
    its parameter tree; or, as in the JAX package, a CheckpointInfo and the
    model's dim (`asr_sum_condition(info, dim, ...)`), whose conditioners
    are read onto `device`.  A model with a `delay` conditioner needs
    exactly one of `conditioning_delay` (fed as the value
    -conditioning_delay) and `learnt_padding` (the conditioner's learnt
    padding vector); a model without one takes neither.  Returns [1, 1,
    dim] f32, or None."""
    if hasattr(provider, "get_conditioners"):
        dim = params
        provider, _, params = provider.get_conditioners(dim, device)
    has_delay = provider is not None and "delay" in provider.conditioners
    if not has_delay:
        if conditioning_delay is not None or learnt_padding:
            raise ValueError("conditioning requested but the checkpoint has "
                             "no 'delay' conditioner")
        return None
    if conditioning_delay is not None and learnt_padding:
        raise ValueError("conditioning_delay/conditioning_learnt_padding "
                         "cannot be both set")
    if learnt_padding:
        return params["delay"]["learnt_padding"].float().reshape(1, 1, dim)
    if conditioning_delay is None:
        raise ValueError("missing conditioning_delay in config")
    cond = provider.conditioners["delay"]
    out, _ = cond.apply(params["delay"], cond.prepare([-float(conditioning_delay)]))
    return out  # [1, 1, dim]


class StreamingASR:
    """B slots of streaming ASR on `device`.  The codec runs in
    `mimi_dtype` (its parameters must be in it too); the LM's KV cache
    follows its config (`kv_cache_dtype`).  `text_tokenizer` (anything with
    `decode(ids) -> str`, or None) gives each AsrWord its `text`.

    `graphed` (the default on a CUDA device) captures Mimi encode and the
    temporal step as two CUDA graphs at the first frame after `warmup()`
    and replays them at every frame after; PCM, exec_mask and the step's
    tokens are copied into static buffers first (a missing exec_mask as all
    True), and a graphed engine steps the one state it was captured with.
    `graphed=False` runs the same functions eagerly (the CPU's only path).
    With temperature > 0 the draws come from the engine's own generator,
    seeded with `rng_seed` (registered with the step's graph), unless
    `init_state` is given another one (eager only)."""

    def __init__(self, mimi, lm, batch_size: int, asr_delay_in_tokens: int,
                 temperature: float = 0.0, text_tokenizer=None, mimi_dtype=torch.float32,
                 sum_condition=None, device="cuda", graphed: bool | None = None,
                 rng_seed: int = 0):
        self.mimi, self.lm = mimi, lm
        self.text_tokenizer = text_tokenizer
        self.batch_size = batch_size
        self.asr_delay_in_tokens = asr_delay_in_tokens
        self.temperature = temperature
        self.mimi_dtype = mimi_dtype
        self.device = dev = torch.device(device)
        self.graphed = dev.type == "cuda" if graphed is None else graphed
        if self.graphed and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        # lives as long as the engine, so the step's graph reads a live tensor
        self.sum_condition = (None if sum_condition is None
                              else torch.as_tensor(sum_condition).to(dev))
        c = lm.config
        self.audio_pad_token = c.initial_token_id
        self.text_start_token = c.text_initial_token_id
        self.n_codebooks = c.n_q
        self.items = [_ItemState(self.audio_pad_token, self.n_codebooks)
                      for _ in range(batch_size)]
        self.model_step_idx = 0
        self.host_ms = 0.0  # host time of the last step's per-slot loops
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(rng_seed)
        # the graphs' static inputs
        self.pcm_in = torch.zeros((batch_size, 1, mimi.frame_size), dtype=mimi_dtype,
                                  device=dev)
        self.mask_in = torch.ones(batch_size, dtype=torch.bool, device=dev)
        self.tokens_in = torch.zeros((batch_size, 1 + c.n_q, 1), dtype=torch.long, device=dev)
        self.encode = GraphedStep(self._encode, graphed=self.graphed, device=dev)
        self.step = GraphedStep(self._device_step, graphed=self.graphed, device=dev,
                                generators=(self.generator,))
        # exact per-leaf batch axes: a shape rule mistakes the layer axis of
        # a [L, B, ...] cache for the batch axis when B == L
        self._ax_mimi = state_batch_axes(lambda b, d: mimi.init_encode_state(b, mimi_dtype, d))
        self._ax_tr = state_batch_axes(
            lambda b, d: lm.transformer.init_state(b, torch.bfloat16, d))

    # ------------------------------------------------------------- device part
    def _encode(self, mimi_params, mimi_state, pcm, exec_mask):
        """pcm [B, 1, frame_size] in the codec's dtype -> codes [B, K, 1];
        the encoder's state in place."""
        codes, _ = self.mimi.encode_step(mimi_params, mimi_state, pcm, exec_mask)
        return codes

    def _device_step(self, lm_params, state, tokens, exec_mask):
        """tokens [B, 1 + n_q, 1] -> (text tokens [B], extra-head
        probabilities of class 0 [n_heads, B] or None).  One temporal step,
        state in place."""
        h, text_logits, _ = self.lm.forward_text_step(
            lm_params, state["transformer"], tokens, sum_condition=self.sum_condition,
            exec_mask=exec_mask)
        text_token = sample_token(state["generator"], text_logits[:, 0, 0],
                                  use_sampling=self.temperature > 0.0, temp=self.temperature)
        probs = self.lm.extra_head_probs(lm_params, h)
        return text_token, None if probs is None else probs[:, :, 0, 0]

    @staticmethod
    def _run(step: GraphedStep, warm: bool, *args):
        return step.warm_up(*args) if warm else step(*args)

    # --------------------------------------------------------------- state mgmt
    def init_state(self, generator: torch.Generator | None = None,
                   dtype=torch.bfloat16) -> dict:
        """Fresh state: the Mimi encoder's, the temporal transformer's (KV
        in `dtype` for a model-dtype cache) and the generator that draws
        samples when temperature > 0 (the engine's own by default)."""
        if generator is None:
            generator = self.generator
        elif self.graphed and generator is not self.generator:
            raise ValueError("a graphed engine draws from its own generator (rng_seed)")
        dev = self.device
        return {"mimi": self.mimi.init_encode_state(self.batch_size, self.mimi_dtype, dev),
                "transformer": self.lm.transformer.init_state(self.batch_size, dtype, dev),
                "generator": generator}

    def _reset(self, state: dict, mask: np.ndarray) -> dict:
        dev = self.device
        masked_reset(state["mimi"], self.mimi.init_encode_state(1, self.mimi_dtype, dev),
                     mask, self._ax_mimi)
        masked_reset(state["transformer"],
                     self.lm.transformer.init_state(1, state["transformer"]["k"].dtype, dev),
                     mask, self._ax_tr)
        return state

    def reset_batch_idx(self, state: dict, batch_idx: int) -> dict:
        """A new session on slot `batch_idx`: its host state and its rows of
        the device state reset, in place."""
        self.items[batch_idx].reset()
        mask = np.zeros(self.batch_size, bool)
        mask[batch_idx] = True
        return self._reset(state, mask)

    def warmup(self, mimi_params, lm_params, state: dict) -> dict:
        """Three zero frames on every slot, eagerly (on the graphs' side
        streams when graphed), then every slot reset; the step clock and
        the messages are left as they were.  A graphed engine needs it
        before its first frame."""
        B, clock = self.batch_size, self.model_step_idx
        for _ in range(3):
            self._step_pcm(mimi_params, lm_params, state,
                           np.zeros((B, 1, self.mimi.frame_size), np.float32), None, True)
        for item in self.items:
            item.reset()
        self.model_step_idx = clock
        return self._reset(state, np.ones(B, bool))

    # ------------------------------------------------- single-slot snapshots
    def extract_slot_arrays(self, state: dict, slot: int):
        """Slot `slot`'s device rows, (Mimi, transformer), each a state at
        batch size 1 (copies): the device half of a session-resume
        snapshot."""
        idx = [int(slot)]
        return (take_slots(state["mimi"], idx, self._ax_mimi),
                take_slots(state["transformer"], idx, self._ax_tr))

    def restore_slot_arrays(self, state: dict, arrays, slot: int) -> dict:
        """Inverse of extract_slot_arrays: write the rows (on any device)
        into slot `slot`, in place."""
        m, tr = arrays
        idx = [int(slot)]
        put_slots(state["mimi"], m, idx, self._ax_mimi)
        put_slots(state["transformer"], tr, idx, self._ax_tr)
        return state

    # ---------------------------------------------------------------- stepping
    def step_pcm(self, mimi_params, lm_params, state: dict, pcm,
                 exec_mask=None) -> tuple[list, dict]:
        """pcm [B, 1, n * frame_size] float32 (numpy or tensor; n = 1 when
        graphed) -> (messages, state)."""
        return self._step_pcm(mimi_params, lm_params, state, pcm, exec_mask, False)

    def _step_pcm(self, mimi_params, lm_params, state, pcm, exec_mask, warm: bool):
        pcm = torch.as_tensor(pcm, dtype=torch.float32)
        if self.graphed:
            self.pcm_in.copy_(pcm)
            x = self.pcm_in
        else:
            x = pcm.to(self.device, self.mimi_dtype)
        mask = self._device_mask(exec_mask)
        codes = self._run(self.encode, warm, mimi_params, state["mimi"], x, mask)
        return self._step_tokens(lm_params, state, codes.cpu().numpy(), exec_mask, mask, warm)

    def _device_mask(self, exec_mask):
        """The frame's exec_mask on the device: graphed, the mask buffer
        (all True for None); eager, a new tensor or None."""
        if self.graphed:
            self.mask_in.copy_(torch.ones(self.batch_size, dtype=torch.bool) if exec_mask is None
                               else torch.as_tensor(exec_mask, dtype=torch.bool))
            return self.mask_in
        return None if exec_mask is None else torch.as_tensor(
            exec_mask, dtype=torch.bool).to(self.device)

    def step_tokens(self, lm_params, state: dict, audio_tokens: np.ndarray,
                    exec_mask=None) -> tuple[list, dict]:
        """audio_tokens [B, K, steps] int -> (messages, state)."""
        return self._step_tokens(lm_params, state, audio_tokens, exec_mask,
                                 self._device_mask(exec_mask), False)

    def _step_tokens(self, lm_params, state, audio_tokens, exec_mask, mask, warm: bool):
        B, K, steps = audio_tokens.shape
        if B != self.batch_size:
            raise ValueError(f"{B} slots of tokens for a batch of {self.batch_size}")
        exec_np = np.ones(B, bool) if exec_mask is None else np.asarray(exec_mask, bool)
        msgs: list = []
        self.host_ms = 0.0
        for s in range(steps):
            t0 = time.perf_counter()
            # the delayed inputs, on the host
            audio_in = np.zeros((B, self.n_codebooks), np.int32)
            text_in = np.zeros((B,), np.int32)
            for b, item in enumerate(self.items):
                if not exec_np[b]:
                    text_in[b] = self.text_start_token
                    continue
                toks = audio_tokens[b, :, s]
                if K < self.n_codebooks:
                    toks = np.concatenate([toks, np.full(
                        (self.n_codebooks - K,), self.audio_pad_token, np.int32)])
                audio_in[b] = item.next_token(toks[:self.n_codebooks])
                text_in[b] = self.text_start_token if item.step_idx == 0 else item.text_token
            tokens = np.concatenate([text_in[:, None], audio_in], axis=1)[:, :, None]
            t1 = time.perf_counter()

            if self.graphed:
                self.tokens_in.copy_(torch.from_numpy(tokens))
                tokens_t = self.tokens_in
            else:
                tokens_t = torch.from_numpy(tokens).to(self.device, torch.long)
            # graphed, these are the graph's static outputs: read before the next replay
            text_token, pr_first = self._run(self.step, warm, lm_params, state, tokens_t, mask)
            self.model_step_idx += 1
            text_np = text_token.cpu().numpy()
            if pr_first is not None:
                msgs.append(AsrStep(self.model_step_idx, pr_first.cpu().numpy()))

            t2 = time.perf_counter()
            for b, item in enumerate(self.items):
                if not exec_np[b]:
                    continue
                item.text_token = int(text_np[b])
                item.step_idx += 1
                if item.step_idx >= self.asr_delay_in_tokens:
                    t = item.text_token
                    if t in (0, 3):
                        if item.word_tokens:
                            word = AsrWord(item.word_tokens, item.last_stop_time, b)
                            if self.text_tokenizer is not None:
                                word.text = self.text_tokenizer.decode(word.tokens)
                            msgs.append(word)
                            item.word_tokens = []
                            item.unended_word = True
                    else:
                        item.word_tokens.append(t)
                    if t == 0:
                        stop_time = ((item.step_idx - self.asr_delay_in_tokens)
                                     / self.mimi.config.frame_rate)
                        if item.unended_word:
                            item.unended_word = False
                            msgs.append(AsrEndWord(stop_time, b))
                        item.last_stop_time = stop_time
            self.host_ms += (t1 - t0 + time.perf_counter() - t2) * 1e3
        return msgs, state
