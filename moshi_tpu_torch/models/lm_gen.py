"""Streaming frame-by-frame generation for the Moshi LM (counterpart of
moshi_tpu/models/lm_gen.py).

State is a circular delay-line cache [B, K, max_delay + 2] of token ids,
per-item offsets, the temporal transformer's ring KV cache and the
`torch.Generator` that draws the samples; `step` updates it in place.
Frames before the delays have filled come out as UNGENERATED_TOKEN.

`exec_mask` [B] bool freezes slots for batched serving: a frozen slot keeps
its offsets, writes no tokens and outputs UNGENERATED_TOKEN.  The generator
is shared by the batch and draws for every slot each step, frozen or not.

CFG (cfg_coef != 1) runs the temporal transformer and the depformer on a
doubled batch: the slots, then their null variants (the masked-prefix and
no-text variants of moshi_tpu lm_gen.py:155-172), and combines the
logits.  The text repetition penalty keeps a ring of each slot's last
non-pad tokens.  Host control planes (the TTS state machine) use the split
`main_step` (through text sampling) and `depth_step` (depformer, audio
forcing, commit), with the forcing passed as tensors so each half stays one
CUDA graph.  A model without a depformer (dep_q = 0, speech-to-text)
steps the temporal transformer and the text sampling only; its output
frame is [B, 1, 1].
"""

from dataclasses import dataclass

import torch

from .lm import UNGENERATED_TOKEN, ZERO_TOKEN, LMModel
from ..utils.quantize import divide
from ..utils.sampling import sample_token


@dataclass(frozen=True)
class LMGenConfig:
    use_sampling: bool = True
    temp: float = 0.8
    temp_text: float = 0.7
    top_k: int = 250
    top_k_text: int = 25
    cfg_coef: float = 1.0
    cfg_is_no_text: bool = False
    cfg_is_masked_until: bool = False  # the masked-prefix CFG null variant
    # additive boost on the text pad logit
    padding_bonus: float = 0.0
    # over the last text_rep_context non-pad tokens: logit >= 0 -> / penalty,
    # logit < 0 -> * penalty; off when the context is 0 or the penalty 1
    text_rep_penalty: float = 1.0
    text_rep_context: int = 0

    @property
    def rep_penalty_on(self) -> bool:
        return self.text_rep_context > 0 and self.text_rep_penalty != 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "LMGenConfig":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


class LMGen:
    def __init__(self, model: LMModel, gen_config: LMGenConfig = LMGenConfig()):
        self.model = model
        self.gc = gen_config
        c = model.config
        self.max_delay = c.max_delay
        self.num_input_audio = c.num_codebooks - c.dep_q - 1
        self._delays_on: dict[torch.device, torch.Tensor] = {}

    @property
    def model_batch_mult(self) -> int:
        """Rows of the model's batch per slot: 2 under CFG."""
        return 2 if self.gc.cfg_coef != 1.0 else 1

    def init_state(self, batch_size: int, generator: torch.Generator | None,
                   dtype=torch.bfloat16, device=None) -> dict:
        c = self.model.config
        self._delays(device)
        state = {
            "cache": torch.full((batch_size, c.num_codebooks, self.max_delay + 2),
                                UNGENERATED_TOKEN, dtype=torch.long, device=device),
            "offsets": torch.zeros(batch_size, dtype=torch.long, device=device),
            "transformer": self.model.transformer.init_state(
                batch_size * self.model_batch_mult, dtype, device),
            "generator": generator,
        }
        if self.gc.rep_penalty_on:
            state["text_history"] = torch.full((batch_size, self.gc.text_rep_context), -1,
                                               dtype=torch.long, device=device)
            state["hist_pos"] = torch.zeros(batch_size, dtype=torch.long, device=device)
        return state

    def init_cross_state(self, state: dict, params: dict, cross_src: torch.Tensor) -> dict:
        """Cross-attention K/V of a conditioning source [B_model, Ts, dim]
        into the transformer state, in the model's dtype: written in place
        when the state holds them already (a captured graph keeps reading
        the same tensors), else added."""
        tr = state["transformer"]
        out = {k: tr[k] for k in ("k_cross", "v_cross")} if "k_cross" in tr else None
        tr.update(self.model.transformer.precompute_cross(
            params["transformer"], cross_src, params["text_emb"]["weight"].dtype, out))
        return state

    def _delays(self, device) -> torch.Tensor:
        """The delays [K] on `device`, copied from the host once per device
        (by init_state, before any step) and kept: a step makes no
        host-to-device copy, and a CUDA graph that captured the tensor keeps
        reading a live one.  "cuda" and "cuda:0" name one tensor."""
        device = torch.device(device if device is not None else "cpu")
        if device not in self._delays_on:
            t = torch.tensor(self.model.config.delays, dtype=torch.long, device=device)
            self._delays_on[device] = self._delays_on.setdefault(t.device, t)
        return self._delays_on[device]

    # ---------------------------------------------------------------- pieces
    def _scatter_inputs(self, cache, offsets, input_tokens, exec_mask):
        """Write the user's audio tokens at offset + delay and gather this
        frame's model inputs at offset (initial tokens while offset <=
        delay, and for frozen slots).  Returns (inputs [B, K], is_init [B,
        K])."""
        c = self.model.config
        B, K, CT = cache.shape
        dev = cache.device
        delays = self._delays(dev)
        b = torch.arange(B, device=dev)[:, None]
        if self.num_input_audio > 0:
            kin = torch.arange(c.dep_q + 1, K, device=dev)[None]
            wpos = (offsets[:, None] + delays[None, c.dep_q + 1:]) % CT
            cache[b, kin, wpos] = torch.where(
                exec_mask[:, None], input_tokens[:, :self.num_input_audio, 0].long(),
                cache[b, kin, wpos])
        is_init = (offsets[:, None] <= delays[None]) | ~exec_mask[:, None]
        gathered = cache[b, torch.arange(K, device=dev)[None], (offsets % CT)[:, None]]
        return torch.where(is_init, self.model._initial_token(B, dev), gathered), is_init

    def _cfg_double(self, inputs, is_init, offsets, cfg_masked_until):
        """The model's batch: the slots' inputs, then under CFG their null
        variants (moshi_tpu lm_gen.py:155-172)."""
        gc = self.gc
        if gc.cfg_coef == 1.0:
            return inputs
        null = inputs
        if gc.cfg_is_masked_until and cfg_masked_until is not None:
            limit = self._delays(inputs.device)[None] + cfg_masked_until[:, None]
            null = torch.where((offsets[:, None] <= limit) & ~is_init, ZERO_TOKEN, null)
        if gc.cfg_is_no_text:
            null = null.clone()
            null[:, 0] = torch.where(~is_init[:, 0], ZERO_TOKEN, null[:, 0])
        return torch.cat([inputs, null], dim=0)

    def _combine_cfg(self, logits):
        gc = self.gc
        if gc.cfg_coef == 1.0:
            return logits
        cond, uncond = logits.chunk(2, dim=0)
        if gc.cfg_is_no_text:
            return cond
        return uncond + (cond - uncond) * gc.cfg_coef

    def _commit(self, cache, offsets, text_token, audio_tokens, exec_mask):
        """Advance the executing slots' offsets, write their generated
        tokens, gather the undelayed output frame [B, 1 + dep_q, 1]."""
        c = self.model.config
        B, _, CT = cache.shape
        dev = cache.device
        b = torch.arange(B, device=dev)[:, None]
        offsets += exec_mask.long()
        pos = (offsets % CT)[:, None]
        run = exec_mask[:, None]
        cache[b, 0, pos] = torch.where(run, text_token[:, None], cache[b, 0, pos])
        if audio_tokens is not None:
            kgen = torch.arange(1, c.dep_q + 1, device=dev)[None]
            cache[b, kgen, pos] = torch.where(run, audio_tokens, cache[b, kgen, pos])
        gen_delays = self._delays(dev)[None, :c.dep_q + 1]
        gpos = (offsets[:, None] - self.max_delay + gen_delays) % CT
        out = cache[b, torch.arange(c.dep_q + 1, device=dev)[None], gpos]
        invalid = (offsets <= self.max_delay) | ~exec_mask
        return out.masked_fill(invalid[:, None], UNGENERATED_TOKEN)[:, :, None]

    def _sample_text(self, generator, text_logits, text_history=None):
        gc = self.gc
        logits = text_logits[:, 0, 0].float()
        if gc.padding_bonus:
            logits = logits.clone()  # .float() of f32 logits is the caller's tensor
            logits[:, self.model.config.existing_text_padding_id] += gc.padding_bonus
        if text_history is not None:
            B, V = logits.shape
            seen = torch.zeros((B, V), dtype=torch.int32, device=logits.device)
            seen.scatter_add_(1, text_history.clamp(0, V - 1),
                              (text_history >= 0).to(torch.int32))
            p = gc.text_rep_penalty
            logits = torch.where(seen > 0, torch.where(logits >= 0, divide(logits, p),
                                                       logits * p), logits)
        return sample_token(generator, logits, use_sampling=gc.use_sampling,
                            temp=gc.temp_text, top_k=gc.top_k_text)

    def _update_history(self, state: dict, text_token, exec_mask) -> None:
        """Push each executing slot's sampled token, unless it is a pad, the
        end pad or the start token, into its repetition-penalty ring."""
        if not self.gc.rep_penalty_on:
            return
        c = self.model.config
        hist, pos = state["text_history"], state["hist_pos"]
        skip = ((text_token == c.existing_text_padding_id)
                | (text_token == c.existing_text_end_padding_id)
                | (text_token == c.text_initial_token_id) | ~exec_mask)
        b = torch.arange(hist.shape[0], device=hist.device)
        at = pos % hist.shape[1]
        hist[b, at] = torch.where(skip, hist[b, at], text_token)
        pos += (~skip).long()

    # ------------------------------------------------------------------- step
    def main_step(self, params: dict, state: dict, input_tokens: torch.Tensor,
                  exec_mask: torch.Tensor | None = None,
                  condition_sum: torch.Tensor | None = None,
                  cfg_masked_until: torch.Tensor | None = None):
        """First half of a frame, through text sampling, for host control
        planes that rewrite the text token before the depformer.
        input_tokens [B, Ki, 1].  Returns (text_token [B], text_logits [B,
        1, 1, text_out_card] after CFG, h [B_model, 1, dim]); the state is
        updated in place (the offsets advance in depth_step)."""
        if input_tokens.shape[2] != 1:
            raise ValueError("steps are given one frame at a time")
        cache, offsets = state["cache"], state["offsets"]
        if exec_mask is None:
            exec_mask = torch.ones(cache.shape[0], dtype=torch.bool, device=cache.device)
        inputs, is_init = self._scatter_inputs(cache, offsets, input_tokens, exec_mask)
        model_in = self._cfg_double(inputs, is_init, offsets, cfg_masked_until)
        h, text_logits, _ = self.model.forward_text_step(
            params, state["transformer"], model_in[:, :, None], sum_condition=condition_sum,
            exec_mask=exec_mask.repeat(self.model_batch_mult))
        text_logits = self._combine_cfg(text_logits)
        text_token = self._sample_text(state["generator"], text_logits,
                                       state.get("text_history"))
        self._update_history(state, text_token, exec_mask)
        return text_token, text_logits, h

    def depth_step(self, params: dict, state: dict, text_token: torch.Tensor,
                   h: torch.Tensor, exec_mask: torch.Tensor | None = None,
                   depformer_replace_tokens: torch.Tensor | None = None,
                   audio_zero_mask: torch.Tensor | None = None,
                   forced_audio: torch.Tensor | None = None) -> torch.Tensor:
        """Second half of a frame: the depformer (skipped, drawing nothing,
        when depformer_replace_tokens [B, dep_q, 1] is given or the model
        has none), audio forcing, the commit.  text_token [B] may have been
        rewritten by the host.  audio_zero_mask [dep_q] or [B, dep_q] bool: codebooks forced
        to ZERO_TOKEN; forced_audio [B, dep_q]: entries other than
        UNGENERATED_TOKEN replace the sampled tokens.  Returns out [B, 1 +
        dep_q, 1]; the state is updated in place."""
        gc = self.gc
        cache = state["cache"]
        if exec_mask is None:
            exec_mask = torch.ones(cache.shape[0], dtype=torch.bool, device=cache.device)
        if depformer_replace_tokens is not None:
            audio_tokens = depformer_replace_tokens[:, :, 0].long()
        elif self.model.depformer is None:
            return self._commit(cache, state["offsets"], text_token, None, exec_mask)
        else:
            audio_tokens = self.model.depformer_step(
                params, state["generator"], text_token, h, use_sampling=gc.use_sampling,
                temp=gc.temp, top_k=gc.top_k, cfg_coef=gc.cfg_coef)
        if audio_zero_mask is not None:
            zm = audio_zero_mask if audio_zero_mask.ndim == 2 else audio_zero_mask[None]
            audio_tokens = audio_tokens.masked_fill(zm, ZERO_TOKEN)
        if forced_audio is not None:
            audio_tokens = torch.where(forced_audio != UNGENERATED_TOKEN, forced_audio.long(),
                                       audio_tokens)
        return self._commit(cache, state["offsets"], text_token, audio_tokens, exec_mask)

    def _step(self, params, state, input_tokens, exec_mask, condition_sum):
        text_token, text_logits, h = self.main_step(params, state, input_tokens, exec_mask,
                                                    condition_sum)
        out = self.depth_step(params, state, text_token, h, exec_mask)
        return out, text_logits, text_token

    def step(self, params: dict, state: dict, input_tokens: torch.Tensor,
             exec_mask: torch.Tensor | None = None,
             condition_sum: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """One 80 ms frame.  input_tokens [B, Ki, 1] -> (out [B, 1 + dep_q, 1]
        int64, state); out holds UNGENERATED_TOKEN for the first max_delay
        frames and for slots whose exec_mask entry is False.  condition_sum
        [B_model, 1, dim] is added to the temporal input (the fuser's
        sum)."""
        out, _, _ = self._step(params, state, input_tokens, exec_mask, condition_sum)
        return out, state

    def step_with_text_prob(self, params: dict, state: dict, input_tokens: torch.Tensor,
                            exec_mask: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Also return the sampled text token's softmax probability [B]."""
        out, text_logits, text_token = self._step(params, state, input_tokens, exec_mask,
                                                  None)
        lp = torch.log_softmax(text_logits[:, 0, 0].float(), dim=-1)
        prob = torch.exp(torch.gather(lp, -1, text_token[:, None]))[:, 0]
        return out, prob, state
