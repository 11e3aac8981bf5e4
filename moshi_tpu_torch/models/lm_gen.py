"""Streaming frame-by-frame generation for the Moshi LM (counterpart of
moshi_tpu/models/lm_gen.py).

State is a circular delay-line cache [B, K, max_delay + 2] of token ids,
per-item offsets, the temporal transformer's ring KV cache and the
`torch.Generator` that draws the samples; `step` updates it in place.
Frames before the delays have filled come out as UNGENERATED_TOKEN.

Not ported yet: CFG batch doubling, the text repetition penalty, exec_mask
(per-slot freeze), conditioning sums, and the split main_step/depth_step
API of the TTS/ASR control planes.
"""

from dataclasses import dataclass

import torch

from .lm import UNGENERATED_TOKEN, LMModel
from ..utils.sampling import sample_token


@dataclass(frozen=True)
class LMGenConfig:
    use_sampling: bool = True
    temp: float = 0.8
    temp_text: float = 0.7
    top_k: int = 250
    top_k_text: int = 25
    cfg_coef: float = 1.0
    # additive boost on the text pad logit
    padding_bonus: float = 0.0
    text_rep_penalty: float = 1.0
    text_rep_context: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "LMGenConfig":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


class LMGen:
    def __init__(self, model: LMModel, gen_config: LMGenConfig = LMGenConfig()):
        gc = gen_config
        if gc.cfg_coef != 1.0:
            raise NotImplementedError("CFG (cfg_coef != 1) is not ported")
        if gc.text_rep_context > 0 and gc.text_rep_penalty != 1.0:
            raise NotImplementedError("the text repetition penalty is not ported")
        self.model = model
        self.gc = gc
        c = model.config
        self.max_delay = c.max_delay
        self.num_input_audio = c.num_codebooks - c.dep_q - 1

    def init_state(self, batch_size: int, generator: torch.Generator | None,
                   dtype=torch.bfloat16, device=None) -> dict:
        c = self.model.config
        return {
            "cache": torch.full((batch_size, c.num_codebooks, self.max_delay + 2),
                                UNGENERATED_TOKEN, dtype=torch.long, device=device),
            "offsets": torch.zeros(batch_size, dtype=torch.long, device=device),
            "transformer": self.model.transformer.init_state(batch_size, dtype, device),
            "generator": generator,
        }

    def _delays(self, device) -> torch.Tensor:
        return torch.tensor(self.model.config.delays, dtype=torch.long, device=device)

    def _scatter_inputs(self, cache, offsets, input_tokens):
        """Write the user's audio tokens at offset + delay and gather this
        frame's model inputs at offset (initial tokens while offset <=
        delay)."""
        c = self.model.config
        B, K, CT = cache.shape
        dev = cache.device
        delays = self._delays(dev)
        b = torch.arange(B, device=dev)[:, None]
        if self.num_input_audio > 0:
            kin = torch.arange(c.dep_q + 1, K, device=dev)[None]
            wpos = (offsets[:, None] + delays[None, c.dep_q + 1:]) % CT
            cache[b, kin, wpos] = input_tokens[:, :self.num_input_audio, 0].long()
        is_init = offsets[:, None] <= delays[None]
        gathered = cache[b, torch.arange(K, device=dev)[None], (offsets % CT)[:, None]]
        return torch.where(is_init, self.model._initial_token(B, dev), gathered)

    def _commit(self, cache, offsets, text_token, audio_tokens):
        """Advance offsets, write the generated tokens, gather the undelayed
        output frame [B, 1 + dep_q, 1]."""
        c = self.model.config
        B, _, CT = cache.shape
        dev = cache.device
        b = torch.arange(B, device=dev)[:, None]
        offsets += 1
        pos = (offsets % CT)[:, None]
        cache[b, 0, pos] = text_token[:, None]
        kgen = torch.arange(1, c.dep_q + 1, device=dev)[None]
        cache[b, kgen, pos] = audio_tokens
        gen_delays = self._delays(dev)[None, :c.dep_q + 1]
        gpos = (offsets[:, None] - self.max_delay + gen_delays) % CT
        out = cache[b, torch.arange(c.dep_q + 1, device=dev)[None], gpos]
        out = out.masked_fill((offsets <= self.max_delay)[:, None], UNGENERATED_TOKEN)
        return out[:, :, None]

    def _sample_text(self, generator, text_logits):
        gc = self.gc
        logits = text_logits[:, 0, 0].float()
        if gc.padding_bonus:
            logits[:, self.model.config.existing_text_padding_id] += gc.padding_bonus
        return sample_token(generator, logits, use_sampling=gc.use_sampling,
                            temp=gc.temp_text, top_k=gc.top_k_text)

    def _step(self, params, state, input_tokens):
        model, gc = self.model, self.gc
        if input_tokens.shape[2] != 1:
            raise ValueError("steps are given one frame at a time")
        cache, offsets = state["cache"], state["offsets"]
        model_in = self._scatter_inputs(cache, offsets, input_tokens)
        h, text_logits, _ = model.forward_text_step(params, state["transformer"],
                                                    model_in[:, :, None])
        generator = state["generator"]
        text_token = self._sample_text(generator, text_logits)
        audio_tokens = model.depformer_step(
            params, generator, text_token, h, use_sampling=gc.use_sampling,
            temp=gc.temp, top_k=gc.top_k)
        out = self._commit(cache, offsets, text_token, audio_tokens)
        return out, text_logits, text_token

    def step(self, params: dict, state: dict, input_tokens: torch.Tensor
             ) -> tuple[torch.Tensor, dict]:
        """One 80 ms frame.  input_tokens [B, Ki, 1] -> (out [B, 1 + dep_q, 1]
        int64, state); out holds UNGENERATED_TOKEN for the first max_delay
        frames."""
        out, _, _ = self._step(params, state, input_tokens)
        return out, state

    def step_with_text_prob(self, params: dict, state: dict, input_tokens: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Also return the sampled text token's softmax probability [B]."""
        out, text_logits, text_token = self._step(params, state, input_tokens)
        lp = torch.log_softmax(text_logits[:, 0, 0].float(), dim=-1)
        prob = torch.exp(torch.gather(lp, -1, text_token[:, None]))[:, 0]
        return out, prob, state
