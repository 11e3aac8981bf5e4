"""Conditioners, the part the speech-to-text models need (counterpart of
moshi_tpu/conditioners.py): the continuous-attribute conditioner that
turns the ASR `delay` value into a vector added to every temporal input,
and the provider that holds named conditioners.

Not ported yet (they come with TTS): the LUT and tensor conditioners,
`ConditionFuser`, the CFG null conditions and the provider's batch
prepare/apply over attribute dicts.
"""

import math

import numpy as np
import torch

from .utils.params import normal


class ContinuousAttributeConditioner:
    """Sinusoidal embedding of a continuous scalar, projected to the model
    width: value * scale_factor -> cat(cos, sin) over `dim` channels ->
    output_proj; a None value takes the learnt padding vector."""

    def __init__(self, output_dim: int, dim: int, scale_factor: float,
                 max_period: float = 10_000.0):
        self.output_dim = output_dim
        self.dim = dim
        self.scale_factor = scale_factor
        self.max_period = max_period

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        """The distributions of moshi_tpu's init_params, drawn from a torch
        generator."""
        return {
            "output_proj": normal(generator, (self.dim, self.output_dim), dtype, device)
            / math.sqrt(self.dim),
            "learnt_padding": normal(generator, (1, 1, self.output_dim), dtype, device) * 0.2,
        }

    def prepare(self, values: list) -> tuple[np.ndarray, np.ndarray]:
        """values (one per batch item, None for no value) -> (vals [B, 1, 1]
        f32, mask [B, 1] bool)."""
        vals = np.asarray([[0.0 if v is None else float(v)] for v in values],
                          np.float32)[:, :, None]
        mask = np.asarray([[v is not None] for v in values], bool)
        return vals, mask

    def apply(self, params: dict, prepared) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (condition [B, 1, output_dim], mask [B, 1])."""
        w = params["output_proj"]
        vals, mask = prepared
        half = self.dim // 2
        positions = torch.as_tensor(vals, device=w.device) * self.scale_factor
        adim = (1.0 / self.max_period ** (torch.arange(half, dtype=torch.float32,
                                                       device=w.device)
                                          / (half - 1))).reshape(1, 1, -1)
        freqs = positions * adim
        emb = torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1)
        cond = torch.matmul(emb, w)
        maskf = torch.as_tensor(mask, dtype=torch.float32, device=w.device)[..., None]
        cond = cond * maskf + params["learnt_padding"] * (1 - maskf)
        return cond, torch.as_tensor(mask, device=w.device)


class ConditionProvider:
    """Named conditioners and their parameter trees."""

    def __init__(self, conditioners: dict):
        self.conditioners = conditioners

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        return {name: c.init_params(generator, dtype, device)
                for name, c in self.conditioners.items()}
