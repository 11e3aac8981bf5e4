"""Conditioners (counterpart of moshi_tpu/conditioners.py): named
conditions turned into vectors the LM adds to its inputs (fused by "sum")
or attends (fused by "cross").

- `LUTConditioner`: a string (hashed, or one of its possible values) ->
  a table row projected to the model width; the TTS `cfg` condition.
- `TensorConditioner`: a tensor [B, T, dim] projected to the model width;
  the TTS `speaker_wavs` voice embeddings.
- `ContinuousAttributeConditioner`: a scalar -> a sinusoidal embedding
  projected to the model width; the ASR `delay` condition.

Each takes its learnt padding vector where its mask is False (a None
value, a padded tensor row).  Strings and host arrays are prepared on the
host (`prepare`), the arithmetic runs on the parameters' device (`apply`).
`dropout_all_conditions` gives the null condition of CFG and of a slot
without a voice.
"""

import hashlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .utils.params import normal


@dataclass
class TensorCondition:
    """tensor: [B|1, T, D]; mask: [B|1, T] (host arrays)."""
    tensor: np.ndarray
    mask: np.ndarray

    @staticmethod
    def from_tensor(tensor):
        B, T, _ = tensor.shape
        return TensorCondition(tensor, np.ones((B, T), bool))

    @staticmethod
    def cat(conditions):
        """One condition per item, each [1, T_i, D] -> [B, max T, D], the
        shorter ones padded with masked rows."""
        ref = np.asarray(conditions[0].tensor)
        T = max(c.tensor.shape[1] for c in conditions)
        tensor = np.zeros((len(conditions), T, ref.shape[-1]), ref.dtype)
        mask = np.zeros((len(conditions), T), bool)
        for b, c in enumerate(conditions):
            tensor[b, :c.tensor.shape[1]] = np.asarray(c.tensor)[0]
            mask[b, :c.mask.shape[1]] = np.asarray(c.mask)[0]
        return TensorCondition(tensor, mask)


@dataclass
class ConditionAttributes:
    text: dict = field(default_factory=dict)     # name -> str | None
    tensor: dict = field(default_factory=dict)   # name -> TensorCondition

    def copy(self):
        return ConditionAttributes(dict(self.text), dict(self.tensor))


def dropout_all_conditions(attributes):
    """The null variant of each item: every text value None, every tensor
    zeros with an all-False mask."""
    out = []
    for a in attributes:
        a = a.copy()
        a.text = {k: None for k in a.text}
        a.tensor = {k: TensorCondition(np.zeros_like(v.tensor), np.zeros_like(v.mask))
                    for k, v in a.tensor.items()}
        out.append(a)
    return out


def hash_trick(word: str, vocab_size: int) -> int:
    h = int(hashlib.sha256(word.encode("utf-8")).hexdigest(), 16)
    return h % vocab_size


def _project(params: dict, x: torch.Tensor, mask) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, dim] @ output_proj, the learnt padding where mask [B, T] is
    False.  Returns (condition [B, T, output_dim], mask on the device)."""
    w = params["output_proj"]
    dt = torch.promote_types(x.dtype, w.dtype)  # jnp's promotion of the two
    cond = torch.matmul(x.to(dt), w.to(dt))
    mask = torch.as_tensor(mask, device=w.device)
    maskf = mask.to(torch.float32)[..., None]
    return cond * maskf + params["learnt_padding"] * (1 - maskf), mask


class LUTConditioner:
    """Params: {"embed": [n_bins + 1, dim], "output_proj": [dim, output_dim],
    "learnt_padding": [1, 1, output_dim]}.  A None value takes the pad row
    (index n_bins) and the learnt padding."""

    kind = "text"

    def __init__(self, output_dim: int, n_bins: int, dim: int, tokenizer: str = "noop",
                 possible_values: list[str] | None = None, init_scale: float = 1.0):
        if tokenizer != "noop":
            raise ValueError(f"LUT tokenizer {tokenizer!r} (only 'noop' is supported)")
        self.n_bins, self.dim, self.output_dim = n_bins, dim, output_dim
        self.init_scale = init_scale
        self.pad_idx = n_bins
        self.possible_values = (None if possible_values is None
                                else {v: i for i, v in enumerate(possible_values)})

    def init_params(self, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
        """The distributions of moshi_tpu's init_params, drawn from a torch
        generator."""
        return {
            "embed": normal(generator, (self.n_bins + 1, self.dim), dtype, device)
            * self.init_scale,
            "output_proj": normal(generator, (self.dim, self.output_dim), dtype, device)
            / math.sqrt(self.dim),
            "learnt_padding": normal(generator, (1, 1, self.output_dim), dtype, device) * 0.2,
        }

    def prepare(self, texts: list) -> tuple[np.ndarray, np.ndarray]:
        """-> (tokens [B, 1] int32, mask [B, 1] bool)."""
        tokens, present = [], []
        for t in texts:
            if t is None:
                tokens.append(self.pad_idx)
            elif self.possible_values is not None:
                if t not in self.possible_values:
                    raise ValueError(f"{t!r} not in possible_values")
                tokens.append(self.possible_values[t])
            else:
                tokens.append(hash_trick(t, self.n_bins))
            present.append(t is not None)
        return np.asarray(tokens, np.int32)[:, None], np.asarray(present, bool)[:, None]

    def apply(self, params: dict, prepared) -> tuple[torch.Tensor, torch.Tensor]:
        tokens, mask = prepared
        table = params["embed"]
        emb = table[torch.as_tensor(tokens, dtype=torch.long, device=table.device)]
        return _project(params, emb, mask)


class ContinuousAttributeConditioner:
    """Sinusoidal embedding of a continuous scalar, projected to the model
    width: value * scale_factor -> cat(cos, sin) over `dim` channels ->
    output_proj; a None value takes the learnt padding vector."""

    kind = "text"  # values arrive as strings, e.g. "2.5"

    def __init__(self, output_dim: int, dim: int, scale_factor: float,
                 max_period: float = 10_000.0):
        self.output_dim = output_dim
        self.dim = dim
        self.scale_factor = scale_factor
        self.max_period = max_period

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
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
        dev = params["output_proj"].device
        vals, mask = prepared
        half = self.dim // 2
        positions = torch.as_tensor(vals, device=dev) * self.scale_factor
        adim = (1.0 / self.max_period ** (torch.arange(half, dtype=torch.float32, device=dev)
                                          / (half - 1))).reshape(1, 1, -1)
        freqs = positions * adim
        return _project(params, torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1), mask)


class TensorConditioner:
    """A given tensor [B, T, dim] projected to the model width, the learnt
    padding on masked rows."""

    kind = "tensor"

    def __init__(self, output_dim: int, dim: int):
        self.dim = dim
        self.output_dim = output_dim

    def init_params(self, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
        return {
            "output_proj": normal(generator, (self.dim, self.output_dim), dtype, device)
            / math.sqrt(self.dim),
            "learnt_padding": normal(generator, (1, 1, self.output_dim), dtype, device) * 0.2,
        }

    def prepare(self, cond: TensorCondition) -> tuple[np.ndarray, np.ndarray]:
        return np.asarray(cond.tensor), np.asarray(cond.mask)

    def apply(self, params: dict, prepared) -> tuple[torch.Tensor, torch.Tensor]:
        tensor, mask = prepared
        w = params["output_proj"]
        return _project(params, torch.as_tensor(tensor, device=w.device), mask)


class ConditionProvider:
    """Named conditioners and their parameter trees."""

    def __init__(self, conditioners: dict):
        self.conditioners = conditioners

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        return {name: c.init_params(generator, dtype, device)
                for name, c in self.conditioners.items()}

    def prepare(self, attributes: list) -> dict:
        """Host side: each conditioner's input for a batch of
        ConditionAttributes."""
        prepared = {}
        for name, cond in self.conditioners.items():
            if cond.kind == "text":
                prepared[name] = cond.prepare([a.text[name] for a in attributes])
            else:
                prepared[name] = cond.prepare(
                    TensorCondition.cat([a.tensor[name] for a in attributes]))
        return prepared

    def apply(self, params: dict, prepared: dict) -> dict:
        """name -> (condition [B, T, output_dim], mask [B, T])."""
        return {name: self.conditioners[name].apply(params[name], p)
                for name, p in prepared.items()}

    def prepare_and_provide(self, params: dict, attributes: list) -> dict:
        return self.apply(params, self.prepare(attributes))


class ConditionFuser:
    """Which conditions are summed into the inputs and which are attended."""

    def __init__(self, fuse2cond: dict):
        self.fuse2cond = {k: list(v) for k, v in fuse2cond.items()}
        for method in ("sum", "cross", "prepend"):
            self.fuse2cond.setdefault(method, [])
        if self.fuse2cond["prepend"]:
            raise ValueError("prepend fusing is not supported (no released model uses it)")

    @property
    def has_conditions(self) -> bool:
        return bool(self.fuse2cond["sum"] or self.fuse2cond["cross"])

    def get_sum(self, condition_tensors: dict) -> torch.Tensor | None:
        """The sum of the "sum" conditions, [B, 1, dim], or None."""
        total = None
        for name in self.fuse2cond["sum"]:
            cond, _ = condition_tensors[name]
            if cond.shape[1] != 1:
                raise ValueError(f"a summed condition has {cond.shape[1]} steps, not 1")
            total = cond if total is None else total + cond
        return total

    def get_cross(self, condition_tensors: dict) -> torch.Tensor | None:
        """The "cross" conditions concatenated along time, [B, Ts, dim], or
        None."""
        conds = [condition_tensors[name][0] for name in self.fuse2cond["cross"]]
        return torch.cat(conds, dim=1) if conds else None


def conditioners_from_config(output_dim: int, cfg: dict) -> ConditionProvider:
    """A provider from the `conditioners` block of a checkpoint's
    config.json (moshi_tpu/conditioners.py `conditioners_from_config`)."""
    conds = {}
    for name, ccfg in cfg.items():
        ctype = ccfg["type"]
        kwargs = dict(ccfg[ctype])
        if ctype == "lut":
            conds[name] = LUTConditioner(output_dim=output_dim, **kwargs)
        elif ctype == "tensor":
            conds[name] = TensorConditioner(output_dim=output_dim, **kwargs)
        elif ctype in ("continuous_attribute", "ContinuousAttribute"):
            conds[name] = ContinuousAttributeConditioner(output_dim=output_dim, **kwargs)
        else:
            raise ValueError(f"unknown conditioner type {ctype}")
    return ConditionProvider(conds)
