"""SEANet streaming encoder/decoder (counterpart of
moshi_tpu/modules/seanet.py), built from the streaming convs in conv.py.
Parameters and state are lists aligned with a static plan of items, as in
the JAX package, so its trees convert one to one.  Mimi's settings only:
ELU activations, constant padding, identity skips."""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .conv import StreamingConv1d, StreamingConvTranspose1d


@dataclass(frozen=True)
class SEANetConfig:
    channels: int = 1
    dimension: int = 512
    n_filters: int = 64
    n_residual_layers: int = 1
    ratios: tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    residual_kernel_size: int = 3
    last_kernel_size: int = 3
    dilation_base: int = 2
    compress: int = 2

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.ratios:
            h *= r
        return h


@dataclass(frozen=True)
class _ResBlock:
    """SEANetResnetBlock: each conv preceded by ELU; identity skip."""
    convs: tuple[StreamingConv1d, ...]

    def init_params(self, generator, dtype, device):
        return {"block": [c.init_params(generator, dtype, device) for c in self.convs]}

    def init_state(self, B, dtype, device):
        return {"block": [c.init_state(B, dtype, device) for c in self.convs]}

    def step(self, params, state, x):
        y = x
        for c, p, s in zip(self.convs, params["block"], state["block"]):
            y, _ = c.step(p, s, F.elu(y))
        return x + y, state


def _make_resblock(cfg: SEANetConfig, dim: int, dilation: int) -> _ResBlock:
    hidden = dim // cfg.compress
    return _ResBlock((StreamingConv1d(dim, hidden, cfg.residual_kernel_size,
                                      dilation=dilation),
                      StreamingConv1d(hidden, dim, 1)))


class _SEANetBase:
    """`self.items` is a list of (kind, module, pre_act), kind in
    {conv, convtr, block}."""

    config: SEANetConfig
    items: list

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        return {"model": [mod.init_params(generator, dtype, device)
                          for _, mod, _ in self.items]}

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        return {"model": [mod.init_state(batch_size, dtype, device)
                          for _, mod, _ in self.items]}

    def step(self, params: dict, state: dict, x: torch.Tensor
             ) -> tuple[torch.Tensor, dict]:
        for (_, mod, pre_act), p, s in zip(self.items, params["model"], state["model"]):
            if pre_act:
                x = F.elu(x)
            x, _ = mod.step(p, s, x)
        return x, state


class SEANetEncoder(_SEANetBase):
    """[B, T, channels] -> latent [B, T/hop, dimension]."""

    def __init__(self, config: SEANetConfig):
        self.config = cfg = config
        mult = 1
        items: list = [("conv", StreamingConv1d(cfg.channels, cfg.n_filters,
                                                cfg.kernel_size), False)]
        for ratio in reversed(cfg.ratios):
            for j in range(cfg.n_residual_layers):
                items.append(("block", _make_resblock(cfg, mult * cfg.n_filters,
                                                      cfg.dilation_base ** j), False))
            items.append(("conv", StreamingConv1d(mult * cfg.n_filters,
                                                  mult * cfg.n_filters * 2, ratio * 2,
                                                  stride=ratio), True))
            mult *= 2
        items.append(("conv", StreamingConv1d(mult * cfg.n_filters, cfg.dimension,
                                              cfg.last_kernel_size), True))
        self.items = items


class SEANetDecoder(_SEANetBase):
    """latent [B, T, dimension] -> [B, T*hop, channels]."""

    def __init__(self, config: SEANetConfig):
        self.config = cfg = config
        mult = int(2 ** len(cfg.ratios))
        items: list = [("conv", StreamingConv1d(cfg.dimension, mult * cfg.n_filters,
                                                cfg.kernel_size), False)]
        for ratio in cfg.ratios:
            items.append(("convtr", StreamingConvTranspose1d(
                mult * cfg.n_filters, mult * cfg.n_filters // 2, ratio * 2,
                stride=ratio), True))
            for j in range(cfg.n_residual_layers):
                items.append(("block", _make_resblock(cfg, mult * cfg.n_filters // 2,
                                                      cfg.dilation_base ** j), False))
            mult //= 2
        items.append(("conv", StreamingConv1d(cfg.n_filters, cfg.channels,
                                              cfg.last_kernel_size), True))
        self.items = items
