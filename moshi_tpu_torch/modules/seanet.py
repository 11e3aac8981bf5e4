"""SEANet streaming encoder/decoder (counterpart of
moshi_tpu/modules/seanet.py), built from the streaming convs in conv.py.
Parameters and state are lists aligned with a static plan of items, as in
the JAX package, so its trees convert one to one.  ELU activations (the
only ones Mimi uses); the convolutions pad with zeros or, with
`pad_mode="replicate"`, with their input's first step; a residual block's
skip is the identity or, with `true_skip=False`, a 1x1 shortcut
convolution (moshi_tpu seanet.py:59-107)."""

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
    pad_mode: str = "constant"  # constant | replicate
    true_skip: bool = True      # False: a 1x1 shortcut conv on each residual skip

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.ratios:
            h *= r
        return h


@dataclass(frozen=True)
class _ResBlock:
    """SEANetResnetBlock: each conv preceded by ELU; the skip is the
    identity, or the 1x1 `shortcut` conv when there is one."""
    convs: tuple[StreamingConv1d, ...]
    shortcut: StreamingConv1d | None = None

    def init_params(self, generator, dtype, device):
        p = {"block": [c.init_params(generator, dtype, device) for c in self.convs]}
        if self.shortcut is not None:
            p["shortcut"] = self.shortcut.init_params(generator, dtype, device)
        return p

    def init_state(self, B, dtype, device):
        s = {"block": [c.init_state(B, dtype, device) for c in self.convs]}
        if self.shortcut is not None:
            s["shortcut"] = self.shortcut.init_state(B, dtype, device)
        return s

    def apply(self, params, x):
        y = x
        for c, p in zip(self.convs, params["block"]):
            y = c.apply(p, F.elu(y))
        if self.shortcut is not None:
            x = self.shortcut.apply(params["shortcut"], x)
        return x + y

    def step(self, params, state, x, exec_mask=None):
        y = x
        for c, p, s in zip(self.convs, params["block"], state["block"]):
            y, _ = c.step(p, s, F.elu(y), exec_mask)
        if self.shortcut is not None:
            x, _ = self.shortcut.step(params["shortcut"], state["shortcut"], x, exec_mask)
        return x + y, state


def _make_resblock(cfg: SEANetConfig, dim: int, dilation: int) -> _ResBlock:
    hidden = dim // cfg.compress
    pad = cfg.pad_mode
    return _ResBlock((StreamingConv1d(dim, hidden, cfg.residual_kernel_size,
                                      dilation=dilation, pad_mode=pad),
                      StreamingConv1d(hidden, dim, 1, pad_mode=pad)),
                     None if cfg.true_skip else StreamingConv1d(dim, dim, 1, pad_mode=pad))


def _torch_indices(items: list) -> list[int]:
    """Each item's index in the reference's nn.Sequential, where every
    activation before a conv takes a slot of its own (the module names of a
    PyTorch checkpoint, models/loaders.py)."""
    out, i = [], 0
    for _, _, pre_act in items:
        i += pre_act
        out.append(i)
        i += 1
    return out


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

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Offline forward, equal to streaming from a fresh state."""
        for (_, mod, pre_act), p in zip(self.items, params["model"]):
            x = mod.apply(p, F.elu(x) if pre_act else x)
        return x

    def step(self, params: dict, state: dict, x: torch.Tensor,
             exec_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """exec_mask [B] bool: slots that advance their conv state (all by
        default); see conv.py."""
        for (_, mod, pre_act), p, s in zip(self.items, params["model"], state["model"]):
            if pre_act:
                x = F.elu(x)
            x, _ = mod.step(p, s, x, exec_mask)
        return x, state


class SEANetEncoder(_SEANetBase):
    """[B, T, channels] -> latent [B, T/hop, dimension]."""

    def __init__(self, config: SEANetConfig):
        self.config = cfg = config
        mult = 1
        items: list = [("conv", StreamingConv1d(cfg.channels, cfg.n_filters,
                                                cfg.kernel_size, pad_mode=cfg.pad_mode), False)]
        for ratio in reversed(cfg.ratios):
            for j in range(cfg.n_residual_layers):
                items.append(("block", _make_resblock(cfg, mult * cfg.n_filters,
                                                      cfg.dilation_base ** j), False))
            items.append(("conv", StreamingConv1d(mult * cfg.n_filters,
                                                  mult * cfg.n_filters * 2, ratio * 2,
                                                  stride=ratio, pad_mode=cfg.pad_mode), True))
            mult *= 2
        items.append(("conv", StreamingConv1d(mult * cfg.n_filters, cfg.dimension,
                                              cfg.last_kernel_size, pad_mode=cfg.pad_mode),
                      True))
        self.items = items
        self.torch_indices = _torch_indices(items)


class SEANetDecoder(_SEANetBase):
    """latent [B, T, dimension] -> [B, T*hop, channels]."""

    def __init__(self, config: SEANetConfig):
        self.config = cfg = config
        mult = int(2 ** len(cfg.ratios))
        items: list = [("conv", StreamingConv1d(cfg.dimension, mult * cfg.n_filters,
                                                cfg.kernel_size, pad_mode=cfg.pad_mode), False)]
        for ratio in cfg.ratios:
            items.append(("convtr", StreamingConvTranspose1d(
                mult * cfg.n_filters, mult * cfg.n_filters // 2, ratio * 2,
                stride=ratio), True))
            for j in range(cfg.n_residual_layers):
                items.append(("block", _make_resblock(cfg, mult * cfg.n_filters // 2,
                                                      cfg.dilation_base ** j), False))
            mult //= 2
        items.append(("conv", StreamingConv1d(cfg.n_filters, cfg.channels,
                                              cfg.last_kernel_size, pad_mode=cfg.pad_mode),
                      True))
        self.items = items
        self.torch_indices = _torch_indices(items)
