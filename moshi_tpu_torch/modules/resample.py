"""Strided resampling between the encoder rate and the token rate
(counterpart of moshi_tpu/modules/resample.py).

Mimi uses the learnt path.  `ConvTrUpsample1d(channel_wise=True)` is a
depthwise transposed conv: it reproduces the reference's
`upsample_channel_wise_bug`, which the released Mimi checkpoint was trained
with.  The non-learnt path (`learnt=False`) runs every channel through one
fixed single-channel filter, as B*C rows of one channel; its per-slot
`exec_mask` [B] is repeated per channel to match those rows."""

from dataclasses import dataclass

import torch

from .conv import StreamingConv1d, StreamingConvTranspose1d


def _to_rows(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B*C, T, 1]."""
    B, T, C = x.shape
    return x.transpose(1, 2).reshape(B * C, T, 1)


def _from_rows(y: torch.Tensor, B: int) -> torch.Tensor:
    """[B*C, T, 1] -> [B, T, C]."""
    return y.reshape(B, -1, y.shape[1]).transpose(1, 2)


def _row_mask(exec_mask, C: int):
    return None if exec_mask is None else exec_mask.repeat_interleave(C)


@dataclass(frozen=True)
class ConvDownsample1d:
    """Stride-S causal conv, K = 2S, replicate padding, no bias; when not
    learnt, a moving average over each channel."""
    stride: int
    dimension: int
    learnt: bool = True

    @property
    def conv(self) -> StreamingConv1d:
        C = self.dimension if self.learnt else 1
        return StreamingConv1d(C, C, 2 * self.stride, stride=self.stride, bias=False,
                               pad_mode="replicate")

    def init_params(self, generator: torch.Generator, dtype=torch.float32, device=None):
        if self.learnt:
            return self.conv.init_params(generator, dtype, device)
        K = 2 * self.stride
        return {"weight": torch.full((1, 1, K), 1.0 / K, dtype=dtype, device=device)}

    def init_state(self, batch_size: int, dtype=torch.float32, device=None):
        B = batch_size if self.learnt else batch_size * self.dimension
        return self.conv.init_state(B, dtype, device)

    def apply(self, params, x):
        """Offline forward of x [B, T, C]."""
        if self.learnt:
            return self.conv.apply(params, x)
        return _from_rows(self.conv.apply(params, _to_rows(x)), x.shape[0])

    def step(self, params, state, x, exec_mask=None):
        if self.learnt:
            return self.conv.step(params, state, x, exec_mask)
        y, _ = self.conv.step(params, state, _to_rows(x), _row_mask(exec_mask, x.shape[2]))
        return _from_rows(y, x.shape[0]), state


@dataclass(frozen=True)
class ConvTrUpsample1d:
    """Stride-S transposed conv, K = 2S, no bias; when not learnt, a filter
    of ones over each channel normalized by its response to ones, which
    streams through a second state (moshi_tpu resample.py:87-121)."""
    stride: int
    dimension: int
    channel_wise: bool = False
    learnt: bool = True

    @property
    def convtr(self) -> StreamingConvTranspose1d:
        C = self.dimension if self.learnt else 1
        return StreamingConvTranspose1d(C, C, 2 * self.stride, stride=self.stride,
                                        groups=C if self.channel_wise else 1, bias=False)

    def init_params(self, generator: torch.Generator, dtype=torch.float32, device=None):
        if self.learnt:
            return self.convtr.init_params(generator, dtype, device)
        return {"weight": torch.ones((1, 1, 2 * self.stride), dtype=dtype, device=device)}

    def init_state(self, batch_size: int, dtype=torch.float32, device=None):
        if self.learnt:
            return self.convtr.init_state(batch_size, dtype, device)
        B = batch_size * self.dimension
        return {"conv": self.convtr.init_state(B, dtype, device),
                "norm": self.convtr.init_state(B, dtype, device)}

    def apply(self, params, x):
        """Offline forward of x [B, T, C]; when not learnt, normalized by
        the offline response to ones."""
        if self.learnt:
            return self.convtr.apply(params, x)
        xr = _to_rows(x)
        norm = self.convtr.apply(params, torch.ones_like(xr[:1]))
        return _from_rows(self.convtr.apply(params, xr) / norm, x.shape[0])

    def step(self, params, state, x, exec_mask=None):
        if self.learnt:
            return self.convtr.step(params, state, x, exec_mask)
        xr, mask = _to_rows(x), _row_mask(exec_mask, x.shape[2])
        y, _ = self.convtr.step(params, state["conv"], xr, mask)
        norm, _ = self.convtr.step(params, state["norm"], torch.ones_like(xr), mask)
        return _from_rows(y / norm, x.shape[0]), state
