"""Learnt strided resampling between the encoder rate and the token rate
(counterpart of moshi_tpu/modules/resample.py, learnt path).

`ConvTrUpsample1d(channel_wise=True)` is a depthwise transposed conv: it
reproduces the reference's `upsample_channel_wise_bug`, which the released
Mimi checkpoint was trained with."""

from dataclasses import dataclass

import torch

from .conv import StreamingConv1d, StreamingConvTranspose1d


@dataclass(frozen=True)
class ConvDownsample1d:
    """Stride-S causal conv, K = 2S, replicate padding, no bias."""
    stride: int
    dimension: int

    @property
    def conv(self) -> StreamingConv1d:
        return StreamingConv1d(self.dimension, self.dimension, 2 * self.stride,
                               stride=self.stride, bias=False, pad_mode="replicate")

    def init_params(self, generator: torch.Generator, dtype=torch.float32, device=None):
        return self.conv.init_params(generator, dtype, device)

    def init_state(self, batch_size: int, dtype=torch.float32, device=None):
        return self.conv.init_state(batch_size, dtype, device)

    def step(self, params, state, x):
        return self.conv.step(params, state, x)


@dataclass(frozen=True)
class ConvTrUpsample1d:
    """Stride-S transposed conv, K = 2S, no bias."""
    stride: int
    dimension: int
    channel_wise: bool = False

    @property
    def convtr(self) -> StreamingConvTranspose1d:
        return StreamingConvTranspose1d(self.dimension, self.dimension, 2 * self.stride,
                                        stride=self.stride,
                                        groups=self.dimension if self.channel_wise else 1,
                                        bias=False)

    def init_params(self, generator: torch.Generator, dtype=torch.float32, device=None):
        return self.convtr.init_params(generator, dtype, device)

    def init_state(self, batch_size: int, dtype=torch.float32, device=None):
        return self.convtr.init_state(batch_size, dtype, device)

    def step(self, params, state, x):
        return self.convtr.step(params, state, x)
