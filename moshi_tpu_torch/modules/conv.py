"""Streaming causal 1D convolutions (counterpart of
moshi_tpu/modules/conv.py).

Activations are [B, T, C] at every public function, as in the JAX package;
each call transposes to the [B, C, T] that F.conv1d takes.  Weights are in
PyTorch's layout: [Cout, Cin/groups, K] for a convolution and
[Cin, Cout/groups, K] for a transposed one (`conv_from_jax` and
`convtr_from_jax` convert the JAX package's [K, Cin/groups, Cout]).  State
tails are preallocated and updated in place.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..utils.params import uniform


def conv_from_jax(w: torch.Tensor) -> torch.Tensor:
    """[K, Cin/g, Cout] (JAX WIO) -> [Cout, Cin/g, K]."""
    return w.permute(2, 1, 0).contiguous()


def convtr_from_jax(w: torch.Tensor, groups: int) -> torch.Tensor:
    """The JAX package's transposed-conv weight [K, Cin/g, Cout], where
    w[k, i, j*Cout/g + o] is the tap k of input channel j*Cin/g + i to output
    channel o of group j, -> PyTorch's [Cin, Cout/g, K]."""
    K, cin_g, cout = w.shape
    w = w.reshape(K, cin_g, groups, cout // groups)
    return w.permute(2, 1, 3, 0).reshape(groups * cin_g, cout // groups, K).contiguous()


def _init(generator, shape, fan_in, bias_dim, dtype, device) -> dict:
    bound = 1.0 / math.sqrt(fan_in)
    p = {"weight": uniform(generator, shape, bound, dtype, device)}
    if bias_dim:
        p["bias"] = uniform(generator, (bias_dim,), bound, dtype, device)
    return p


@dataclass(frozen=True)
class StreamingConv1d:
    """Causal streaming Conv1d.  Input steps must be a multiple of `stride`."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    pad_mode: str = "constant"  # constant | replicate

    @property
    def state_len(self) -> int:
        return (self.kernel_size - 1) * self.dilation + 1 - self.stride

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        cin_g = self.in_channels // self.groups
        return _init(generator, (self.out_channels, cin_g, self.kernel_size),
                     cin_g * self.kernel_size,
                     self.out_channels if self.bias else 0, dtype, device)

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        state = {}
        if self.state_len > 0:
            state["prev"] = torch.zeros(batch_size, self.state_len, self.in_channels,
                                        dtype=dtype, device=device)
            if self.pad_mode == "replicate":
                state["first"] = torch.ones(batch_size, dtype=torch.bool, device=device)
        return state

    def _conv(self, params, x):
        y = F.conv1d(x.transpose(1, 2), params["weight"].to(x.dtype),
                     params["bias"].to(x.dtype) if "bias" in params else None,
                     stride=self.stride, dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)

    def step(self, params: dict, state: dict, x: torch.Tensor
             ) -> tuple[torch.Tensor, dict]:
        T = x.shape[1]
        if T == 0 or T % self.stride:
            raise ValueError("steps must be a positive multiple of stride")
        if self.state_len == 0:
            return self._conv(params, x), state
        prev = state["prev"]
        if self.pad_mode == "replicate":
            prev = torch.where(state["first"].view(-1, 1, 1),
                               x[:, :1].to(prev.dtype), prev)
            state["first"].fill_(False)
        full = torch.cat([prev.to(x.dtype), x], dim=1)
        y = self._conv(params, full)
        state["prev"].copy_(full[:, -self.state_len:])
        return y, state


@dataclass(frozen=True)
class StreamingConvTranspose1d:
    """Causal streaming ConvTranspose1d with an overlap-add tail."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    groups: int = 1
    bias: bool = True

    @property
    def state_len(self) -> int:
        return self.kernel_size - self.stride

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        cin_g = self.in_channels // self.groups
        return _init(generator, (self.in_channels, self.out_channels // self.groups,
                                 self.kernel_size),
                     cin_g * self.kernel_size,
                     self.out_channels if self.bias else 0, dtype, device)

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        if self.state_len == 0:
            return {}
        return {"partial": torch.zeros(batch_size, self.state_len, self.out_channels,
                                       dtype=dtype, device=device)}

    def step(self, params: dict, state: dict, x: torch.Tensor
             ) -> tuple[torch.Tensor, dict]:
        T = x.shape[1]
        bias = params["bias"].to(x.dtype) if "bias" in params else None
        # full (untrimmed) output: (T - 1) * stride + K steps
        y = F.conv_transpose1d(x.transpose(1, 2), params["weight"].to(x.dtype), bias,
                               stride=self.stride, groups=self.groups).transpose(1, 2)
        PT = self.state_len
        if PT == 0:
            return y, state
        y[:, :PT] += state["partial"].to(y.dtype)
        tail = y[:, T * self.stride:]
        if bias is not None:
            tail = tail - bias
        state["partial"].copy_(tail)
        return y[:, :T * self.stride], state
