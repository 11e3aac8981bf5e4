"""Streaming causal 1D convolutions (counterpart of
moshi_tpu/modules/conv.py).

Activations are [B, T, C] at every public function, as in the JAX package;
each call transposes to the [B, C, T] that F.conv1d takes.  Weights are in
PyTorch's layout: [Cout, Cin/groups, K] for a convolution and
[Cin, Cout/groups, K] for a transposed one (`conv_from_jax` and
`convtr_from_jax` convert the JAX package's [K, Cin/groups, Cout]).  State
tails are preallocated and updated in place.

`apply` is the offline forward, equal to streaming from a fresh state: a
convolution is left-padded by its state length (edge values for
`replicate`, zeros otherwise), a transposed convolution's output is
trimmed to T * stride on the right (moshi_tpu conv.py:118-124, 184-189).

`exec_mask` [B] bool is the per-slot freeze of batched serving: a slot whose
entry is False computes an output but keeps its state (moshi_tpu
conv.py:126-148, 191-207).  The masked updates go through `torch.where`
into the preallocated state.
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


def conv_to_jax(w: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin/g, K] -> the JAX package's [K, Cin/g, Cout]."""
    return w.permute(2, 1, 0).contiguous()


def convtr_to_jax(w: torch.Tensor, groups: int) -> torch.Tensor:
    """PyTorch's [Cin, Cout/g, K] -> the JAX package's [K, Cin/g, Cout]
    (the inverse of convtr_from_jax)."""
    cin, cout_g, K = w.shape
    w = w.reshape(groups, cin // groups, cout_g, K)
    return w.permute(3, 1, 0, 2).reshape(K, cin // groups, groups * cout_g).contiguous()


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
        """x [B, T, C] -> [B, T', Cout], no padding."""
        return self._conv_ct(params, x.transpose(1, 2)).transpose(1, 2)

    def _conv_ct(self, params, xt):
        return F.conv1d(xt, params["weight"].to(xt.dtype),
                        params["bias"].to(xt.dtype) if "bias" in params else None,
                        stride=self.stride, dilation=self.dilation, groups=self.groups)

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Offline forward of x [B, T, C]: the causal left pad of state_len
        steps, then the convolution."""
        xt = x.transpose(1, 2)
        n = self.state_len
        if n > 0:
            pad = (xt[..., :1].expand(-1, -1, n) if self.pad_mode == "replicate"
                   else xt.new_zeros(xt.shape[0], xt.shape[1], n))
            xt = torch.cat([pad, xt], dim=-1)
        return self._conv_ct(params, xt).transpose(1, 2)

    def step(self, params: dict, state: dict, x: torch.Tensor,
             exec_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        T = x.shape[1]
        if T == 0 or T % self.stride:
            raise ValueError("steps must be a positive multiple of stride")
        if self.state_len == 0:
            return self._conv(params, x), state
        m = None if exec_mask is None else exec_mask.view(-1, 1, 1)
        prev = state["prev"]
        if self.pad_mode == "replicate":
            first = state["first"].view(-1, 1, 1)
            prev = torch.where(first if m is None else first & m,
                               x[:, :1].to(prev.dtype), prev)
            if exec_mask is None:
                state["first"].fill_(False)
            else:
                state["first"].masked_fill_(exec_mask, False)
        full = torch.cat([prev.to(x.dtype), x], dim=1)
        y = self._conv(params, full)
        tail = full[:, -self.state_len:]
        if m is not None:
            tail = torch.where(m, tail.to(prev.dtype), state["prev"])
        state["prev"].copy_(tail)
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

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Offline forward of x [B, T, C]: the first T * stride steps of the
        full transposed convolution."""
        bias = params["bias"].to(x.dtype) if "bias" in params else None
        y = F.conv_transpose1d(x.transpose(1, 2), params["weight"].to(x.dtype), bias,
                               stride=self.stride, groups=self.groups)
        return y[..., :x.shape[1] * self.stride].transpose(1, 2)

    def step(self, params: dict, state: dict, x: torch.Tensor,
             exec_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
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
        if exec_mask is not None:
            tail = torch.where(exec_mask.view(-1, 1, 1), tail.to(state["partial"].dtype),
                               state["partial"])
        state["partial"].copy_(tail)
        return y[:, :T * self.stride], state
