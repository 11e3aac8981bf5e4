"""Normalization layers (counterpart of moshi_tpu/modules/norm.py), with
the same numerics:
- `layer_norm`: eps 1e-5, computed in the input dtype;
- `layer_norm_f32`: eps 1e-8, input upcast to f32;
- `rms_norm`: eps 1e-5 inside the mean (`var = eps + mean(x^2)`);
- `rms_norm_f32`: eps 1e-8, computed in f32.
"""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LayerNorm:
    dim: int
    eps: float = 1e-5
    f32: bool = False

    def init_params(self, dtype=torch.float32, device=None) -> dict:
        dt = torch.float32 if self.f32 else dtype
        return {"scale": torch.ones(self.dim, dtype=dt, device=device),
                "bias": torch.zeros(self.dim, dtype=dt, device=device)}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        if self.f32:
            x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        y = y * params["scale"].to(y.dtype)
        if "bias" in params:
            y = y + params["bias"].to(y.dtype)
        return y.to(dtype)


@dataclass(frozen=True)
class RMSNorm:
    dim: int
    eps: float = 1e-5
    f32: bool = False

    def init_params(self, dtype=torch.float32, device=None) -> dict:
        dt = torch.float32 if self.f32 else dtype
        return {"scale": torch.ones(self.dim, dtype=dt, device=device)}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        if self.f32:
            x = x.float()
        var = self.eps + x.square().mean(dim=-1, keepdim=True)
        y = x * (params["scale"].to(x.dtype) * torch.rsqrt(var))
        return y.to(dtype)


def make_norm(norm_type: str, dim: int):
    """Mirror of the reference `create_norm_fn`."""
    if norm_type == "layer_norm":
        return LayerNorm(dim, eps=1e-5)
    if norm_type == "layer_norm_f32":
        return LayerNorm(dim, eps=1e-8, f32=True)
    if norm_type == "rms_norm":
        return RMSNorm(dim, eps=1e-5)
    if norm_type == "rms_norm_f32":
        return RMSNorm(dim, eps=1e-8, f32=True)
    raise ValueError(f"unknown norm type {norm_type}")


@dataclass(frozen=True)
class LayerScale:
    """Diagonal residual-branch rescale."""

    channels: int
    init: float = 1e-4

    def init_params(self, dtype=torch.float32, device=None) -> dict:
        return {"scale": torch.full((self.channels,), self.init, dtype=dtype,
                                    device=device)}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return params["scale"].to(x.dtype) * x
