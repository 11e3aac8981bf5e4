"""Rotary position embedding (counterpart of moshi_tpu/modules/rope.py):
rotation in f32, frequencies `exp(arange(D/2) * (-log(max_period) * 2 / D))`,
per-batch integer offsets, interleaved ([r0, i0, r1, i1, ...]) or
concatenated ([r..., i...]) halves."""

import math

import torch


def apply_rope(q: torch.Tensor, k: torch.Tensor, offset: torch.Tensor, *,
               max_period: float = 10_000.0, interleave: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: [B, H, T, D]; offset: [B] integer positions of the first step."""
    B, H, T, D = q.shape
    dtype = q.dtype
    ds = torch.arange(D // 2, dtype=torch.float32, device=q.device)
    freqs = torch.exp(ds * (-math.log(max_period) * 2 / D))
    ts = offset.float().reshape(-1, 1) + torch.arange(T, dtype=torch.float32,
                                                      device=q.device)
    ts = ts.reshape(B, 1, T, 1)
    rotr = torch.cos(freqs * ts)  # [B, 1, T, D/2]
    roti = torch.sin(freqs * ts)

    def rotate(x):
        if interleave:
            xr, xi = x[..., 0::2].float(), x[..., 1::2].float()
        else:
            xr, xi = x[..., :D // 2].float(), x[..., D // 2:].float()
        yr = xr * rotr - xi * roti
        yi = xr * roti + xi * rotr
        if interleave:
            return torch.stack([yr.to(dtype), yi.to(dtype)], dim=-1).reshape(x.shape)
        return torch.cat([yr.to(dtype), yi.to(dtype)], dim=-1)

    return rotate(q), rotate(k)
