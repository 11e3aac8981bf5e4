"""Streaming transformer with a ring KV cache (counterpart of
moshi_tpu/modules/transformer.py), bf16/f32 KV path.

- Layer parameters are stacked on a leading [L, ...] axis; per-step weights
  (the depformer) on a [W, ...] axis after it.  Layer l's weights are views
  `w[l]`, so a q4 or int8 member goes to its GEMV kernel without a copy.
- Streaming state is a dict of preallocated tensors {k, v, offset}, updated
  in place: the new K/V rows are written into the ring at `offset % cap`
  (moshi_tpu transformer.py:719-723) and `offset` advances after the step.
  In place takes the role of the JAX package's donated buffers.

Not ported yet: int8/int4 KV caches, cross-attention, exec_mask (per-slot
freeze for batched serving), sinusoidal position embeddings and the offline
`apply`.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .norm import LayerScale, make_norm
from .rope import apply_rope
from ..utils.matmul import wdot
from ..utils.params import trunc_normal


def gating_hidden_dim(dim: int, dim_feedforward: int) -> int:
    """Hidden width of the SiLU-gated FFN."""
    if dim_feedforward == 4 * dim:
        return 21 * dim // 8
    return 2 * dim_feedforward // 3


def _per_step_linear(w, x: torch.Tensor, idx) -> torch.Tensor:
    """Apply stacked per-step weights w [W, din, dout] to x [B, T, din];
    idx: the weight index of each of the T positions (unused when W == 1)."""
    if w.shape[0] == 1:
        return wdot(x, w[0])
    if idx is None or len(idx) != 1:
        raise NotImplementedError("per-step weights over several steps "
                                  "(the offline path) are not ported")
    return wdot(x, w[idx[0]])


def ring_positions(offset: torch.Tensor, T: int, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute positions [B, cap] of the ring slots after writing T new
    steps, -1 for never-written slots, and the advanced offset [B]."""
    idx = torch.arange(cap, device=offset.device)[None]
    last = (offset + T - 1)[:, None]
    delta = idx - last % cap
    pos = torch.where(delta <= 0, last + delta, last + delta - cap)
    offset_next = offset + T
    pos = torch.where(idx >= offset_next[:, None], -1, pos)
    return pos, offset_next


def layer_view(tree, layer: int):
    """The parameters of one layer: every leaf of a stacked tree indexed at
    `layer` (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, layer) for k, v in tree.items()}
    return tree[layer]


@dataclass(frozen=True)
class TransformerConfig:
    d_model: int
    num_heads: int
    num_layers: int
    dim_feedforward: int = 2048
    context: int | None = None
    positional_embedding: str = "rope"  # rope | rope_concat | none
    max_period: float = 10_000.0
    gating: str = "none"  # none (GELU MLP) | silu (gated)
    norm: str = "layer_norm"
    layer_scale: float | None = None
    kv_repeat: int = 1
    weights_per_step: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads // self.kv_repeat

    @property
    def num_weights(self) -> int:
        return self.weights_per_step or 1

    @property
    def kv_capacity(self) -> int:
        if self.context is not None:
            return self.context
        if self.weights_per_step:
            return self.weights_per_step
        raise ValueError("cannot size a streaming KV cache without a context")

    @property
    def hidden(self) -> int:
        return gating_hidden_dim(self.d_model, self.dim_feedforward)


class StreamingTransformer:
    """Functional transformer; params and state are explicit trees."""

    def __init__(self, config: TransformerConfig):
        c = config
        if c.positional_embedding not in ("rope", "rope_concat", "none"):
            raise NotImplementedError(
                f"positional embedding {c.positional_embedding!r} is not ported")
        if c.gating not in ("none", "silu"):
            raise NotImplementedError(f"gating {c.gating!r} is not ported")
        if c.d_model % c.num_heads or c.num_heads % c.kv_repeat:
            raise ValueError("heads must divide d_model and kv_repeat the heads")
        self.config = c
        self.rope = c.positional_embedding != "none"
        self.rope_interleave = c.positional_embedding != "rope_concat"
        self._norm1 = make_norm(c.norm, c.d_model)
        self._norm2 = make_norm(c.norm, c.d_model)
        self._ls = LayerScale(c.d_model, c.layer_scale) if c.layer_scale is not None else None

    # ------------------------------------------------------------------ params
    def init_params(self, generator: torch.Generator, dtype=torch.bfloat16,
                    device=None) -> dict:
        """{"layers": every layer's parameters stacked on a leading [L] axis}."""
        c = self.config
        L, W, d = c.num_layers, c.num_weights, c.d_model
        qkv_out = d + 2 * c.head_dim * c.num_kv_heads

        def trunc(shape, fan_in):
            return trunc_normal(generator, shape, fan_in, dtype, device)

        def stack_norm(norm):
            return {k: v.expand(L, *v.shape).clone()
                    for k, v in norm.init_params(dtype, device).items()}

        p = {
            "attn": {"in_proj": trunc((L, W, d, qkv_out), d),
                     "out_proj": trunc((L, W, d, d), d)},
            "norm1": stack_norm(self._norm1),
            "norm2": stack_norm(self._norm2),
        }
        if c.gating == "none":
            p["mlp"] = {"linear1": trunc((L, d, c.dim_feedforward), d),
                        "linear2": trunc((L, c.dim_feedforward, d), c.dim_feedforward)}
        else:
            h = c.hidden
            p["mlp"] = {"linear_in": trunc((L, W, d, 2 * h), d),
                        "linear_out": trunc((L, W, h, d), h)}
        if self._ls is not None:
            for name in ("layer_scale_1", "layer_scale_2"):
                p[name] = {"scale": torch.full((L, d), c.layer_scale, dtype=dtype,
                                               device=device)}
        return {"layers": p}

    # ------------------------------------------------------------------ state
    def init_state(self, batch_size: int, dtype=torch.bfloat16, device=None) -> dict:
        c = self.config
        shape = (c.num_layers, batch_size, c.kv_capacity, c.num_kv_heads, c.head_dim)
        return {"offset": torch.zeros(batch_size, dtype=torch.long, device=device),
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    # ------------------------------------------------------------- layer body
    def _attention(self, q, k, v, mask):
        """q [B, H, T, D]; k, v [B, S, Hkv, D]; mask [B, 1, T, S] bool.
        Scores and softmax in f32 as in the JAX package (its scores einsum
        asks for an f32 result); the products run in q's dtype."""
        c = self.config
        if c.kv_repeat > 1:
            k = k.repeat_interleave(c.kv_repeat, dim=2)
            v = v.repeat_interleave(c.kv_repeat, dim=2)
        compute = q.dtype
        scores = torch.einsum("bhtd,bshd->bhts", q, k.to(compute)).float()
        scores = scores * (1.0 / math.sqrt(c.head_dim))
        scores = scores.masked_fill(~mask, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", w.to(compute), v.to(compute))
        return out.reshape(*out.shape[:2], -1)  # [B, T, H*D]

    def _layer(self, pl, x, state, layer, write_idx, mask, offset, widx):
        c = self.config
        B, T, d = x.shape
        H, Hkv, Dh = c.num_heads, c.num_kv_heads, c.head_dim

        h = self._norm1.apply(pl["norm1"], x)
        qkv = _per_step_linear(pl["attn"]["in_proj"], h, widx)
        q = qkv[..., :d].reshape(B, T, H, Dh)
        kk = qkv[..., d:d + Hkv * Dh].reshape(B, T, Hkv, Dh)
        vv = qkv[..., d + Hkv * Dh:].reshape(B, T, Hkv, Dh)
        if self.rope:
            qh, kh = apply_rope(q.transpose(1, 2), kk.transpose(1, 2), offset,
                                max_period=c.max_period,
                                interleave=self.rope_interleave)
            q, kk = qh.transpose(1, 2), kh.transpose(1, 2)

        # ring write, in place
        b = torch.arange(B, device=x.device)[:, None]
        state["k"][layer, b, write_idx] = kk.to(state["k"].dtype)
        state["v"][layer, b, write_idx] = vv.to(state["v"].dtype)
        attn = self._attention(q.transpose(1, 2), state["k"][layer],
                               state["v"][layer], mask)
        attn = _per_step_linear(pl["attn"]["out_proj"], attn, widx)
        if "layer_scale_1" in pl:
            attn = pl["layer_scale_1"]["scale"].to(attn.dtype) * attn
        x = x + attn

        h = self._norm2.apply(pl["norm2"], x)
        if c.gating == "none":
            u = wdot(h, pl["mlp"]["linear1"])
            u = F.gelu(u)
            u = wdot(u, pl["mlp"]["linear2"])
        else:
            u = _per_step_linear(pl["mlp"]["linear_in"], h, widx)
            a, g = u.chunk(2, dim=-1)
            u = F.silu(a) * g
            u = _per_step_linear(pl["mlp"]["linear_out"], u, widx)
        if "layer_scale_2" in pl:
            u = pl["layer_scale_2"]["scale"].to(u.dtype) * u
        return x + u

    # ------------------------------------------------------------------- step
    def step(self, params: dict, state: dict, x: torch.Tensor, *,
             steps=None) -> tuple[torch.Tensor, dict]:
        """Streaming forward of T new steps x [B, T, d_model].  Updates
        `state` in place and returns (y, state).  steps: the absolute step
        index of each position, for per-step weights (default range(T))."""
        c = self.config
        B, T, _ = x.shape
        offset = state["offset"]
        cap = state["k"].shape[2]
        widx = None
        if c.num_weights > 1:
            widx = list(range(T) if steps is None else steps)

        ar = torch.arange(T, device=x.device)
        write_idx = (offset[:, None] + ar) % cap                     # [B, T]
        pos_k, offset_next = ring_positions(offset, T, cap)
        pos_q = offset[:, None] + ar[None]                           # [B, T]
        delta = pos_q[:, :, None] - pos_k[:, None, :]                # [B, T, cap]
        mask = (pos_k[:, None, :] >= 0) & (delta >= 0)
        if c.context is not None:
            mask &= delta < c.context
        mask = mask[:, None]

        for layer in range(c.num_layers):
            x = self._layer(layer_view(params["layers"], layer), x, state,
                            layer, write_idx, mask, offset, widx)
        offset.copy_(offset_next)
        return x, state

