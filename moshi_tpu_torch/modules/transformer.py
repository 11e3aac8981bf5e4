"""Streaming transformer with a ring KV cache (counterpart of
moshi_tpu/modules/transformer.py): the model-dtype KV path and the int8 and
int4 KV paths of batched serving.

- Layer parameters are stacked on a leading [L, ...] axis; per-step weights
  (the depformer) on a [W, ...] axis after it.  Layer l's weights are views
  `w[l]`, so a q4 or int8 member goes to its GEMV kernel without a copy.
- Streaming state is a dict of preallocated tensors, updated in place: the
  new K/V rows are written into the ring at `offset % cap` (moshi_tpu
  transformer.py:719-723) and `offset` advances after the step.  In place
  takes the role of the JAX package's donated buffers.
- `exec_mask` [B] bool freezes slots: a frozen slot's K/V row is still
  written (the writes are unconditional), but its offset does not advance,
  so the row is overwritten by its next executed step and never attended
  before that.
- `kv_cache_dtype="int4"`: the JAX package's nibble-packed cache in its
  layout (ops/int4_attention.py); a T = 1 step reads each layer with the
  `decode_attention_int4` kernel, whose launch also writes the layer's new
  column, and merges the current unquantized row with the flash rule
  (moshi_tpu transformer.py:749-921, which writes every layer's column
  after the layer scan).
- `kv_cache_dtype="int8"`: the ring layout of the model-dtype cache in int8,
  with a bf16 scale per (position, head) row.  A T = 1 step writes the
  current row quantized at `offset % cap` for every slot, then attends over
  the layer's whole ring with the `decode_attention_int8` kernel, so the
  current row is read back quantized (moshi_tpu transformer.py:670-746,
  where XLA's `_attention` puts the scales on scores and weights).
- A step of T > 1 positions (a prefill) over either quantized cache writes
  the T rows quantized at their ring positions (int4: one packed column a
  position, as the JAX package does), then attends over the layer's
  dequantized ring with the JAX package's formulation, the per-row scales
  on the scores and the softmax weights (moshi_tpu transformer.py:426-470,
  629-746).  That is plain torch: the JAX package computes it in XLA.

The FFN is a GELU MLP (`gating="none"`) or a GLU whose gate takes `silu`,
`gelu` (exact), `relu`, `tanh` or `sigmoid` (moshi_tpu
transformer.py:539-547, 966-977).

Cross-attention (the TTS and vision presets, moshi_tpu
transformer.py:375-423 and :525-535): `precompute_cross` projects a
conditioning source once into per-layer K/V [L, B, Ts, H, D] (or one
shared [B, Ts, H, D]); a step attends them after self-attention whenever
the state holds `k_cross`, with no mask, through norm_cross, q_proj,
out_proj, the gate (`_apply_xa_gate`, the six gatings of the reference
zoo) and layer_scale_cross.  It is plain torch in the JAX package's dtypes
(XLA there, no Pallas kernel); q_proj and out_proj go through `wdot`.

`apply` is the offline forward over a whole sequence (moshi_tpu
transformer.py:563-627): position embeddings from offset 0, the causal
mask with `context` as a sliding window (no mask at all with
`causal=False`; a streaming `step` keeps its ring mask either way, as the
JAX package's does), no cache, and `cross_src` projected by
`precompute_cross`.  With `remat` and autograd recording,
each layer runs under torch.utils.checkpoint (non-reentrant), which keeps
its input and recomputes the rest in the backward: the JAX package's
`jax.checkpoint` of the layer scan (transformer.py:622-625).  Per-step
weights over T > 1 positions
(the depformer's training pass) gather the T members, cast them to x's
dtype and contract them with one einsum, as the JAX package does (no
Pallas kernel there, plain torch here); a single position's member goes
through `wdot` and so to the GEMV kernels.

`ProjectedTransformer` wraps one with Mimi's input and output projections
(moshi_tpu transformer.py:980-1034).  Refused: `attention_int8_qk` (an
XLA-only option of the JAX package).
"""

import math
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .norm import LayerScale, make_norm
from .rope import apply_rope
from ..models.lora import LoRAWeight
from ..ops.decode_attention import decode_attention_int8
from ..ops.int4_attention import (_pack_nibble_cols, _quant_rows_int4,
                                  decode_attention_int4_write)
from ..utils.matmul import wdot
from ..utils.params import trunc_normal
from ..utils.quantize import (QTensor, QTensor4, dequantize, dequantize4, divide,
                              unpack_nibbles)

GATINGS = ("none", "silu", "gelu", "relu", "tanh", "sigmoid")


def gating_hidden_dim(dim: int, dim_feedforward: int) -> int:
    """Hidden width of the gated FFN."""
    if dim_feedforward == 4 * dim:
        return 21 * dim // 8
    return 2 * dim_feedforward // 3


def create_sin_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embedding [B, T, dim] in f32 of positions [B, T]."""
    half = dim // 2
    positions = positions.float()[..., None]
    adim = torch.arange(half, dtype=torch.float32, device=positions.device).view(1, 1, -1)
    phase = positions / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def _per_step_linear(w, x: torch.Tensor, idx) -> torch.Tensor:
    """Apply stacked per-step weights w [W, din, dout] to x [B, T, din];
    idx: the weight index of each of the T positions (unused when W == 1).
    One position: its member through wdot.  Several: the T members
    gathered and cast to x's dtype, then einsum("btd,tdo->bto")
    (moshi_tpu transformer.py:57-69)."""
    if w.shape[0] == 1:
        return wdot(x, w[0])
    if idx is None or len(idx) != x.shape[1]:
        raise ValueError(f"per-step weights need one index per position, got {idx}")
    if len(idx) == 1:
        return wdot(x, w[idx[0]])
    wt = dense(w[torch.tensor(idx, device=x.device)], x.dtype)
    return torch.einsum("btd,tdo->bto", x, wt)


def ring_positions(offset: torch.Tensor, T: int, cap: int,
                   exec_mask: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute positions [B, cap] of the ring slots after writing T new
    steps, -1 for never-written slots, and the advanced offset [B]; a slot
    whose exec_mask entry is False keeps its offset."""
    idx = torch.arange(cap, device=offset.device)[None]
    last = (offset + T - 1)[:, None]
    delta = idx - last % cap
    pos = torch.where(delta <= 0, last + delta, last + delta - cap)
    offset_next = offset + T
    if exec_mask is not None:
        offset_next = torch.where(exec_mask, offset_next, offset)
    pos = torch.where(idx >= offset_next[:, None], -1, pos)
    return pos, offset_next


def _quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization per (batch, time, head) row of [B, T, H,
    D]: values in [-127, 127] and the f32 scale [B, T, H, 1].  torch.round
    rounds half to even, as jnp.round does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = divide(amax.clamp(min=1e-6), 127.0)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _unpack_int4_channel_major(x: torch.Tensor, heads: int) -> torch.Tensor:
    """One layer's channel-pair packed cache [B, Hkv*D/2, cap] int8 ->
    the int4 values [B, cap, Hkv, D] (moshi_tpu transformer.py:954-960)."""
    low, high = unpack_nibbles(x)
    u = torch.stack([low, high], dim=-1).transpose(1, 2)       # [B, cap, hd/2, 2]
    B, cap, h2, _ = u.shape
    return u.reshape(B, cap, heads, 2 * h2 // heads)


def _activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """The GLU's gate (moshi_tpu transformer.py:966-977); gelu is exact."""
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x)
    if name == "relu":
        return F.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown activation {name}")


def dense(w, dtype) -> torch.Tensor:
    """A weight as a dense tensor in `dtype`: a QTensor or QTensor4
    dequantized (the JAX package's `w.astype(dtype)`), a LoRAWeight fused
    (its `dense`), a tensor cast."""
    if isinstance(w, LoRAWeight):
        return w.dense(dtype)
    if isinstance(w, QTensor):
        return dequantize(w.q, w.scale, dtype)
    if isinstance(w, QTensor4):
        return dequantize4(w.q, w.scale, dtype)
    return w.to(dtype)


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
    causal: bool = True   # False: apply attends every position (step keeps its ring mask)
    context: int | None = None
    positional_embedding: str = "rope"  # rope | rope_concat | sin | sin_rope | none
    max_period: float = 10_000.0
    gating: str = "none"  # none (GELU MLP) | silu | gelu | relu | tanh | sigmoid (GLU)
    norm: str = "layer_norm"
    layer_scale: float | None = None
    kv_repeat: int = 1
    weights_per_step: int = 0
    # step k uses weight set schedule[k] (None: set k)
    weights_per_step_schedule: tuple[int, ...] | None = None
    kv_cache_dtype: str = "model"  # model | int8 | int4
    attention_int8_qk: bool = False  # int8 x int8 scores on XLA; not ported
    cross_attention: bool = False
    # normal | constant_gated_{tanh,sigmoid} |
    # conditional_gated_{tanh,sigmoid}[_learnable_bias]
    cross_attention_gating: str = "normal"
    cross_attention_norm: str = "layer_norm"
    cross_attention_kv_dim: int | None = None  # the source's width (None: d_model)
    shared_cross_attn: bool = False  # one projection set for every layer
    remat: bool = False  # apply under grad recomputes each layer in the backward

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads // self.kv_repeat

    @property
    def num_weights(self) -> int:
        if not self.weights_per_step:
            return 1
        if self.weights_per_step_schedule is not None:
            return max(self.weights_per_step_schedule) + 1
        return self.weights_per_step

    def steps_to_weight_indices(self, steps) -> list[int] | None:
        """The weight set of each absolute step index, through the
        schedule; None without per-step weights."""
        if self.num_weights == 1:
            return None
        if self.weights_per_step_schedule is not None:
            return [self.weights_per_step_schedule[k] for k in steps]
        return list(steps)

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

    @property
    def xa_kv_dim(self) -> int:
        return self.cross_attention_kv_dim or self.d_model

    @property
    def xa_gate_hidden(self) -> int:
        """Hidden width of the conditional gate's MLP."""
        return int(0.125 * self.d_model)


XA_GATINGS = ("normal", "constant_gated_tanh", "constant_gated_sigmoid",
              "conditional_gated_tanh", "conditional_gated_sigmoid",
              "conditional_gated_tanh_learnable_bias",
              "conditional_gated_sigmoid_learnable_bias")


class StreamingTransformer:
    """Functional transformer; params and state are explicit trees."""

    def __init__(self, config: TransformerConfig):
        c = config
        if c.positional_embedding not in ("rope", "rope_concat", "sin", "sin_rope", "none"):
            raise NotImplementedError(
                f"positional embedding {c.positional_embedding!r} is not ported")
        if c.gating not in GATINGS:
            raise ValueError(f"gating {c.gating!r} not in {GATINGS}")
        if c.d_model % c.num_heads or c.num_heads % c.kv_repeat:
            raise ValueError("heads must divide d_model and kv_repeat the heads")
        if c.attention_int8_qk:
            raise NotImplementedError("attention_int8_qk (int8 x int8 scores, an "
                                      "XLA-only option of the JAX package) is not ported")
        if c.kv_cache_dtype not in ("model", "int8", "int4"):
            raise ValueError(f"kv_cache_dtype {c.kv_cache_dtype!r}")
        if c.cross_attention_gating not in XA_GATINGS:
            raise ValueError(f"cross_attention_gating {c.cross_attention_gating!r}")
        sched = c.weights_per_step_schedule
        if sched is not None and len(sched) != c.weights_per_step:
            raise ValueError(f"a schedule of {len(sched)} steps for weights_per_step "
                             f"{c.weights_per_step}")
        self.config = c
        self.rope = c.positional_embedding in ("rope", "rope_concat", "sin_rope")
        self.rope_interleave = c.positional_embedding != "rope_concat"
        self._norm1 = make_norm(c.norm, c.d_model)
        self._norm2 = make_norm(c.norm, c.d_model)
        self._norm_cross = make_norm(c.cross_attention_norm, c.d_model)
        self._ls = LayerScale(c.d_model, c.layer_scale) if c.layer_scale is not None else None

    # ------------------------------------------------------------------ params
    def init_params(self, generator: torch.Generator, dtype=torch.bfloat16,
                    device=None) -> dict:
        """{"layers": every layer's parameters stacked on a leading [L] axis},
        and with shared_cross_attn a "cross_attn_shared" projection set
        beside them."""
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
        out = {"layers": p}
        if c.cross_attention:
            if c.shared_cross_attn:
                out["cross_attn_shared"] = self._init_xa_proj(trunc, ())
            else:
                p["cross_attn"] = self._init_xa_proj(trunc, (L,))
            gate = self._init_xa_gate(trunc, (L,), dtype, device)
            if gate is not None:
                p["cross_attn_gate"] = gate
            p["norm_cross"] = stack_norm(self._norm_cross)
            if self._ls is not None:
                p["layer_scale_cross"] = {"scale": torch.full((L, d), c.layer_scale,
                                                              dtype=dtype, device=device)}
        return out

    def _init_xa_proj(self, trunc, lead: tuple) -> dict:
        d, kv = self.config.d_model, self.config.xa_kv_dim
        return {"q_proj": trunc(lead + (d, d), d), "kv_proj": trunc(lead + (kv, 2 * d), kv),
                "out_proj": trunc(lead + (d, d), d)}

    def _init_xa_gate(self, trunc, lead: tuple, dtype, device) -> dict | None:
        c = self.config
        g = c.cross_attention_gating
        if g == "normal":
            return None
        if g.startswith("constant_gated"):
            return {"alpha": torch.zeros(lead + (1, 1, 1), dtype=dtype, device=device)}
        h = c.xa_gate_hidden
        p = {"in_proj": trunc(lead + (c.d_model, h), c.d_model),
             "out_proj": trunc(lead + (h, c.d_model), h)}
        if g.endswith("learnable_bias"):
            p["bias"] = torch.zeros(lead + (c.d_model,), dtype=dtype, device=device)
        return p

    # ------------------------------------------------------------------ state
    def init_state(self, batch_size: int, dtype=torch.bfloat16, device=None) -> dict:
        """Model-dtype KV: k, v [L, B, cap, Hkv, D] in `dtype`.  int8 KV
        (`dtype` unused): k, v [L, B, cap, Hkv, D] int8 and k_scale,
        v_scale [L, B, cap, Hkv, 1] bf16.  int4 KV (`dtype` unused): k, v
        [L, B, Hkv*D/2, cap_pad] int8 channel-pair packed and k_scale,
        v_scale [L, B, Hkv, cap_pad] bf16, with cap_pad the capacity rounded
        up to a multiple of 128 (moshi_tpu transformer.py:336-370)."""
        c = self.config
        L, Hkv, D = c.num_layers, c.num_kv_heads, c.head_dim
        state = {"offset": torch.zeros(batch_size, dtype=torch.long, device=device)}
        if c.kv_cache_dtype == "int4":
            if D % 2:
                raise ValueError(f"int4 KV needs an even head dim, not {D}")
            cap_pad = -(-c.kv_capacity // 128) * 128
            for name in ("k", "v"):
                state[name] = torch.zeros((L, batch_size, Hkv * D // 2, cap_pad),
                                          dtype=torch.int8, device=device)
            for name in ("k_scale", "v_scale"):
                state[name] = torch.zeros((L, batch_size, Hkv, cap_pad),
                                          dtype=torch.bfloat16, device=device)
            return state
        shape = (L, batch_size, c.kv_capacity, Hkv, D)
        if c.kv_cache_dtype == "int8":
            dtype = torch.int8
            for name in ("k_scale", "v_scale"):
                state[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16,
                                          device=device)
        state["k"] = torch.zeros(shape, dtype=dtype, device=device)
        state["v"] = torch.zeros(shape, dtype=dtype, device=device)
        return state

    def precompute_cross(self, params: dict, src: torch.Tensor, dtype=None,
                         out: dict | None = None) -> dict:
        """Cross-attention K/V of a conditioning source src [B, Ts, kv_dim]:
        {"k_cross", "v_cross"} of [L, B, Ts, H, D], or [B, Ts, H, D] with
        shared_cross_attn.  The product runs in src's dtype on the
        dequantized kv_proj (moshi_tpu transformer.py:375-397), one layer at
        a time; the result is stored in `dtype` (default src's), or written
        in place into the tensors of `out`.  A step casts K/V to its own
        dtype before attending, so storing them in the model's dtype gives
        the JAX package's values."""
        c = self.config
        B, Ts, _ = src.shape
        shared = c.shared_cross_attn
        lead = () if shared else (c.num_layers,)
        if out is None:
            shape = lead + (B, Ts, c.num_heads, c.head_dim)
            dt = src.dtype if dtype is None else dtype
            out = {name: torch.empty(shape, dtype=dt, device=src.device)
                   for name in ("k_cross", "v_cross")}
        if shared:
            kv_ws = [(params["cross_attn_shared"]["kv_proj"], out["k_cross"], out["v_cross"])]
        else:
            w = params["layers"]["cross_attn"]["kv_proj"]
            kv_ws = [(w[li], out["k_cross"][li], out["v_cross"][li])
                     for li in range(c.num_layers)]
        for w, k_out, v_out in kv_ws:
            kv = torch.matmul(src, dense(w, src.dtype))
            k, v = kv.chunk(2, dim=-1)
            k_out.copy_(k.reshape(B, Ts, c.num_heads, c.head_dim))
            v_out.copy_(v.reshape(B, Ts, c.num_heads, c.head_dim))
        return out

    def _apply_xa_gate(self, gate: dict | None, x: torch.Tensor) -> torch.Tensor:
        """The cross-attention block's output gate, after out_proj and before
        the residual add (moshi_tpu transformer.py:399-423)."""
        g = self.config.cross_attention_gating
        if g == "normal" or gate is None:
            return x
        if g == "constant_gated_tanh":
            return x * torch.tanh(gate["alpha"].float()).to(x.dtype)
        if g == "constant_gated_sigmoid":
            return x * torch.sigmoid(gate["alpha"].float() - 4.0).to(x.dtype)
        a = torch.relu(torch.matmul(x, dense(gate["in_proj"], x.dtype)))
        a = torch.matmul(a, dense(gate["out_proj"], a.dtype))
        if "bias" in gate:
            a = a + gate["bias"].to(a.dtype)
        if "tanh" in g:
            a = torch.tanh(a)
        elif g.endswith("learnable_bias"):
            a = torch.sigmoid(a)
        else:
            a = torch.sigmoid(a - 4.0)
        return x * a

    def _cross(self, params: dict, state: dict):
        """The step's cross-attention operands: per layer l, (k, v, the
        projection set) or None when the state holds no K/V."""
        if "k_cross" not in state:
            return lambda layer: None
        shared = params.get("cross_attn_shared")
        k, v = state["k_cross"], state["v_cross"]
        if self.config.shared_cross_attn:
            return lambda layer: (k, v, shared)
        return lambda layer: (k[layer], v[layer], None)

    # ------------------------------------------------------------- layer body
    def _attention(self, q, k, v, mask, k_scale=None, v_scale=None):
        """q [B, H, T, D]; k, v [B, S, Hkv, D]; mask [B, 1, T, S] bool or
        None (attend every position).  Scores and softmax in f32 as in the
        JAX package (its scores einsum asks for an f32 result); the
        products run in q's dtype.  k_scale, v_scale [B, S, Hkv, 1]: the
        quantized cache's per-row scales, put on the scores and on the
        softmax weights (moshi_tpu transformer.py:426-470)."""
        c = self.config
        if c.kv_repeat > 1:
            k = k.repeat_interleave(c.kv_repeat, dim=2)
            v = v.repeat_interleave(c.kv_repeat, dim=2)
            if k_scale is not None:
                k_scale = k_scale.repeat_interleave(c.kv_repeat, dim=2)
                v_scale = v_scale.repeat_interleave(c.kv_repeat, dim=2)
        compute = q.dtype
        scores = torch.einsum("bhtd,bshd->bhts", q, k.to(compute)).float()
        if k_scale is not None:
            scores = scores * k_scale.float().permute(0, 2, 3, 1)
        scores = scores * (1.0 / math.sqrt(c.head_dim))
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        if v_scale is not None:
            w = w * v_scale.float().permute(0, 2, 3, 1)
        out = torch.einsum("bhts,bshd->bthd", w.to(compute), v.to(compute))
        return out.reshape(*out.shape[:2], -1)  # [B, T, H*D]

    def _ring_attention(self, q, kk, vv, *, state, layer, write_idx, mask):
        """Model-dtype KV: write the new rows into the ring in place, then
        attend over the layer's whole ring."""
        B = q.shape[0]
        b = torch.arange(B, device=q.device)[:, None]
        state["k"][layer, b, write_idx] = kk.to(state["k"].dtype)
        state["v"][layer, b, write_idx] = vv.to(state["v"].dtype)
        return self._attention(q.transpose(1, 2), state["k"][layer], state["v"][layer], mask)

    def _int8_attention(self, q, kk, vv, *, state, layer, write_pos, mask):
        """int8 KV: quantize the current rows kk, vv [B, 1, Hkv, D] and
        write them at write_pos [B] of every slot (a plain index write, an
        XLA scatter in the JAX package), then attend over the layer's whole
        ring, the current row included (the kernel on the card, its plain
        version on the CPU).  q [B, 1, H, D]; returns [B, 1, H*D]."""
        B, _, H, D = q.shape
        b = torch.arange(B, device=q.device)
        for name, rows in (("k", kk), ("v", vv)):
            vals, scale = _quant_rows(rows)
            state[name][layer, b, write_pos] = vals[:, 0]
            state[name + "_scale"][layer, b, write_pos] = scale[:, 0].to(torch.bfloat16)
        out = decode_attention_int8(q[:, 0].contiguous(), layer, state["k"], state["v"],
                                    state["k_scale"], state["v_scale"], mask)
        return out.reshape(B, 1, H * D).to(q.dtype)

    def _quant_ring_attention(self, q, kk, vv, *, state, layer, write_idx, mask):
        """T > 1 rows over a quantized cache: quantize kk, vv [B, T, Hkv,
        D] and write them at write_idx [B, T] of every slot (int4: one
        packed column a position, in order), then attend over the layer's
        whole ring, scales on the scores and weights (moshi_tpu
        transformer.py:629-746).  q [B, T, H, D]; returns [B, T, H*D]."""
        c = self.config
        B, T = kk.shape[:2]
        b = torch.arange(B, device=q.device)
        if c.kv_cache_dtype == "int8":
            for name, rows in (("k", kk), ("v", vv)):
                vals, scale = _quant_rows(rows)
                state[name][layer, b[:, None], write_idx] = vals
                state[name + "_scale"][layer, b[:, None], write_idx] = scale.to(torch.bfloat16)
            return self._attention(q.transpose(1, 2), state["k"][layer], state["v"][layer],
                                   mask, state["k_scale"][layer], state["v_scale"][layer])
        cap = mask.shape[-1]  # the logical capacity; the lanes are padded past it
        for name, rows in (("k", kk), ("v", vv)):
            vals, scale = _quant_rows_int4(rows)
            vals = vals.reshape(B, T, -1)
            for t in range(T):
                pos = write_idx[:, t]
                state[name][layer, b, :, pos] = _pack_nibble_cols(vals[:, t])
                state[name + "_scale"][layer, b, :, pos] = scale[:, t, :, 0].to(torch.bfloat16)
        Hkv = c.num_kv_heads
        k, v = (_unpack_int4_channel_major(state[n][layer], Hkv)[:, :cap] for n in ("k", "v"))
        ks, vs = (state[n][layer].transpose(1, 2)[:, :cap, :, None]
                  for n in ("k_scale", "v_scale"))
        return self._attention(q.transpose(1, 2), k, v, mask, ks, vs)

    def _int4_attention(self, q, kk, vv, *, state, layer, ctx):
        """Decode attention over the packed int4 cache plus the current row.
        q [B, 1, H, D] and kk, vv [B, 1, Hkv, D], rope'd.  One op runs the
        cache pass with lane ctx["wp"] masked and writes the current rows,
        quantized, at that lane of this layer (the kernel on the card, its
        plain version on the CPU); then the current unquantized row is
        flash-merged, its score counting only for executing slots
        (moshi_tpu transformer.py:857-921).  Returns [B, 1, H*D]."""
        c = self.config
        B, _, H, D = q.shape
        k_cur, v_cur = kk[:, 0], vv[:, 0]                      # [B, Hkv, D]
        qh = q.transpose(1, 2).contiguous()                    # [B, H, 1, D]
        acc, m, lse = decode_attention_int4_write(qh, k_cur, v_cur, ctx["wp"], layer,
                                                  state["k"], state["v"], state["k_scale"],
                                                  state["v_scale"], ctx["mask"])
        if c.kv_repeat > 1:
            k_cur = k_cur.repeat_interleave(c.kv_repeat, dim=1)
            v_cur = v_cur.repeat_interleave(c.kv_repeat, dim=1)
        s_cur = (qh[:, :, 0].float() * k_cur.float()).sum(-1, keepdim=True) / math.sqrt(D)
        s_cur = torch.where(ctx["cur_valid"][:, None, None], s_cur, -1e30)
        m2 = torch.maximum(m, s_cur)
        a1, a2 = torch.exp(m - m2), torch.exp(s_cur - m2)
        out = (acc * a1 + a2 * v_cur.float()) / (lse * a1 + a2 + 1e-30)
        return out.reshape(B, 1, H * D).to(q.dtype)

    def _layer(self, pl, x, attend, offset, widx, cross=None):
        """One layer; attend(q [B, T, H, D], k, v [B, T, Hkv, D]) -> [B, T,
        H*D] does the KV cache's part; cross: (k_cross, v_cross [B, Ts, H,
        D], the shared projection set or None) adds the cross-attention
        block."""
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

        attn = attend(q, kk, vv)
        attn = _per_step_linear(pl["attn"]["out_proj"], attn, widx)
        if "layer_scale_1" in pl:
            attn = pl["layer_scale_1"]["scale"].to(attn.dtype) * attn
        x = x + attn

        if cross is not None:
            k_cross, v_cross, shared = cross
            proj = shared if shared is not None else pl["cross_attn"]
            h = self._norm_cross.apply(pl["norm_cross"], x)
            qx = wdot(h, proj["q_proj"]).reshape(B, T, H, Dh).transpose(1, 2)
            ca = self._attention(qx, k_cross.to(x.dtype), v_cross.to(x.dtype), None)
            ca = self._apply_xa_gate(pl.get("cross_attn_gate"), wdot(ca, proj["out_proj"]))
            if "layer_scale_cross" in pl:
                ca = pl["layer_scale_cross"]["scale"].to(ca.dtype) * ca
            x = x + ca

        h = self._norm2.apply(pl["norm2"], x)
        if c.gating == "none":
            u = wdot(h, pl["mlp"]["linear1"])
            u = F.gelu(u)
            u = wdot(u, pl["mlp"]["linear2"])
        else:
            u = _per_step_linear(pl["mlp"]["linear_in"], h, widx)
            a, g = u.chunk(2, dim=-1)
            u = _activation(c.gating, a) * g
            u = _per_step_linear(pl["mlp"]["linear_out"], u, widx)
        if "layer_scale_2" in pl:
            u = pl["layer_scale_2"]["scale"].to(u.dtype) * u
        return x + u

    # ------------------------------------------------------------------ modes
    def _pos_embed(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        """x plus the sinusoidal embedding of positions offset + t, for the
        sin embeddings; x itself otherwise."""
        c = self.config
        if c.positional_embedding not in ("sin", "sin_rope"):
            return x
        positions = offset[:, None] + torch.arange(x.shape[1], device=x.device)[None]
        return x + create_sin_embedding(positions, x.shape[-1], c.max_period).to(x.dtype)

    def apply(self, params: dict, x: torch.Tensor, *, steps=None,
              cross_src: torch.Tensor | None = None) -> torch.Tensor:
        """Offline forward of a whole sequence x [B, T, d_model] -> [B, T,
        d_model], with no cache: positions from 0, the causal mask with
        `context` as a sliding window (no mask when not `causal`).  steps:
        the absolute step index of each position, for per-step weights
        (default range(T)); cross_src [B, Ts, kv_dim]: the cross-attention
        source, projected once."""
        c = self.config
        B, T, _ = x.shape
        offset = torch.zeros(B, dtype=torch.long, device=x.device)
        x = self._pos_embed(x, offset)
        widx = c.steps_to_weight_indices(range(T) if steps is None else steps)
        mask = None
        if c.causal:
            t = torch.arange(T, device=x.device)
            delta = t[:, None] - t[None, :]
            mask = delta >= 0
            if c.context is not None:
                mask &= delta < c.context
            mask = mask[None, None]

        def attend(q, kk, vv):
            return self._attention(q.transpose(1, 2), kk, vv, mask)

        cross = (self._cross(params, self.precompute_cross(params, cross_src))
                 if cross_src is not None else self._cross(params, {}))
        remat = c.remat and torch.is_grad_enabled()
        for layer in range(c.num_layers):
            args = (layer_view(params["layers"], layer), x, attend, offset, widx, cross(layer))
            x = (checkpoint(self._layer, *args, use_reentrant=False) if remat
                 else self._layer(*args))
        return x

    # ------------------------------------------------------------------- step
    def step(self, params: dict, state: dict, x: torch.Tensor, *,
             exec_mask: torch.Tensor | None = None, steps=None
             ) -> tuple[torch.Tensor, dict]:
        """Streaming forward of T new steps x [B, T, d_model].  Updates
        `state` in place and returns (y, state).  exec_mask [B] bool: the
        slots whose offset advances (all by default).  steps: the absolute
        step index of each position, for per-step weights (default
        range(T))."""
        c = self.config
        B, T, _ = x.shape
        widx = c.steps_to_weight_indices(range(T) if steps is None else steps)
        if c.kv_cache_dtype == "int4" and T == 1:
            return self._step_int4_decode(params, state, x, exec_mask, widx)
        offset = state["offset"]
        # the int4 cache's lane axis is padded past the capacity
        cap = c.kv_capacity if c.kv_cache_dtype == "int4" else state["k"].shape[2]
        x = self._pos_embed(x, offset)

        ar = torch.arange(T, device=x.device)
        write_idx = (offset[:, None] + ar) % cap                     # [B, T]
        pos_k, offset_next = ring_positions(offset, T, cap, exec_mask)
        pos_q = offset[:, None] + ar[None]                           # [B, T]
        delta = pos_q[:, :, None] - pos_k[:, None, :]                # [B, T, cap]
        mask = (pos_k[:, None, :] >= 0) & (delta >= 0)
        if c.context is not None:
            mask &= delta < c.context
        mask = mask[:, None]

        cross = self._cross(params, state)
        for layer in range(c.num_layers):
            # int8 KV (moshi_tpu transformer.py:670-746 at T = 1): the same
            # ring mask, the current row written quantized before attending
            if c.kv_cache_dtype == "int8" and T == 1:
                attend = partial(self._int8_attention, state=state, layer=layer,
                                 write_pos=write_idx[:, 0], mask=mask[:, 0, 0])
            elif c.kv_cache_dtype != "model":
                attend = partial(self._quant_ring_attention, state=state, layer=layer,
                                 write_idx=write_idx, mask=mask)
            else:
                attend = partial(self._ring_attention, state=state, layer=layer,
                                 write_idx=write_idx, mask=mask)
            x = self._layer(layer_view(params["layers"], layer), x, attend, offset, widx,
                            cross(layer))
        offset.copy_(offset_next)
        return x, state

    def _step_int4_decode(self, params, state, x, exec_mask, widx):
        """One T = 1 step over the int4 cache (moshi_tpu
        transformer.py:749-855).  The lane at the write position `offset %
        cap` holds a stale row and is masked out of the cache pass; the
        current row is merged in unquantized.  Each layer's new column is
        written at that lane, for every slot, by the layer's own attention
        op after its pass.  The JAX package writes every layer's column
        after the layer scan instead; the caches end equal, because layer
        l's cache is read only by layer l's pass in a step and that pass
        does not attend the lane."""
        c = self.config
        B = x.shape[0]
        offset = state["offset"]
        x = self._pos_embed(x, offset)
        cap = c.kv_capacity  # the cache's lane axis is padded past it
        wp = offset % cap
        pos_k, offset_next = ring_positions(offset, 1, cap, exec_mask)
        delta = offset[:, None] - pos_k                              # [B, cap]
        mask = (pos_k >= 0) & (delta >= 0)
        if c.context is not None:
            mask &= delta < c.context
        mask &= torch.arange(cap, device=x.device)[None] != wp[:, None]
        ctx = {"mask": mask, "wp": wp,
               "cur_valid": (torch.ones(B, dtype=torch.bool, device=x.device)
                             if exec_mask is None else exec_mask)}
        cross = self._cross(params, state)
        for layer in range(c.num_layers):
            attend = partial(self._int4_attention, state=state, layer=layer, ctx=ctx)
            x = self._layer(layer_view(params["layers"], layer), x, attend, offset, widx,
                            cross(layer))
        offset.copy_(offset_next)
        return x, state



class ProjectedTransformer:
    """A StreamingTransformer between an input projection and one output
    projection per output width (moshi_tpu transformer.py:980-1034): the
    params hold `input_proj` where the input width differs from d_model
    and `output_projs`, one entry per output, empty (the identity) where
    the width is d_model.  Layout [B, T, C]; the projections are plain
    products in x's dtype, as the JAX package's `dot`."""

    def __init__(self, config: TransformerConfig, input_dimension: int,
                 output_dimensions: tuple[int, ...]):
        self.transformer = StreamingTransformer(config)
        self.config = config
        self.input_dimension = input_dimension
        self.output_dimensions = tuple(output_dimensions)

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        d = self.config.d_model
        p = self.transformer.init_params(generator, dtype, device)
        if self.input_dimension != d:
            p["input_proj"] = {"weight": trunc_normal(generator, (self.input_dimension, d),
                                                      self.input_dimension, dtype, device)}
        p["output_projs"] = [{} if od == d else
                             {"weight": trunc_normal(generator, (d, od), d, dtype, device)}
                             for od in self.output_dimensions]
        return p

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        return self.transformer.init_state(batch_size, dtype, device)

    @staticmethod
    def _project_in(params: dict, x: torch.Tensor) -> torch.Tensor:
        if "input_proj" in params:
            x = torch.matmul(x, params["input_proj"]["weight"].to(x.dtype))
        return x

    @staticmethod
    def _project_out(params: dict, z: torch.Tensor) -> list[torch.Tensor]:
        return [torch.matmul(z, op["weight"].to(z.dtype)) if "weight" in op else z
                for op in params["output_projs"]]

    def apply(self, params: dict, x: torch.Tensor) -> list[torch.Tensor]:
        z = self.transformer.apply(params, self._project_in(params, x))
        return self._project_out(params, z)

    def step(self, params: dict, state: dict, x: torch.Tensor,
             exec_mask: torch.Tensor | None = None) -> tuple[list[torch.Tensor], dict]:
        z, state = self.transformer.step(params, state, self._project_in(params, x),
                                         exec_mask=exec_mask)
        return self._project_out(params, z), state
