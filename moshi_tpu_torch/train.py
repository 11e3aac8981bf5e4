"""Training for the LM (teacher-forced multi-stream cross entropy) and the
Mimi codec (reconstruction plus RVQ EMA) (counterpart of
moshi_tpu/train.py).

The LM half differentiates `LMModel.forward` with autograd: the q4 and int8
linears run their kernels forward and `ops/q4matmul.FrozenLinear`'s
torch.matmul backward, LoRA adapters (models/lora.py) train over a frozen
base, and `remat` recomputes each temporal layer in the backward.  The
codec half composes the offline Mimi modules with
`quantization/train.rvq_train_forward` under an L1 plus multi-scale STFT
loss, in f32.

The optimizer is the JAX package's optax chain, written out with optax
0.2.6's semantics on lists of leaves: `clip_by_global_norm` (t / norm *
max_norm once the norm reaches max_norm), `adamw` (bias-corrected moments,
weight decay on every trained leaf, the learning rate of the schedule at
the update's count, so a warmup's first update is 0), `MultiSteps` (the
running mean of `accum_steps` micro-gradients, the inner state advancing
only when it applies) and the constant, cosine and linear schedules.
`lora_optimizer` and `masked` train the leaves of one label and leave the
others as they are (optax.multi_transform with set_to_zero).  Optimizer
state is a tree of named tensors, so a checkpoint carries its own
structure.

`main()` is the CLI: `python -m moshi_tpu_torch.train --config c.json
[--steps N] [--out-dir D] [--resume F] [--device cpu] [--deterministic]`,
both targets, with gradient accumulation, schedules, clipping and resume
on one device, bitwise on the CPU and, with `--deterministic`, on the card
(without it cuDNN's convolutions and index_add's atomics may reorder sums).
A `lora_only` config whose params hold no LoRAWeight is refused: the JAX
package's CLI trains nothing there, silently (ROADMAP C.10).

The JAX package's `mesh: {dp: N}` and `{dp: N, fsdp: true}` run over
torch.distributed, one process per rank (`torchrun --nproc_per_node N -m
moshi_tpu_torch.train --config c.json`, or run_training inside an
initialized process group), and compute what one device computes on the
global batch, as JAX's GSPMD mesh does (`DataParallel`): every rank draws
the global batch and takes its rows, the LM's cross entropy divides by the
global count of valid positions, each micro-step's gradients are summed over
the ranks, Mimi's RVQ statistics are taken over the global batch.  Under
fsdp the params and the optimizer state rest as this rank's shards
(parallel/mesh.fsdp_param_spec), each step gathers the whole params, and
the gradients are reduce-scattered onto the shards, where the optimizer
acts; clipping takes the global norm.  Rank 0 alone logs and saves, a
checkpoint gathered whole, so it resumes at any dp.
"""

import json
import math
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .models import native_ckpt
from .models.lm import LMModel, LmConfig, cross_entropy
from .models.lora import LoRAWeight, has_lora, lora_labels
from .parallel import collectives
from .utils.quantize import QTensor, QTensor4


# ------------------------------------------------------------- param trees
def tree_leaves(tree, path=()):
    """(path, tensor) of every tensor leaf: dicts in sorted key order (a
    loaded tree's dicts are in the file's order), lists in index order, a
    LoRAWeight's base, a and b, a quantized leaf's q and scale.  Optimizer
    state lists follow this order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    elif isinstance(tree, LoRAWeight):
        yield from tree_leaves(tree.base, path + ("base",))
        yield path + ("a",), tree.a
        yield path + ("b",), tree.b
    elif isinstance(tree, (QTensor, QTensor4)):
        yield path + ("q",), tree.q
        yield path + ("scale",), tree.scale
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def tree_replace(tree, new: dict, path=()):
    """A new tree with the leaves at the paths of `new` replaced (the other
    leaves are the same tensors)."""
    if path in new:
        return new[path]
    if isinstance(tree, dict):
        return {k: tree_replace(v, new, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_replace(v, new, path + (i,)) for i, v in enumerate(tree))
    if isinstance(tree, LoRAWeight):
        return LoRAWeight(tree_replace(tree.base, new, path + ("base",)),
                          tree_replace(tree.a, new, path + ("a",)),
                          tree_replace(tree.b, new, path + ("b",)), tree.scaling)
    if isinstance(tree, (QTensor, QTensor4)):
        q, scale = (tree_replace(tree.q, new, path + ("q",)),
                    tree_replace(tree.scale, new, path + ("scale",)))
        return tree if q is tree.q and scale is tree.scale else type(tree)(q, scale)
    return tree


def labelled_paths(params, labels, label: str) -> list:
    """Paths of the floating tensor leaves of `params` whose label (a string
    at that node of `labels` or above it) is `label`."""
    out = []

    def walk(tree, lab, path):
        if isinstance(lab, str):
            if lab == label:
                out.extend(p for p, t in tree_leaves(tree, path) if t.is_floating_point())
        elif isinstance(lab, dict):
            for k in sorted(lab):
                walk(tree[k], lab[k], path + (k,))
        elif isinstance(lab, (list, tuple)):
            for i, (t, l) in enumerate(zip(tree, lab)):
                walk(t, l, path + (i,))
        elif isinstance(lab, LoRAWeight):
            walk(tree.base, lab.base, path + ("base",))
            walk(tree.a, lab.a, path + ("a",))
            walk(tree.b, lab.b, path + ("b",))
        else:
            raise TypeError(f"label {lab!r} at {path}")
    walk(params, labels, ())
    return out


def _get(tree, path):
    for k in path:
        tree = getattr(tree, k) if isinstance(tree, (LoRAWeight, QTensor, QTensor4)) \
            else tree[k]
    return tree


# --------------------------------------------------------------- optimizer
@dataclass
class GradientTransformation:
    """An optax-like transformation over a list of leaves: init(leaves) ->
    state; update(grads, state, leaves) -> (updates, state)."""
    init: Callable
    update: Callable


@dataclass
class Optimizer:
    """A transformation and the leaves it trains: `labels` (a label tree of
    the params) and `label` select them; no labels: every floating leaf."""
    transform: GradientTransformation
    labels: object = None
    label: str = "train"

    def select(self, params) -> list:
        if self.labels is None:
            return [p for p, t in tree_leaves(params) if t.is_floating_point()]
        return labelled_paths(params, self.labels, self.label)

    def init(self, params) -> dict:
        return self.transform.init([_get(params, p) for p in self.select(params)])

    def update(self, grads, state, leaves):
        return self.transform.update(grads, state, leaves)


def _f32(v) -> np.float32:
    return np.float32(v)


def linear_schedule(init: float, end: float, steps: int, begin: int = 0):
    """optax.linear_schedule in f32: init -> end over `steps` counts."""
    if steps <= 0:
        return lambda count: _f32(init)

    def schedule(count):
        c = _f32(min(max(count - begin, 0), steps))
        frac = _f32(1) - c / _f32(steps)
        return _f32(init - end) * frac + _f32(end)
    return schedule


def cosine_decay_schedule(init: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1) in f32."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = min(_f32(count), _f32(decay_steps))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(decay_steps)))
        return _f32(init) * (_f32(1 - alpha) * cos + _f32(alpha))
    return schedule


def join_schedules(schedules, boundaries):
    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = out if count < boundary else s(count - boundary)
        return out
    return schedule


def _leafwise(fn, *lists):
    return [fn(*xs) for xs in zip(*lists)]


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4) -> GradientTransformation:
    """optax.adamw: scale_by_adam, add_decayed_weights, then times -lr(count)
    (lr a float or a schedule of the update count)."""
    def init(leaves):
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": [torch.zeros_like(t) for t in leaves],
                "nu": [torch.zeros_like(t) for t in leaves]}

    def update(grads, state, leaves):
        count = int(state["count"])
        mu = _leafwise(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = _leafwise(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        bc1 = float(_f32(1) - _f32(b1) ** _f32(count + 1))
        bc2 = float(_f32(1) - _f32(b2) ** _f32(count + 1))
        step = -float(lr(count) if callable(lr) else _f32(lr))
        updates = _leafwise(
            lambda m, v, p: step * (m / bc1 / (torch.sqrt(v / bc2) + eps) + weight_decay * p),
            mu, nu, leaves)
        return updates, {"count": torch.tensor(count + 1, dtype=torch.int32), "mu": mu,
                         "nu": nu}
    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float, sum_squares: Callable | None = None
                        ) -> GradientTransformation:
    """optax.clip_by_global_norm: where the global norm reaches max_norm,
    each update becomes t / norm * max_norm.  `sum_squares(grads)` gives
    the squared norm of gradients held as shards (DataParallel's)."""
    def update(grads, state, leaves):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads) if sum_squares is None
                          else sum_squares(grads))
        if bool(norm < max_norm):
            return grads, state
        return [g / norm.to(g.dtype) * max_norm for g in grads], state
    return GradientTransformation(lambda leaves: {}, update)


def chain(*transforms) -> GradientTransformation:
    def init(leaves):
        return {"chain": [t.init(leaves) for t in transforms]}

    def update(grads, state, leaves):
        states = []
        for t, s in zip(transforms, state["chain"]):
            grads, s = t.update(grads, s, leaves)
            states.append(s)
        return grads, {"chain": states}
    return GradientTransformation(init, update)


def multi_steps(inner: GradientTransformation, k: int) -> GradientTransformation:
    """optax.MultiSteps(inner, k): the running mean of k micro-gradients;
    the k-th applies inner to it, the others give zero updates and leave
    inner's state as it was."""
    def init(leaves):
        return {"mini_step": torch.zeros((), dtype=torch.int32),
                "gradient_step": torch.zeros((), dtype=torch.int32),
                "inner": inner.init(leaves), "acc": [torch.zeros_like(t) for t in leaves]}

    def update(grads, state, leaves):
        mini, gstep = int(state["mini_step"]), int(state["gradient_step"])
        acc = _leafwise(lambda g, a: a + (g - a) / (mini + 1), grads, state["acc"])
        if mini == k - 1:
            updates, inner_state = inner.update(acc, state["inner"], leaves)
            acc, gstep = [torch.zeros_like(a) for a in acc], gstep + 1
        else:
            updates, inner_state = [torch.zeros_like(a) for a in acc], state["inner"]
        return updates, {"mini_step": torch.tensor((mini + 1) % k, dtype=torch.int32),
                         "gradient_step": torch.tensor(gstep, dtype=torch.int32),
                         "inner": inner_state, "acc": acc}
    return GradientTransformation(init, update)


def make_optimizer(ocfg: dict, total_steps: int | None = None,
                   sum_squares: Callable | None = None) -> Optimizer:
    """The optimizer of a config dict (moshi_tpu train.py make_optimizer):
    clip_by_global_norm -> adamw(schedule) [-> MultiSteps].  Keys, all
    optional: lr (3e-4), schedule ("constant" | "cosine" | "linear"),
    warmup_steps (0), end_lr_ratio (0.1), b1 (0.9), b2 (0.95), eps (1e-8),
    weight_decay (0.0), grad_clip (0.0 = off), accum_steps (1);
    `total_steps` bounds the decay of cosine and linear; `sum_squares` is
    the clipping's squared norm of sharded gradients.  Every transformation
    acts leaf-wise but the clipping, so on shards as on whole leaves."""
    lr = float(ocfg.get("lr", 3e-4))
    warmup = int(ocfg.get("warmup_steps", 0))
    kind = ocfg.get("schedule", "constant")
    end_lr = lr * float(ocfg.get("end_lr_ratio", 0.1))
    horizon = max(int(total_steps or 0), warmup + 1)
    if kind == "constant":
        schedule = linear_schedule(0.0, lr, warmup) if warmup else lr
    elif kind == "cosine":
        alpha = 0.0 if lr == 0.0 else end_lr / lr
        schedule = join_schedules([linear_schedule(0.0, lr, warmup),
                                   cosine_decay_schedule(lr, horizon - warmup, alpha)],
                                  [warmup])
    elif kind == "linear":
        schedule = join_schedules([linear_schedule(0.0, lr, warmup),
                                   linear_schedule(lr, end_lr, horizon - warmup)], [warmup])
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    opt = adamw(schedule, b1=float(ocfg.get("b1", 0.9)), b2=float(ocfg.get("b2", 0.95)),
                eps=float(ocfg.get("eps", 1e-8)),
                weight_decay=float(ocfg.get("weight_decay", 0.0)))
    clip = float(ocfg.get("grad_clip", 0.0))
    if clip > 0:
        opt = chain(clip_by_global_norm(clip, sum_squares), opt)
    accum = int(ocfg.get("accum_steps", 1))
    if accum > 1:
        opt = multi_steps(opt, accum)
    return Optimizer(opt)


def masked(base: Optimizer, labels, label: str) -> Optimizer:
    """`base` over the leaves labelled `label` only; every other leaf keeps
    its value and has no optimizer state (optax.multi_transform with
    set_to_zero for the other labels)."""
    return Optimizer(base.transform, labels, label)


def lora_optimizer(base: Optimizer, params: dict) -> Optimizer:
    """`base` over the LoRA adapters (every LoRAWeight's a and b) only."""
    return masked(base, lora_labels(params), "adapter")


def apply_updates(params, paths, leaves, updates):
    return tree_replace(params, {p: (t + u).to(t.dtype)
                                 for p, t, u in zip(paths, leaves, updates)})


def value_and_grad(loss_fn, params, paths, *args):
    """(loss, aux, grads): loss_fn(params, *args) -> (loss, aux) and the
    gradient of loss at the leaves of `paths` (zeros where a leaf is not
    used)."""
    leaves = [_get(params, p).detach().requires_grad_(True) for p in paths]
    loss, aux = loss_fn(tree_replace(params, dict(zip(paths, leaves))), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), aux, list(grads)


# ------------------------------------------------------------ data parallel
class DataParallel:
    """A train step spread over the dp ranks of a (dp, 1) mesh
    (parallel/mesh.make_mesh), computing what one device computes on the
    global batch: each rank takes its rows of the global batch (`rows`),
    and its gradients are summed over the ranks (`reduce`) on every
    micro-step, before the optimizer sees them.  With `fsdp` the params and
    the optimizer state rest as this rank's shards (`shard`, per
    fsdp_param_spec and opt_state_spec; a leaf no dim of which dp divides
    stays whole), a step `gather`s the whole params, and a sharded leaf's
    gradient is reduce-scattered onto its shard (a whole leaf's is summed)
    where the optimizer acts; `sum_squares` is the clipping's squared
    global norm, counting a whole leaf once.  `paths`: the trained leaves,
    in the optimizer's order."""

    def __init__(self, mesh, params, paths: list, fsdp: bool = False):
        from .parallel.mesh import fsdp_param_spec
        self.mesh, self.paths, self.fsdp = mesh, list(paths), fsdp
        self.group = mesh.group("dp")
        self.size, self.index = mesh.shape["dp"], mesh.index("dp")
        self.specs = fsdp_param_spec(params, mesh) if fsdp else {}
        self.opt_specs = {}
        self.grad_dims = [next((i for i, a in enumerate(self.specs.get(p, ())) if a), None)
                          for p in self.paths]

    def rows(self, batch):
        """This rank's rows of a global batch."""
        b = batch.shape[0] // self.size
        return batch[self.index * b:(self.index + 1) * b]

    def shard(self, params, opt_state=None):
        """The whole params (and optimizer state) as this rank keeps them."""
        if self.fsdp:
            from .parallel.mesh import opt_state_spec, shard_tree
            if opt_state is not None:
                self.opt_specs = opt_state_spec(opt_state, params, self.specs, self.paths,
                                                self.mesh)
                opt_state = shard_tree(opt_state, self.mesh, self.opt_specs)
            params = shard_tree(params, self.mesh, self.specs)
        return params if opt_state is None else (params, opt_state)

    def gather(self, params, opt_state=None):
        """The whole params (and optimizer state) from every rank's shards
        (every rank calls it)."""
        if self.fsdp:
            from .parallel.mesh import gather_tree
            params = gather_tree(params, self.mesh, self.specs)
            if opt_state is not None:
                opt_state = gather_tree(opt_state, self.mesh, self.opt_specs)
        return params if opt_state is None else (params, opt_state)

    def reduce(self, grads: list, mean: bool = False) -> list:
        """Each rank's gradients of the trained leaves summed (or averaged)
        over the ranks: whole, or this rank's shard under fsdp."""
        out = []
        for g, dim in zip(grads, self.grad_dims):
            g = (collectives.all_reduce(g.contiguous(), self.group) if dim is None
                 else collectives.reduce_scatter(g, dim, self.group))
            out.append(g / self.size if mean else g)
        return out

    def total(self, t: torch.Tensor, mean: bool = False) -> torch.Tensor:
        """A per-rank value summed (or averaged) over the ranks."""
        t = collectives.all_reduce(t.detach().clone(), self.group)
        return t / self.size if mean else t

    def sum_squares(self, grads: list) -> torch.Tensor:
        whole = [torch.sum(g * g) for g, d in zip(grads, self.grad_dims) if d is None]
        shards = [torch.sum(g * g) for g, d in zip(grads, self.grad_dims) if d is not None]
        total = sum(whole)
        if shards:
            total = total + collectives.all_reduce(sum(shards).clone(), self.group)
        return total


# ------------------------------------------------------------------ LM half
def make_loss_fn(model: LMModel, group=None):
    """loss_fn(params, codes [B, K, T]) -> (audio_ce + text_ce, metrics).
    NaN logits (the delayed tails of `undelay_logits`) become 0 before the
    masked CE, as in the JAX package: log_softmax's backward would turn a
    NaN row's zero upstream gradient into NaN.  With a data-parallel
    `group`, codes are this rank's rows and each CE divides by the global
    batch's count of valid positions, so the ranks' losses and gradients sum
    to the global batch's."""
    c = model.config

    def loss_fn(params, codes):
        out = model.forward(params, codes)
        counts = [None, None]
        if group is not None:
            counts = collectives.all_reduce(
                torch.stack([out["mask"].sum(), out["text_mask"].sum()]), group)
        audio_ce = cross_entropy(
            torch.nan_to_num(out["logits"]),
            codes[:, c.audio_offset:c.audio_offset + c.dep_q].clamp(min=0), out["mask"],
            counts[0])
        text_ce = cross_entropy(torch.nan_to_num(out["text_logits"]),
                                codes[:, :1].clamp(min=0), out["text_mask"], counts[1])
        return audio_ce + text_ce, {"audio_ce": audio_ce.detach(),
                                    "text_ce": text_ce.detach()}
    return loss_fn


def make_train_step(model: LMModel, optimizer: Optimizer, dp: DataParallel | None = None):
    """train_step(params, opt_state, codes) -> (params, opt_state, loss,
    metrics): a new tree whose trained leaves are updated (the others are
    the same tensors).  With `dp`, codes are this rank's rows, the params
    and state are what the rank keeps, and the loss and metrics are the
    global batch's on every rank."""
    loss_fn = make_loss_fn(model, dp and dp.group)

    def train_step(params, opt_state, codes):
        whole = params if dp is None else dp.gather(params)
        paths = optimizer.select(whole)
        loss, metrics, grads = value_and_grad(loss_fn, whole, paths, codes)
        del whole
        if dp is not None:
            grads = dp.reduce(grads)
            loss, metrics = dp.total(loss), {k: dp.total(v) for k, v in metrics.items()}
        leaves = [_get(params, p) for p in paths]
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        return apply_updates(params, paths, leaves, updates), opt_state, loss, metrics
    return train_step


# --------------------------------------------------------------- codec half
def _stft_mag(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """x [B, T] -> magnitude spectrogram [B, frames, n_fft // 2 + 1]: frames
    of n_fft every hop, a symmetric Hann window, rfft."""
    window = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(x.device)
    frames = x.unfold(-1, n_fft, hop) * window
    return torch.abs(torch.fft.rfft(frames, dim=-1))


def spectral_loss(a: torch.Tensor, b: torch.Tensor,
                  scales=(64, 128, 256, 512, 1024)) -> torch.Tensor:
    """Multi-resolution STFT loss (magnitude L1 plus log-magnitude L1),
    averaged over the scales no longer than the signal."""
    total, n = 0.0, 0
    for n_fft in scales:
        if a.shape[-1] < n_fft:
            continue
        ma, mb = _stft_mag(a, n_fft, n_fft // 4), _stft_mag(b, n_fft, n_fft // 4)
        total = total + torch.mean(torch.abs(ma - mb)) + torch.mean(
            torch.abs(torch.log(ma + 1e-5) - torch.log(mb + 1e-5)))
        n += 1
    return total / max(n, 1)


def init_mimi_vq_state(mimi, device=None) -> dict:
    """EMA codebook state of the split quantizer (semantic and acoustic)."""
    from .quantization.train import init_train_state
    q = mimi.quantizer
    return {"first": init_train_state(q.rvq_first.config, device),
            "rest": init_train_state(q.rvq_rest.config, device)}


def make_mimi_loss_fn(mimi, tcfg=None, loss_weights: dict | None = None, group=None):
    """loss_fn(params, vq_state, pcm [B, 1, T], generator) -> (loss,
    metrics, new_vq_state): the offline Mimi forward with the EMA RVQ in the
    middle; gradients reach the encoder through the commit loss and the
    straight-through estimator, and the decoder.  With a data-parallel
    `group`, pcm is this rank's rows: the RVQ's statistics and draws are
    taken over every rank's embeddings (gathered), as one device takes them
    over the global batch, and the losses are means over this rank's rows."""
    from .quantization.train import RVQTrainConfig, rvq_train_forward
    tcfg = tcfg or RVQTrainConfig()
    w = {"l1": 1.0, "mstft": 1.0, "commit": 0.25, **(loss_weights or {})}
    q = mimi.quantizer

    def loss_fn(params, vq_state, pcm, generator):
        fs = mimi.frame_size
        pcm = pcm[..., :pcm.shape[-1] - pcm.shape[-1] % fs]
        emb = mimi.encoder.apply(params["encoder"], pcm.transpose(1, 2))
        (emb,) = mimi.encoder_transformer.apply(params["encoder_transformer"], emb)
        emb = mimi.downsample.apply(params["downsample"], emb)
        rows = None
        if group is not None:
            # the global batch's embeddings, this rank's rows the live ones
            b = emb.shape[0]
            rows = (dist.get_rank(group) * b, (dist.get_rank(group) + 1) * b)
            every = collectives.all_gather(emb.detach(), 0, group)
            emb = torch.cat([every[:rows[0]], emb, every[rows[1]:]])
        r1, st1 = rvq_train_forward(q.rvq_first.config, tcfg, params["quantizer"]["rvq_first"],
                                    vq_state["first"], emb, generator, rows=rows)
        r2, st2 = rvq_train_forward(q.rvq_rest.config, tcfg, params["quantizer"]["rvq_rest"],
                                    vq_state["rest"], emb, generator, rows=rows)
        out = mimi.upsample.apply(params["upsample"], r1["quantized"] + r2["quantized"])
        (out,) = mimi.decoder_transformer.apply(params["decoder_transformer"], out)
        recon = mimi.decoder.apply(params["decoder"], out).transpose(1, 2)
        n = min(recon.shape[-1], pcm.shape[-1])
        a, b = recon[:, 0, :n], pcm[:, 0, :n]
        l1 = torch.mean(torch.abs(a - b))
        mstft = spectral_loss(a, b)
        commit = r1["commit_loss"] + r2["commit_loss"]
        loss = w["l1"] * l1 + w["mstft"] * mstft + w["commit"] * commit
        metrics = {"l1": l1, "mstft": mstft, "commit": commit,
                   "entropy": 0.5 * (r1["entropy"] + r2["entropy"]),
                   "expired_frac": 0.5 * (r1["expired_frac"] + r2["expired_frac"])}
        return loss, ({k: v.detach() for k, v in metrics.items()},
                      {"first": st1, "rest": st2})
    return loss_fn


def mimi_ema_label_tree(params: dict):
    """Labels of a Mimi tree: "ema" for the quantizer's codebooks (the EMA
    updates them, the optimizer leaves them), "train" for every other
    leaf."""
    def label(tree, path):
        if isinstance(tree, dict):
            return {k: label(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(label(v, path + (str(i),)) for i, v in enumerate(tree))
        return "ema" if "quantizer" in path and "embedding" in path else "train"
    return label(params, ())


def make_mimi_train_step(mimi, optimizer: Optimizer, tcfg=None,
                         loss_weights: dict | None = None, dp: DataParallel | None = None):
    """train_step(params, vq_state, opt_state, pcm, generator) -> (params,
    vq_state, opt_state, loss, metrics); `dp` as make_train_step's (each
    rank's loss is the mean over its rows, so the gradients are averaged)."""
    loss_fn = make_mimi_loss_fn(mimi, tcfg, loss_weights, dp and dp.group)

    def train_step(params, vq_state, opt_state, pcm, generator):
        whole = params if dp is None else dp.gather(params)
        paths = optimizer.select(whole)
        loss, (metrics, vq_state), grads = value_and_grad(loss_fn, whole, paths, vq_state,
                                                          pcm, generator)
        del whole
        if dp is not None:
            grads = dp.reduce(grads, mean=True)
            loss = dp.total(loss, mean=True)
            metrics = {k: dp.total(v, mean=True) for k, v in metrics.items()}
        leaves = [_get(params, p) for p in paths]
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        return (apply_updates(params, paths, leaves, updates), vq_state, opt_state, loss,
                metrics)
    return train_step


def sync_codebooks_from_vq_state(params: dict, vq_state: dict,
                                 epsilon: float = 1e-5) -> dict:
    """The params with each RVQ's codebook set to its EMA state's
    embedding_sum / usage, the inference codebook."""
    from .quantization.train import embedding_from_state
    q = params["quantizer"]
    return {**params, "quantizer": {
        name: {**q[name], "embedding": embedding_from_state(vq_state[key], epsilon)}
        for name, key in (("rvq_first", "first"), ("rvq_rest", "rest"))}}


# ------------------------------------------------------- checkpoint / resume
def save_train_state(path, params, opt_state, step: int,
                     generator: torch.Generator | None = None) -> int:
    """One native safetensors file of the whole training state: params
    (quantized and LoRA leaves included), the optimizer state tree, the
    step and the generator's state; returns the bytes written."""
    meta = {"step": torch.tensor(step, dtype=torch.int32)}
    if generator is not None:
        meta["rng"] = generator.get_state()
    return native_ckpt.save_params(path, {"params": params, "opt_state": opt_state,
                                          "meta": meta})


def load_train_state(path, device=None):
    """(params, opt_state, step, generator state or None) of a file that
    save_train_state wrote, the tensors on `device`."""
    tree = native_ckpt.load_params(path, device)
    meta = tree["meta"]
    rng = meta.get("rng")
    return (tree["params"], tree["opt_state"], int(meta["step"]),
            None if rng is None else rng.cpu())


# ------------------------------------------------------------------- CLI
def _build_lm(cfg: dict, device):
    if cfg.get("checkpoint_dir"):
        from .models.loaders import CheckpointInfo
        return CheckpointInfo.from_dir(cfg["checkpoint_dir"]).get_moshi(
            dtype=torch.float32, device=device)
    model = LMModel(LmConfig.from_dict(dict(cfg["lm_config"])))
    g = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 0)))
    return model, model.init_params(g, dtype=torch.float32, device=device)


def _build_mimi(cfg: dict, device):
    from .models.loaders import mimi_config_from_dict
    from .models.mimi import MimiModel
    if cfg.get("checkpoint_dir"):
        from .models.loaders import CheckpointInfo
        return CheckpointInfo.from_dir(cfg["checkpoint_dir"]).get_mimi(device=device)
    model = MimiModel(mimi_config_from_dict(dict(cfg["mimi_config"]),
                                            cfg.get("num_codebooks", 8)))
    g = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 0)))
    return model, model.init_params(g, dtype=torch.float32, device=device)


def _check_lm_codes(model, batch: np.ndarray):
    """Refuse a training batch with out-of-range tokens (the model's embed
    clamps them, which would hide a data bug): text in [0, text_card],
    audio in [0, card], or -1 (masked)."""
    c = model.config
    text, audio = batch[:, :1], batch[:, 1:]
    bad_text = (text != -1) & ((text < 0) | (text > c.text_card))
    bad_audio = (audio != -1) & ((audio < 0) | (audio > c.card))
    if bad_text.any() or bad_audio.any():
        ex = np.concatenate([text[bad_text].ravel(), audio[bad_audio].ravel()])
        raise ValueError(f"training batch contains out-of-range tokens (e.g. {ex[:5]}); "
                         f"valid: text [0,{c.text_card}], audio [0,{c.card}], or -1")


def _data_batches(cfg: dict, target: str, model, steps: int):
    """`steps` numpy batches, the JAX package's: synthetic_repeat (one
    seeded batch, the overfit harness), synthetic (a fresh one each step) or
    safetensors {path, key} (cycled along axis 0)."""
    d = dict(cfg.get("data", {"kind": "synthetic_repeat"}))
    kind = d.get("kind", "synthetic_repeat")
    B = int(cfg.get("batch_size", 2))
    T = int(cfg.get("seq_len", 8))
    rs = np.random.RandomState(int(d.get("seed", 0)))
    if kind in ("synthetic_repeat", "synthetic"):
        def make():
            if target == "lm":
                return rs.randint(0, min(model.config.card, model.config.text_card),
                                  size=(B, model.config.num_codebooks, T)).astype(np.int32)
            return (rs.randn(B, 1, T * model.frame_size) * 0.3).astype(np.float32)
        fixed = make() if kind == "synthetic_repeat" else None
        for _ in range(steps):
            yield fixed if fixed is not None else make()
    elif kind == "safetensors":
        from .utils.safetensors import load_file
        arr = load_file(d["path"])[d.get("key", "codes" if target == "lm" else "pcm")].numpy()
        n, i = arr.shape[0], 0
        for _ in range(steps):
            idx = [(i + j) % n for j in range(B)]
            i = (i + B) % n
            yield np.ascontiguousarray(arr[idx])
    else:
        raise ValueError(f"unknown data kind {kind!r}")


LAUNCH = ("launch one process per rank (torchrun --nproc_per_node DP -m "
          "moshi_tpu_torch.train --config CONFIG), or call run_training inside an "
          "initialized process group of DP ranks")


def _check_mesh(cfg: dict) -> tuple[int, bool]:
    """A config's (mesh.dp, mesh.fsdp), dp 0 without a mesh: fsdp without
    two dp ranks is refused as the JAX package's trainer refuses it, and a
    batch that does not split into dp equal shards."""
    mesh = dict(cfg.get("mesh", {}))
    dp, fsdp = int(mesh.get("dp", 0)), bool(mesh.get("fsdp", False))
    if fsdp and dp < 2:
        # a config that claims ZeRO-3 but would run replicated
        raise ValueError(f"mesh.fsdp requires mesh.dp >= 2 (got dp={dp}); "
                         "FSDP shards params/optimizer state over the dp axis")
    batch = int(cfg.get("batch_size", 2))
    if dp and batch % dp:
        raise ValueError(f"batch_size {batch} does not split into mesh.dp = {dp} equal shards")
    return dp, fsdp


def _join_mesh(dp: int, device: torch.device):
    """(mesh, device) of a config's mesh.dp: a (dp, 1) mesh over the
    initialized process group, or over one initialized here from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL on
    cuda:LOCAL_RANK (or the device's own index), gloo on the CPU.  Without
    either, dp 1 trains on one device (None, device)."""
    from .parallel.mesh import make_mesh
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            if dp >= 2:
                raise ValueError(f"mesh.dp = {dp} trains over {dp} processes and no process "
                                 f"group is initialized: {LAUNCH}")
            return None, device
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    world = dist.get_world_size()
    if world != dp:
        raise ValueError(f"mesh.dp = {dp} in a process group of {world} ranks: {LAUNCH}")
    return make_mesh(dp, tp=1), device


def run_training(cfg: dict, log=print, device=None) -> dict:
    """Run a training config; returns {step, loss, metrics, params,
    opt_state, vq_state, dp}.  `device` (default cfg["device"], else
    "cuda").  With a `mesh` (_join_mesh), `dp` is the step's DataParallel,
    the params and optimizer state are what this rank keeps (under fsdp its
    shards: dp.gather gives them whole), the loss is the global batch's, and
    only rank 0 logs and saves."""
    device = torch.device(device or cfg.get("device", "cuda"))
    target = cfg.get("target", "lm")
    steps = int(cfg.get("steps", 100))
    ocfg = dict(cfg.get("optimizer", {}))
    accum = int(ocfg.get("accum_steps", 1))
    log_every = int(cfg.get("log_every", 20))
    save_every = int(cfg.get("save_every", 0))
    out_dir = cfg.get("out_dir")
    n_dp, fsdp = _check_mesh(cfg)
    mesh = None
    if n_dp:
        mesh, device = _join_mesh(n_dp, device)
    rank0 = mesh is None or mesh.rank == 0
    if not rank0:
        def log(line):
            pass
    generator = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 0)))

    if target == "lm":
        model, params = _build_lm(cfg, device)
        if cfg.get("lora_only") and not has_lora(params):
            raise ValueError(
                "lora_only: the params hold no LoRAWeight, so nothing would train; "
                "add adapters with models.lora.replace_all_linear_with_lora (and save "
                "the tree as a native checkpoint for the CLI)")

        def trained(opt):
            return lora_optimizer(opt, params) if cfg.get("lora_only") else opt
    elif target == "mimi":
        model, params = _build_mimi(cfg, device)

        def trained(opt):
            return masked(opt, mimi_ema_label_tree(params), "train")
    else:
        raise ValueError(f"unknown target {target!r}")
    dp = None
    if mesh is not None:
        dp = DataParallel(mesh, params, trained(make_optimizer({})).select(params), fsdp)
    optimizer = trained(make_optimizer(ocfg, steps * accum, dp.sum_squares if fsdp else None))
    if target == "lm":
        step_fn = make_train_step(model, optimizer, dp)
        vq_state = None
    else:
        from .quantization.train import RVQTrainConfig
        step_fn = make_mimi_train_step(model, optimizer, RVQTrainConfig(**cfg.get("rvq", {})),
                                       cfg.get("loss_weights"), dp)
        vq_state = init_mimi_vq_state(model, device)
    opt_state = optimizer.init(params)

    start = 0
    if cfg.get("resume"):
        params, opt_state, start, rng = load_train_state(cfg["resume"], device)
        if rng is not None:
            generator.set_state(rng)
        if target == "mimi":
            vq_state = native_ckpt.load_params(str(cfg["resume"]) + ".vq", device)
        log(json.dumps({"event": "resumed", "step": start}))
    if dp is not None:
        params, opt_state = dp.shard(params, opt_state)
        if device.type == "cuda" and dist.get_backend(dp.group) == "gloo":
            log(json.dumps({"event": "mesh", "note": "gloo moves the collectives' CUDA "
                            "tensors through host memory"}))

    def save(step_no):
        p, o = (params, opt_state) if dp is None else dp.gather(params, opt_state)
        if rank0:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            path = str(Path(out_dir) / f"train-{step_no:06d}.safetensors")
            save_train_state(path, p, o, step_no, generator)
            if vq_state is not None:
                native_ckpt.save_params(path + ".vq", vq_state)
            log(json.dumps({"event": "saved", "path": path, "step": step_no}))
        if dp is not None:
            dist.barrier(dp.group)

    loss = metrics = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)   # the logged peak is the steps'
    t0 = time.time()
    batches = _data_batches(cfg, target, model, (steps - start) * accum)
    for step_no in range(start, steps):
        for _ in range(accum):
            batch = next(batches)
            if target == "lm":
                _check_lm_codes(model, batch)
            if dp is not None:
                batch = dp.rows(batch)
            if target == "lm":
                params, opt_state, loss, metrics = step_fn(
                    params, opt_state, torch.from_numpy(batch).long().to(device))
            else:
                params, vq_state, opt_state, loss, metrics = step_fn(
                    params, vq_state, opt_state, torch.from_numpy(batch).to(device), generator)
        if log_every and (step_no + 1) % log_every == 0:
            line = {"step": step_no + 1, "loss": float(loss),
                    **{k: float(v) for k, v in metrics.items()},
                    "sec_per_step": (time.time() - t0) / (step_no + 1 - start)}
            if device.type == "cuda":
                line["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            log(json.dumps(line))
        if out_dir and save_every and (step_no + 1) % save_every == 0:
            save(step_no + 1)

    if target == "mimi":
        if dp is None:
            params = sync_codebooks_from_vq_state(params, vq_state)
        else:
            params = dp.shard(sync_codebooks_from_vq_state(dp.gather(params), vq_state))
    if out_dir:
        save(steps)
    return {"step": steps, "loss": float(loss),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "params": params, "opt_state": opt_state, "vq_state": vq_state, "dp": dp}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Config-driven trainer (LM cross entropy or the Mimi codec)")
    parser.add_argument("--config", required=True, help="JSON training config (run_training)")
    parser.add_argument("--steps", type=int, default=None, help="override the config's steps")
    parser.add_argument("--out-dir", default=None, help="override the config's out_dir")
    parser.add_argument("--resume", default=None, help="override the config's resume file")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the config's, else cuda)")
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic CUDA algorithms (cuDNN, cuBLAS, index_add), "
                             "so a resumed run repeats the uninterrupted one bit for bit; "
                             "slower")
    args = parser.parse_args(argv)
    cfg = json.loads(Path(args.config).read_text())
    for key, value in (("steps", args.steps), ("out_dir", args.out_dir),
                       ("resume", args.resume), ("device", args.device)):
        if value is not None:
            cfg[key] = value
    device = torch.device(cfg.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: torch sees no CUDA device (pass --device cpu)")
    if args.deterministic:
        # cuBLAS reads this when it makes its first handle, which nothing
        # before this point has done
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.benchmark = False
    joined = dist.is_initialized()
    try:
        out = run_training(cfg)
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()
    if out["dp"] is None or out["dp"].mesh.rank == 0:
        print(json.dumps({"final_step": out["step"], "final_loss": out["loss"],
                          **out["metrics"]}), flush=True)
    return out


if __name__ == "__main__":
    main()
