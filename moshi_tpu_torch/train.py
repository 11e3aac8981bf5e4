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
(without it cuDNN's convolutions and index_add's atomics may reorder sums).  Not ported: the JAX package's dp / fsdp mesh (ROADMAP A.13).  A
`lora_only` config whose params hold no LoRAWeight is refused: the JAX
package's CLI trains nothing there, silently (ROADMAP C.10).
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

from .models import native_ckpt
from .models.lm import LMModel, LmConfig, cross_entropy
from .models.lora import LoRAWeight, has_lora, lora_labels
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


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: where the global norm reaches max_norm,
    each update becomes t / norm * max_norm."""
    def update(grads, state, leaves):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
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


def make_optimizer(ocfg: dict, total_steps: int | None = None) -> Optimizer:
    """The optimizer of a config dict (moshi_tpu train.py make_optimizer):
    clip_by_global_norm -> adamw(schedule) [-> MultiSteps].  Keys, all
    optional: lr (3e-4), schedule ("constant" | "cosine" | "linear"),
    warmup_steps (0), end_lr_ratio (0.1), b1 (0.9), b2 (0.95), eps (1e-8),
    weight_decay (0.0), grad_clip (0.0 = off), accum_steps (1);
    `total_steps` bounds the decay of cosine and linear."""
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
        opt = chain(clip_by_global_norm(clip), opt)
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


# ------------------------------------------------------------------ LM half
def make_loss_fn(model: LMModel):
    """loss_fn(params, codes [B, K, T]) -> (audio_ce + text_ce, metrics).
    NaN logits (the delayed tails of `undelay_logits`) become 0 before the
    masked CE, as in the JAX package: log_softmax's backward would turn a
    NaN row's zero upstream gradient into NaN."""
    c = model.config

    def loss_fn(params, codes):
        out = model.forward(params, codes)
        audio_ce = cross_entropy(
            torch.nan_to_num(out["logits"]),
            codes[:, c.audio_offset:c.audio_offset + c.dep_q].clamp(min=0), out["mask"])
        text_ce = cross_entropy(torch.nan_to_num(out["text_logits"]),
                                codes[:, :1].clamp(min=0), out["text_mask"])
        return audio_ce + text_ce, {"audio_ce": audio_ce.detach(),
                                    "text_ce": text_ce.detach()}
    return loss_fn


def make_train_step(model: LMModel, optimizer: Optimizer):
    """train_step(params, opt_state, codes) -> (params, opt_state, loss,
    metrics): a new tree whose trained leaves are updated (the others are
    the same tensors)."""
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, codes):
        paths = optimizer.select(params)
        loss, metrics, grads = value_and_grad(loss_fn, params, paths, codes)
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


def make_mimi_loss_fn(mimi, tcfg=None, loss_weights: dict | None = None):
    """loss_fn(params, vq_state, pcm [B, 1, T], generator) -> (loss,
    metrics, new_vq_state): the offline Mimi forward with the EMA RVQ in the
    middle; gradients reach the encoder through the commit loss and the
    straight-through estimator, and the decoder."""
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
        r1, st1 = rvq_train_forward(q.rvq_first.config, tcfg, params["quantizer"]["rvq_first"],
                                    vq_state["first"], emb, generator)
        r2, st2 = rvq_train_forward(q.rvq_rest.config, tcfg, params["quantizer"]["rvq_rest"],
                                    vq_state["rest"], emb, generator)
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
                         loss_weights: dict | None = None):
    """train_step(params, vq_state, opt_state, pcm, generator) -> (params,
    vq_state, opt_state, loss, metrics)."""
    loss_fn = make_mimi_loss_fn(mimi, tcfg, loss_weights)

    def train_step(params, vq_state, opt_state, pcm, generator):
        paths = optimizer.select(params)
        loss, (metrics, vq_state), grads = value_and_grad(loss_fn, params, paths, vq_state,
                                                          pcm, generator)
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


def _check_mesh(cfg: dict) -> None:
    mesh = dict(cfg.get("mesh", {}))
    if int(mesh.get("dp", 0)) >= 2 or mesh.get("fsdp"):
        raise NotImplementedError(f"mesh {mesh}: data-parallel and FSDP training are not "
                                  "ported yet (ROADMAP A.13); the port trains on one device")


def run_training(cfg: dict, log=print, device=None) -> dict:
    """Run a training config; returns {step, loss, metrics, params,
    opt_state, vq_state}.  `device` (default cfg["device"], else "cuda")."""
    device = torch.device(device or cfg.get("device", "cuda"))
    target = cfg.get("target", "lm")
    steps = int(cfg.get("steps", 100))
    ocfg = dict(cfg.get("optimizer", {}))
    accum = int(ocfg.get("accum_steps", 1))
    log_every = int(cfg.get("log_every", 20))
    save_every = int(cfg.get("save_every", 0))
    out_dir = cfg.get("out_dir")
    _check_mesh(cfg)
    generator = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 0)))

    if target == "lm":
        model, params = _build_lm(cfg, device)
        optimizer = make_optimizer(ocfg, steps * accum)
        if cfg.get("lora_only"):
            if not has_lora(params):
                raise ValueError(
                    "lora_only: the params hold no LoRAWeight, so nothing would train; "
                    "add adapters with models.lora.replace_all_linear_with_lora (and save "
                    "the tree as a native checkpoint for the CLI)")
            optimizer = lora_optimizer(optimizer, params)
        step_fn = make_train_step(model, optimizer)
        vq_state = None
    elif target == "mimi":
        from .quantization.train import RVQTrainConfig
        model, params = _build_mimi(cfg, device)
        optimizer = masked(make_optimizer(ocfg, steps * accum), mimi_ema_label_tree(params),
                           "train")
        step_fn = make_mimi_train_step(model, optimizer, RVQTrainConfig(**cfg.get("rvq", {})),
                                       cfg.get("loss_weights"))
        vq_state = init_mimi_vq_state(model, device)
    else:
        raise ValueError(f"unknown target {target!r}")
    opt_state = optimizer.init(params)

    start = 0
    if cfg.get("resume"):
        params, opt_state, start, rng = load_train_state(cfg["resume"], device)
        if rng is not None:
            generator.set_state(rng)
        if target == "mimi":
            vq_state = native_ckpt.load_params(str(cfg["resume"]) + ".vq", device)
        log(json.dumps({"event": "resumed", "step": start}))

    def save(step_no):
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        path = str(Path(out_dir) / f"train-{step_no:06d}.safetensors")
        save_train_state(path, params, opt_state, step_no, generator)
        if vq_state is not None:
            native_ckpt.save_params(path + ".vq", vq_state)
        log(json.dumps({"event": "saved", "path": path, "step": step_no}))

    loss = metrics = None
    t0 = time.time()
    batches = _data_batches(cfg, target, model, (steps - start) * accum)
    for step_no in range(start, steps):
        for _ in range(accum):
            batch = next(batches)
            if target == "lm":
                _check_lm_codes(model, batch)
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
        params = sync_codebooks_from_vq_state(params, vq_state)
    if out_dir:
        save(steps)
    return {"step": steps, "loss": float(loss),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "params": params, "opt_state": opt_state, "vq_state": vq_state}


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
    out = run_training(cfg)
    print(json.dumps({"final_step": out["step"], "final_loss": out["loss"],
                      **out["metrics"]}), flush=True)
    return out


if __name__ == "__main__":
    main()
