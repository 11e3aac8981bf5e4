"""The port's LM training (moshi_tpu_torch/train.py) against moshi_tpu's, in
f32 on the CPU: the loss, its parts and every trained gradient over a dense
base and over LoRA adapters on int8 and q4 bases; the optimizer chain
(schedules, warmup, clipping, weight decay, accumulation) against optax;
remat; bitwise resume through the CLI; a LoRA tree saved by the JAX
package; the tiny LM overfit by run_training; and what the CLI refuses."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moshi_tpu import train as jtrain
from moshi_tpu.models import lora as jlora
from moshi_tpu_torch import train as ttrain
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.modules.transformer import StreamingTransformer
from moshi_tpu_torch.utils.params import from_jax
from test_torch_lora import codes_for, jax_lora_tree, lora_paths
from test_torch_lora import one_thread  # noqa: F401  (autouse)
from test_torch_port import port_lm_config

LOSS_TOL = 1e-5   # f32 loss, relative
GRAD_TOL = 1e-4   # f32 gradient of a leaf, max |diff| / max |JAX|
OPT_TOL = 2e-6    # f32 params after 3 updates, max |diff| / max |JAX|


def _with_adapters(tree, ab, path=()):
    """The JAX tree with the adapters of `ab` ({path: (a, b)}) put in."""
    if isinstance(tree, dict):
        return {k: _with_adapters(v, ab, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, jlora.LoRAWeight):
        a, b = ab[path]
        return jlora.LoRAWeight(tree.base, a, b, tree.scaling)
    return tree


@pytest.mark.parametrize("base", ["dense", "int8", "int4"])
def test_loss_and_gradients_match_jax(base):
    """make_loss_fn's loss, audio_ce and text_ce, and the gradient of every
    trained leaf: the whole f32 tree over a dense base, the adapters over a
    quantized one (whose FrozenLinear backward carries the gradient through
    every frozen linear)."""
    cfg, jlm, params, jlp = jax_lora_tree(None if base == "dense" else base)
    codes = codes_for(cfg, T=8, seed=2)
    codes[0, 3, 5] = -1  # a masked position
    jloss_fn = jtrain.make_loss_fn(jlm)
    model = TLM(port_lm_config(cfg))
    if base == "dense":
        (jloss, jm), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
            params, jnp.asarray(codes))
        tparams = from_jax(jax.device_get(params))
        paths = ttrain.make_optimizer({}).select(tparams)
        want = {p: ttrain._get(from_jax(jax.device_get(jg)), p) for p in paths}
    else:
        # the JAX package's layer scan cannot carry a LoRAWeight over a q4
        # base (its QTensor4Ref is no pytree), so JAX's side of a q4 base is
        # the base dequantized to f32, which is what its CPU wdot computes
        # for a QTensor4 (dot(x, w.astype(x.dtype)))
        tparams = from_jax(jax.device_get(jlp))
        jlp = jax.tree.map(
            lambda w: jlora.LoRAWeight(w.base.astype(jnp.float32), w.a, w.b, w.scaling)
            if isinstance(w, jlora.LoRAWeight) and type(w.base).__name__ == "QTensor4" else w,
            jlp, is_leaf=lambda x: isinstance(x, jlora.LoRAWeight))
        ab = {p: (w.a, w.b) for p, w in lora_paths(jlp).items()}
        (jloss, jm), jg = jax.jit(jax.value_and_grad(
            lambda ab: jloss_fn(_with_adapters(jlp, ab), jnp.asarray(codes)), has_aux=True))(ab)
        paths = ttrain.lora_optimizer(ttrain.make_optimizer({}), tparams).select(tparams)
        want = {p + (name,): torch.from_numpy(np.asarray(g))
                for p, pair in jg.items() for name, g in zip("ab", pair)}
    assert sorted(map(str, paths)) == sorted(map(str, want)) and len(paths) > 11
    loss, metrics, grads = ttrain.value_and_grad(ttrain.make_loss_fn(model), tparams, paths,
                                                 torch.from_numpy(codes).long())
    for got, ref in ((loss, jloss), (metrics["audio_ce"], jm["audio_ce"]),
                     (metrics["text_ce"], jm["text_ce"])):
        assert abs(float(got) - float(ref)) <= LOSS_TOL * abs(float(ref))
    for p, g in zip(paths, grads):
        ref = want[p].float()
        assert float(ref.abs().max()) > 0, p
        assert float((g - ref).abs().max()) <= GRAD_TOL * float(ref.abs().max()), p


OPT_CASES = {
    "constant": {"lr": 1e-2, "schedule": "constant", "warmup_steps": 0, "grad_clip": 0.8,
                 "weight_decay": 0.1},
    "constant_warmup": {"lr": 1e-2, "schedule": "constant", "warmup_steps": 2},
    "cosine": {"lr": 1e-2, "schedule": "cosine", "warmup_steps": 1, "grad_clip": 1.5,
               "weight_decay": 0.05, "accum_steps": 2},
    "linear": {"lr": 2e-2, "schedule": "linear", "warmup_steps": 1, "end_lr_ratio": 0.3,
               "b1": 0.8, "b2": 0.9, "eps": 1e-6, "accum_steps": 2},
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """make_optimizer gives the JAX package's params after 3 updates (6
    micro-steps with accum_steps 2), from the same gradients."""
    ocfg = OPT_CASES[case]
    accum = ocfg.get("accum_steps", 1)
    rs = np.random.RandomState(len(case))
    params = {"w": rs.randn(5, 3).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3 * accum)]
    jopt = jtrain.make_optimizer(ocfg, total_steps=3 * accum)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    topt = ttrain.make_optimizer(ocfg, total_steps=3 * accum)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = topt.init(tp)
    paths = topt.select(tp)
    for g in grads:
        u, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        leaves = [tp[p[0]] for p in paths]
        tu, ts = topt.update([torch.from_numpy(g[p[0]]) for p in paths], ts, leaves)
        tp = ttrain.apply_updates(tp, paths, leaves, tu)
    for k, v in jp.items():
        ref = np.asarray(v)
        assert not np.array_equal(ref, params[k]), k
        assert float(np.abs(tp[k].numpy() - ref).max()) <= OPT_TOL * float(np.abs(ref).max()), k


def test_remat_gives_the_same_gradients(monkeypatch):
    """remat recomputes each temporal layer in the backward: the same loss
    and gradients, bit for bit, and the temporal layers run twice."""
    cfg, _, params, _ = jax_lora_tree()
    tparams = from_jax(jax.device_get(params))
    codes = torch.from_numpy(codes_for(cfg, T=6, seed=3)).long()
    calls = []
    layer = StreamingTransformer._layer

    def counted(self, *args):
        calls.append(self.config.d_model)
        return layer(self, *args)
    monkeypatch.setattr(StreamingTransformer, "_layer", counted)
    out = {}
    for remat in (False, True):
        model = TLM(dataclasses.replace(port_lm_config(cfg), remat=remat))
        paths = ttrain.make_optimizer({}).select(tparams)
        calls.clear()
        out[remat] = ttrain.value_and_grad(ttrain.make_loss_fn(model), tparams, paths, codes)
        out[remat] += (calls.count(cfg.dim), calls.count(cfg.depformer_dim))
    (l0, _, g0, n0, d0), (l1, _, g1, n1, d1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert (n0, n1, d0, d1) == (cfg.num_layers, 2 * cfg.num_layers,
                                cfg.depformer_num_layers, cfg.depformer_num_layers)


def _tiny_lm_train_cfg(cfg, **over):
    d = {"target": "lm",
         "lm_config": {k: list(v) if isinstance(v, tuple) else v
                       for k, v in dataclasses.asdict(port_lm_config(cfg)).items()},
         "optimizer": {"lr": 3e-3, "schedule": "cosine", "warmup_steps": 5, "grad_clip": 1.0},
         "steps": 60, "batch_size": 2, "seq_len": 8, "log_every": 0, "device": "cpu"}
    d.update(over)
    return d


def test_resume_through_the_cli_is_bitwise(tmp_path):
    """main(--config) saves at step 3; --resume finishes the run with the
    params, optimizer state and loss of an uninterrupted run, bit for bit
    (accum_steps 2, so the accumulator resumes too)."""
    cfg, _, _, _ = jax_lora_tree()
    conf = _tiny_lm_train_cfg(cfg, steps=5, optimizer={"lr": 3e-3, "accum_steps": 2,
                                                      "grad_clip": 1.0})
    (tmp_path / "c.json").write_text(json.dumps(conf))
    full = ttrain.run_training(conf, log=lambda line: None)
    ttrain.main(["--config", str(tmp_path / "c.json"), "--steps", "3",
                 "--out-dir", str(tmp_path / "ck"), "--device", "cpu"])
    ckpt = tmp_path / "ck" / "train-000003.safetensors"
    params, _, step, rng = ttrain.load_train_state(ckpt)
    assert step == 3 and rng is not None
    resumed = ttrain.main(["--config", str(tmp_path / "c.json"), "--resume", str(ckpt),
                           "--device", "cpu"])
    assert resumed["loss"] == full["loss"]
    for tree in ("params", "opt_state"):
        a, b = list(ttrain.tree_leaves(full[tree])), list(ttrain.tree_leaves(resumed[tree]))
        assert [p for p, _ in a] == [p for p, _ in b] and a
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b)), tree


def test_jax_saved_lora_train_state_loads(tmp_path):
    """The params of a JAX training-state file (adapters over an int8 base)
    load in the port leaf for leaf."""
    from moshi_tpu_torch.models import native_ckpt
    _, _, _, jlp = jax_lora_tree("int8")
    opt = jtrain.lora_optimizer(optax.adam(1e-3), jlp)
    jtrain.save_train_state(tmp_path / "j.safetensors", jlp, opt.init(jlp), 7)
    got = native_ckpt.load_params(tmp_path / "j.safetensors")
    assert int(got["meta"]["step"]) == 7
    want = from_jax(jax.device_get(jlp))
    a, b = list(ttrain.tree_leaves(got["params"])), list(ttrain.tree_leaves(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert {p: w.scaling for p, w in lora_paths(got["params"]).items()} == \
        {p: w.scaling for p, w in lora_paths(want).items()}


def test_run_training_overfits_tiny_lm():
    """run_training (cosine schedule with warmup, clipping, accumulation)
    overfits the tiny LM on a repeated batch, as the JAX package's own test
    asks of it (tests/test_train.py:222-244)."""
    cfg, _, _, _ = jax_lora_tree()
    losses = []

    def log(line):
        d = json.loads(line)
        if "loss" in d:
            losses.append(d["loss"])
    out = ttrain.run_training(_tiny_lm_train_cfg(
        cfg, log_every=10, optimizer={"lr": 3e-3, "schedule": "cosine", "warmup_steps": 5,
                                      "grad_clip": 1.0, "accum_steps": 2}), log=log)
    assert np.isfinite(losses).all() and len(losses) == 6
    assert out["loss"] < 0.35, losses
    assert out["loss"] < losses[0] * 0.1, losses


def test_lora_training_keeps_the_base():
    """LoRA training through make_train_step on a q4 base: the loss falls,
    the base and embeddings keep their bytes, the adapters move."""
    cfg, _, _, jlp = jax_lora_tree("int4")
    tlp = from_jax(jax.device_get(jlp))
    model = TLM(port_lm_config(cfg))
    opt = ttrain.lora_optimizer(ttrain.make_optimizer({"lr": 5e-3}), tlp)
    step = ttrain.make_train_step(model, opt)
    state = opt.init(tlp)
    codes = torch.from_numpy(codes_for(cfg, seed=6)).long()
    p, losses = tlp, []
    for _ in range(8):
        p, state, loss, _ = step(p, state, codes)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    for path, w in lora_paths(tlp).items():
        w1 = lora_paths(p)[path]
        assert w1.base is w.base and not torch.equal(w1.b, w.b), path
    assert p["emb"]["weight"] is tlp["emb"]["weight"]
    assert p["text_emb"]["weight"] is tlp["text_emb"]["weight"]


def test_cli_refusals(tmp_path):
    """fsdp without two dp ranks is refused as the JAX package's trainer
    refuses it; a dp >= 2 mesh outside a process group says how to launch
    one; lora_only over a tree without adapters trains nothing in the JAX
    package and is refused here (ROADMAP C.10)."""
    cfg, _, _, _ = jax_lora_tree()
    with pytest.raises(ValueError, match="fsdp requires mesh.dp >= 2"):
        ttrain.run_training(_tiny_lm_train_cfg(cfg, mesh={"dp": 1, "fsdp": True}, steps=1))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        ttrain.run_training(_tiny_lm_train_cfg(cfg, mesh={"dp": 2}, steps=1))
    with pytest.raises(ValueError, match="lora_only"):
        ttrain.run_training(_tiny_lm_train_cfg(cfg, lora_only=True, steps=1))
    # a native checkpoint whose tree holds adapters trains them alone
    from moshi_tpu_torch.models import native_ckpt
    _, _, _, jlp = jax_lora_tree("int8")
    ck = tmp_path / "lora_ckpt"
    ck.mkdir()
    lm_config = _tiny_lm_train_cfg(cfg)["lm_config"]
    (ck / "config.json").write_text(json.dumps({**lm_config, "native_format": True,
                                                "moshi_name": "m.safetensors"}))
    tlp = from_jax(jax.device_get(jlp))
    native_ckpt.save_params(ck / "m.safetensors", tlp)
    out = ttrain.run_training({**_tiny_lm_train_cfg(cfg, steps=2), "checkpoint_dir": str(ck),
                               "lora_only": True})
    for path, w in lora_paths(tlp).items():
        w1 = lora_paths(out["params"])[path]
        assert torch.equal(w1.base.q, w.base.q) and not torch.equal(w1.b, w.b)
