"""The port's LoRA (models/lora.py) against moshi_tpu's, and the gradient
of the quantized linears: the leaves replace_all_linear_with_lora wraps,
fresh adapters as the identity, fusing a tree and a PyTorch-named state
(the loader's LoRA half), native `__lora__` nodes both ways, the
FrozenLinear backward of the q4 and int8 linears, lora_optimizer's frozen
leaves, and LMGen's greedy tokens over adapters on an int8 base.  f32 on
the CPU, weights and adapters carried by from_jax."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models import lora as jlora
from moshi_tpu.models import native_ckpt as jn
from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.lm_gen import LMGen as JGen, LMGenConfig as JGenConfig
from moshi_tpu_torch.models import loaders as tl
from moshi_tpu_torch.models import lora as tlora
from moshi_tpu_torch.models import native_ckpt as tn
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.models.lm_gen import LMGen as TGen, LMGenConfig as TGenConfig
from moshi_tpu_torch import train as ttrain
from moshi_tpu_torch.ops import q4matmul, qmatmul
from moshi_tpu_torch.utils import safetensors as tst
from moshi_tpu_torch.utils.params import from_jax
from moshi_tpu_torch.utils.quantize import (QTensor, QTensor4, dequantize, dequantize4,
                                            quantize_lm_params, quantize_tensor,
                                            quantize_tensor4)
from test_lm import tiny_lm_config
from test_torch_port import max_abs, port_lm_config, to_np

LOGIT_TOL = 1e-4   # f32 logits, fused against unfused (JAX's own test: 2e-4)
FUSE_TOL = 1e-6    # f32 fused weights: one product and one add
BASES = (None, "int8", "int4")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: on models this small torch's thread pool costs
    more than it gives, and beside other test processes its spinning
    threads made a training loop ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg64():
    # dim 64: the temporal linears' din is a multiple of 2 * 32, so int4
    # mode gives them q4 (linear_out's din 176 stays int8, by the rule)
    return tiny_lm_config(dim=64, num_heads=4, depformer_dim=32)


def to_jax(tree):
    """A port tree as the JAX package's (the layouts are the same): a fast
    way to give both packages one set of weights, since the JAX package's
    init_params takes ~11 s to build the tiny LM on the CPU."""
    from moshi_tpu.utils.quantize import QTensor as JQ, QTensor4 as JQ4
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    if isinstance(tree, (QTensor, QTensor4)):
        return (JQ if isinstance(tree, QTensor) else JQ4)(to_jax(tree.q), to_jax(tree.scale))
    if isinstance(tree, tlora.LoRAWeight):
        return jlora.LoRAWeight(to_jax(tree.base), to_jax(tree.a), to_jax(tree.b), tree.scaling)
    return jnp.asarray(tree.detach().numpy())


@functools.lru_cache(maxsize=None)
def jax_lora_tree(base=None, rank=2, seed=1, b_scale=0.1):
    """The tiny LM (port-initialised, the port's quantizer for an int8 or
    q4 base) as a JAX tree with the JAX package's adapters, b drawn (a
    fresh b is zero) so every adapter acts; built once a file."""
    cfg = cfg64()
    params = TLM(port_lm_config(cfg)).init_params(torch.Generator().manual_seed(0),
                                                  dtype=torch.float32)
    if base:
        params = quantize_lm_params(params, min_size=1, mode=base)
    params = to_jax(params)
    lp = jlora.replace_all_linear_with_lora(params, rank=rank, key=jax.random.PRNGKey(seed),
                                            dtype=jnp.float32)
    rs = np.random.RandomState(seed)

    def draw(leaf):
        if isinstance(leaf, jlora.LoRAWeight) and b_scale:
            b = rs.randn(*leaf.b.shape).astype(np.float32) * b_scale
            return jlora.LoRAWeight(leaf.base, leaf.a, jnp.asarray(b), leaf.scaling)
        return leaf
    lp = jax.tree.map(draw, lp, is_leaf=lambda x: isinstance(x, jlora.LoRAWeight))
    return cfg, JLM(cfg), params, lp


def lora_paths(tree, path=()):
    """{path: LoRAWeight} of a tree (either package's)."""
    if isinstance(tree, dict):
        return {p: w for k, v in tree.items() for p, w in lora_paths(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: w for i, v in enumerate(tree) for p, w in lora_paths(v, path + (i,)).items()}
    return {path: tree} if type(tree).__name__ == "LoRAWeight" else {}


def kind(w) -> str:
    name = type(w).__name__
    return name if name.startswith("QTensor") else "dense"


def codes_for(cfg, T=8, seed=0):
    rs = np.random.RandomState(seed)
    codes = rs.randint(0, cfg.card, (2, cfg.num_codebooks, T)).astype(np.int32)
    codes[:, 0] = rs.randint(0, cfg.text_card, (2, T))
    return codes


@pytest.mark.parametrize("base", BASES)
def test_replace_all_linear_with_lora_matches_jax(base):
    """The same leaves wrapped, with the same shapes and base classes; a
    fresh adapter leaves the forward as it was."""
    cfg, jlm, params, jlp = jax_lora_tree(base)
    tparams = from_jax(jax.device_get(params))
    tlp = tlora.replace_all_linear_with_lora(tparams, rank=2,
                                             generator=torch.Generator().manual_seed(1),
                                             dtype=torch.float32)
    want, got = lora_paths(jlp), lora_paths(tlp)
    assert sorted(map(str, got)) == sorted(map(str, want)) and len(got) == 11
    for p, w in want.items():
        g = got[p]
        assert kind(g.base) == kind(w.base), p
        assert tuple(g.a.shape) == w.a.shape and tuple(g.b.shape) == w.b.shape, p
        assert g.scaling == w.scaling == 2.0 and not g.b.any()
    member = got[("transformer", "layers", "attn", "in_proj")].take([1])
    assert member.shape == (1,) + want[("transformer", "layers", "attn", "in_proj")].shape[1:]
    model = TLM(port_lm_config(cfg))
    codes = torch.from_numpy(codes_for(cfg)).long()
    with torch.no_grad():
        out, out_lora = model.forward(tparams, codes), model.forward(tlp, codes)
    m = out["text_mask"]
    assert torch.equal(out_lora["text_logits"][m], out["text_logits"][m])


@pytest.mark.parametrize("base", BASES)
def test_fuse_lora_params_matches_jax(base):
    """fuse_lora_params of carried adapters equals JAX's, and the fused
    tree's logits equal the unfused tree's."""
    cfg, jlm, _, jlp = jax_lora_tree(base)
    tlp = from_jax(jax.device_get(jlp))
    assert lora_paths(tlp)
    fused = tlora.fuse_lora_params(tlp)
    want = from_jax(jax.device_get(jlora.fuse_lora_params(jlp)))
    assert not lora_paths(fused)
    for p, w in lora_paths(jlp).items():
        node_t, node_j = fused, want
        for k in p:
            node_t, node_j = node_t[k], node_j[k]
        assert node_t.dtype == node_j.dtype, p
        assert max_abs(to_np(node_t), to_np(node_j)) <= FUSE_TOL * float(
            node_j.float().abs().max()), p
    model = TLM(port_lm_config(cfg))
    codes = torch.from_numpy(codes_for(cfg)).long()
    with torch.no_grad():
        out_f, out_u = model.forward(fused, codes), model.forward(tlp, codes)
    if base is None:  # a quantized base fuses into bf16 weights
        for k, m in (("text_logits", "text_mask"), ("logits", "mask")):
            ref = out_u[k][out_u[m]]
            assert max_abs(to_np(out_f[k][out_f[m]]), to_np(ref)) <= LOGIT_TOL * float(
                ref.abs().max()), k


def test_lora_state_fuses_at_load_like_jax(tmp_path):
    """A PyTorch-named LM state with a LoRA state beside it (split and fused
    legacy base names) loads through each package's get_moshi_lm with the
    adapters fused, at the config's lora_scaling; `lora: true` without
    weights is refused."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import export_torch
    cfg, jlm, params, _ = jax_lora_tree()
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             export_torch.lm_params_to_torch_state(jlm, params).items()}
    rs = np.random.RandomState(4)
    bases = [k[:-len(".weight")] for k in state if k.endswith("in_projs.0.weight")][:1]
    bases += [k[:-len(".weight")] for k in state if k.endswith("linear_out.weight")][:2]
    assert len(bases) == 3
    # a fused legacy name: the adapter of "...self_attn.in_proj" on in_proj_weight
    legacy = bases[0].replace("in_projs.0", "in_proj")
    state[legacy + "_weight"] = state.pop(bases[0] + ".weight")
    bases[0] = legacy
    lora = {}
    for b in bases:
        w = state.get(b + ".weight", state.get(b + "_weight"))
        lora[b + ".lora_A.weight"] = torch.from_numpy(rs.randn(3, w.shape[1]).astype(np.float32))
        lora[b + ".lora_B.weight"] = torch.from_numpy(rs.randn(w.shape[0], 3).astype(np.float32))
    fused_t = tlora.fuse_lora_state(state, lora, 1.5)
    fused_j = jlora.fuse_lora_state({k: jnp.asarray(v.numpy()) for k, v in state.items()},
                                    {k: jnp.asarray(v.numpy()) for k, v in lora.items()}, 1.5)
    for k in fused_j:
        assert max_abs(fused_t[k].numpy(), fused_j[k]) <= FUSE_TOL * float(
            np.abs(np.asarray(fused_j[k])).max()), k
    with pytest.raises(KeyError):
        tlora.fuse_lora_state(state, {"nowhere.lora_A.weight": lora[bases[1] + ".lora_A.weight"],
                                      "nowhere.lora_B.weight": lora[bases[1] + ".lora_B.weight"]})

    # through the port's loader: the state without the legacy rename, its
    # adapters fused at load, against the JAX package's fused state loaded
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             export_torch.lm_params_to_torch_state(jlm, params).items()}
    lora = {k.replace(legacy, bases[0].replace("in_proj", "in_projs.0")): v
            for k, v in lora.items()}
    fused = jlora.fuse_lora_state({k: jnp.asarray(v.numpy()) for k, v in state.items()},
                                  {k: jnp.asarray(v.numpy()) for k, v in lora.items()}, 1.5)
    tst.save_file(state, tmp_path / "model.safetensors")
    tst.save_file(lora, tmp_path / "lora.safetensors")
    tst.save_file({k: torch.from_numpy(np.array(v)) for k, v in fused.items()},
                  tmp_path / "fused.safetensors")
    d = {f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()}
    d = {k: list(v) if isinstance(v, tuple) else v for k, v in d.items() if k != "remat"}
    d.update(lora=True, lora_scaling=1.5)
    _, tp = tl.get_moshi_lm(tmp_path / "model.safetensors", dict(d), dtype=torch.float32,
                            device="cpu", lora_weights=tmp_path / "lora.safetensors")
    _, want = tl.get_moshi_lm(tmp_path / "fused.safetensors", {**d, "lora": False},
                              dtype=torch.float32, device="cpu")
    for (path, t), (_, w) in zip(ttrain.tree_leaves(tp), ttrain.tree_leaves(want)):
        assert max_abs(t.numpy(), w.numpy()) <= FUSE_TOL * float(w.abs().max()), path
    with pytest.raises(ValueError, match="lora=true"):
        tl.get_moshi_lm(tmp_path / "model.safetensors", dict(d), device="cpu")


def test_native_lora_trees_both_ways(tmp_path):
    """A LoRA tree over an int8 base: the port's file loads in JAX and
    JAX's in the port, leaf for leaf."""
    _, _, _, jlp = jax_lora_tree("int8")
    tlp = from_jax(jax.device_get(jlp))
    tn.save_params(tmp_path / "t.safetensors", tlp)
    jn.save_params(tmp_path / "j.safetensors", jlp)
    for got in (tn.load_params(tmp_path / "j.safetensors"),
                from_jax(jax.device_get(jn.load_params(tmp_path / "t.safetensors")))):
        paths = lora_paths(got)
        assert sorted(map(str, paths)) == sorted(map(str, lora_paths(tlp)))
        for p, w in paths.items():
            want = lora_paths(tlp)[p]
            assert type(w.base) is type(want.base) and w.scaling == want.scaling
            assert torch.equal(w.a, want.a) and torch.equal(w.b, want.b)
            assert torch.equal(w.base.q, want.base.q)


# -------------------------------------------------------- the backward
def _q4(rs, din, dout):
    return quantize_tensor4(torch.from_numpy(rs.randn(din, dout).astype(np.float32)))


def _int8(rs, din, dout):
    return quantize_tensor(torch.from_numpy(rs.randn(din, dout).astype(np.float32)))


@pytest.mark.parametrize("kind", ["q4", "int8"])
@pytest.mark.parametrize("rows", [3, 40])
def test_frozen_linear_backward(kind, rows):
    """Under autograd the quantized linear is a FrozenLinear: its output has
    a grad_fn, dX = dY @ W^T of the dequantized weight, and the weight gets
    no gradient; without grad it runs the plain route alone."""
    rs = np.random.RandomState(rows)
    din, dout = 64, 96
    qt = (_q4 if kind == "q4" else _int8)(rs, din, dout)
    linear = q4matmul.q4_linear if kind == "q4" else qmatmul.int8_linear
    w = (dequantize4 if kind == "q4" else dequantize)(qt.q, qt.scale, torch.float32)
    x = torch.from_numpy(rs.randn(2, rows, din).astype(np.float32)).requires_grad_(True)
    y = linear(x, qt.q, qt.scale)
    assert type(y.grad_fn).__name__ == "FrozenLinearBackward"
    torch.testing.assert_close(y, x @ w, rtol=1e-6, atol=1e-5)
    dy = torch.from_numpy(rs.randn(2, rows, dout).astype(np.float32))
    (dx,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(dx, torch.matmul(dy, w.transpose(0, 1)))
    assert qt.q.grad is None and qt.scale.grad is None
    with torch.no_grad():
        assert linear(x, qt.q, qt.scale).grad_fn is None
    assert linear(x.detach(), qt.q, qt.scale).grad_fn is None


def test_wdot_lora_gradient_reaches_adapters_only():
    """wdot of a LoRAWeight over a dense base: the base gets no gradient,
    a and b get those of scaling * (x @ a) @ b."""
    from moshi_tpu_torch.utils.matmul import wdot
    rs = np.random.RandomState(0)
    base = torch.from_numpy(rs.randn(8, 5).astype(np.float32)).requires_grad_(True)
    a = torch.from_numpy(rs.randn(8, 2).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rs.randn(2, 5).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rs.randn(3, 8).astype(np.float32))
    y = wdot(x, tlora.LoRAWeight(base, a, b, 2.0))
    torch.testing.assert_close(y, x @ base + 2.0 * (x @ a) @ b)
    ga, gb = torch.autograd.grad(y.sum(), (a, b), retain_graph=True)
    ones = torch.ones(3, 5)
    torch.testing.assert_close(ga, 2.0 * x.T @ (ones @ b.T))
    torch.testing.assert_close(gb, 2.0 * (x @ a).T @ ones)
    y.sum().backward()
    assert base.grad is None


def test_lora_optimizer_trains_adapters_only():
    """lora_optimizer over a LoRA tree with weight decay: the adapters get
    optax's multi_transform updates, every other leaf keeps its bytes."""
    import optax
    from moshi_tpu import train as jtrain
    _, _, _, jlp = jax_lora_tree("int8")
    tlp = from_jax(jax.device_get(jlp))
    ocfg = {"lr": 1e-2, "weight_decay": 0.1, "grad_clip": 0.5}
    jopt = jtrain.lora_optimizer(jtrain.make_optimizer(ocfg), jlp)
    topt = ttrain.lora_optimizer(ttrain.make_optimizer(ocfg), tlp)
    paths = topt.select(tlp)
    assert len(paths) == 2 * len(lora_paths(tlp))
    assert all(p[-1] in ("a", "b") for p in paths)
    rs = np.random.RandomState(3)
    js, ts = jopt.init(jlp), topt.init(tlp)
    jupdate = jax.jit(jopt.update)
    jp, tp = jlp, tlp
    for _ in range(3):
        jg = jax.tree.map(lambda x: jnp.asarray(rs.randn(*x.shape).astype(np.float32))
                          if jnp.issubdtype(x.dtype, jnp.floating) else jnp.zeros_like(x), jp)
        tg = from_jax(jax.device_get(jg))
        leaves = [ttrain._get(tp, p) for p in paths]
        upd, ts = topt.update([ttrain._get(tg, p) for p in paths], ts, leaves)
        tp = ttrain.apply_updates(tp, paths, leaves, upd)
        ju, js = jupdate(jg, js, jp)
        jp = optax.apply_updates(jp, ju)
    want = from_jax(jax.device_get(jp))
    for p, w in lora_paths(want).items():
        got = lora_paths(tp)[p]
        for name in ("a", "b"):
            g, r = getattr(got, name), getattr(w, name)
            assert max_abs(g.numpy(), r.numpy()) <= 1e-6 * float(r.abs().max()), (p, name)
        assert got.base.q is lora_paths(tlp)[p].base.q
    assert tp["emb"]["weight"] is tlp["emb"]["weight"]


def test_lmgen_over_lora_on_int8_base_matches_jax():
    """Greedy LMGen over adapters on an int8 base gives JAX's tokens."""
    cfg, jlm, _, jlp = jax_lora_tree("int8")
    tlp = from_jax(jax.device_get(jlp))
    jgen = JGen(jlm, JGenConfig(use_sampling=False))
    tgen = TGen(TLM(port_lm_config(cfg)), TGenConfig(use_sampling=False))
    jstate = jgen.init_state(2, jax.random.PRNGKey(0), dtype=jnp.float32)
    tstate = tgen.init_state(2, None, torch.float32)
    n_in = cfg.num_codebooks - cfg.dep_q - 1
    rs = np.random.RandomState(5)
    step = jax.jit(jgen.step)
    for t in range(cfg.max_delay + 6):
        toks = rs.randint(0, cfg.card, (2, n_in, 1))
        oj, jstate = step(jlp, jstate, jnp.asarray(toks, jnp.int32))
        with torch.no_grad():
            ot, tstate = tgen.step(tlp, tstate, torch.from_numpy(toks))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj), err_msg=f"frame {t}")
    assert (ot.numpy() >= 0).all()
