"""The port's checkpoint loading held against the JAX package's on the same
files: its safetensors reader and writer against the `safetensors`
package, native checkpoints both ways (f32, int8, int4, the legacy q4
packing, list and empty-node sentinels), PyTorch-named LM and Mimi
checkpoints (rust names, weight norm, old RVQ buffer names), gguf, the
config parsers, and the tiny checkpoint served by each package's
ServerState.  Trees must be equal leaf for leaf (class, dtype, bytes)
unless a test says otherwise."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import export_torch  # noqa: E402
import make_tiny_checkpoint  # noqa: E402
from moshi_tpu.models import loaders as jl  # noqa: E402
from moshi_tpu.models import native_ckpt as jn  # noqa: E402
from moshi_tpu.models.lm import LMModel as JLM  # noqa: E402
from moshi_tpu.serve.server import ServerState as JServerState  # noqa: E402
from moshi_tpu.utils.quantize import quantize_lm_params as jquantize  # noqa: E402
from moshi_tpu_torch.models import loaders as tl  # noqa: E402
from moshi_tpu_torch.models import native_ckpt as tn  # noqa: E402
from moshi_tpu_torch.models.lm import LMModel as TLM  # noqa: E402
from moshi_tpu_torch.models.mimi import MimiModel as TMimi  # noqa: E402
from moshi_tpu_torch.serve.server import ServerState as TServerState  # noqa: E402
from moshi_tpu_torch.utils import safetensors as tst  # noqa: E402
from moshi_tpu_torch.utils.params import from_jax  # noqa: E402
from moshi_tpu_torch.utils.quantize import (QTensor, QTensor4,  # noqa: E402
                                            quantize_lm_params)
from test_lm import tiny_lm_config  # noqa: E402
from test_torch_port import port_lm_config  # noqa: E402

FRAMES = 30


def assert_same_tree(got, want, path="", rtol=0.0):
    """Same structure, leaf classes and dtypes; equal bytes (rtol 0) or
    values within rtol of the largest magnitude of the leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got),
                                                                 sorted(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}", rtol)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}", rtol)
    elif isinstance(want, (QTensor, QTensor4)):
        assert type(got) is type(want), (path, type(got), type(want))
        assert_same_tree(got.q, want.q, path + "#q", rtol)
        assert_same_tree(got.scale, want.scale, path + "#scale", rtol)
    else:
        assert isinstance(got, torch.Tensor), (path, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, (
            path, got.dtype, want.dtype, tuple(got.shape), tuple(want.shape))
        if rtol:
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=rtol * float(want.float().abs().max()), msg=path)
        else:
            assert torch.equal(got, want), path


def host(tree):
    return jax.device_get(tree)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The JAX package's tiny native checkpoint (scripts/make_tiny_checkpoint)."""
    return make_tiny_checkpoint.make(tmp_path_factory.mktemp("tiny"))


def torch_layout_config(ckpt) -> dict:
    """The tiny checkpoint's config.json as a PyTorch-named checkpoint's."""
    cfg = json.loads((Path(ckpt) / "config.json").read_text())
    cfg.pop("native_format")
    return cfg


@pytest.fixture(scope="module")
def jax_models(ckpt):
    info = jl.CheckpointInfo.from_dir(ckpt)
    return info.get_mimi(), info.get_moshi()


# ------------------------------------------------------------- safetensors
SAMPLES = {
    "F32": lambda rs: torch.from_numpy(rs.randn(3, 5).astype(np.float32)),
    "F16": lambda rs: torch.from_numpy(rs.randn(4, 2).astype(np.float16)),
    "BF16": lambda rs: torch.from_numpy(rs.randn(7, 3).astype(np.float32)).to(torch.bfloat16),
    "I8": lambda rs: torch.from_numpy(rs.randint(-128, 128, (5, 6)).astype(np.int8)),
    "U8": lambda rs: torch.from_numpy(rs.randint(0, 256, (9,)).astype(np.uint8)),
    "I32": lambda rs: torch.from_numpy(rs.randint(-2**31, 2**31, (2, 2, 3)).astype(np.int32)),
    "I64": lambda rs: torch.from_numpy(rs.randint(-2**62, 2**62, (3,)).astype(np.int64)),
}


def _sample_tensors(dtype_name):
    """Tensors of one dtype, a scalar and an empty one among them, beside a
    1-byte tensor."""
    rs = np.random.RandomState(len(dtype_name))
    t = SAMPLES[dtype_name](rs)
    return {"a": t, "b/c": t.reshape(-1)[:1].reshape(()).clone(), "empty": t[:0].clone(),
            "odd": torch.tensor([7], dtype=torch.uint8)}


@pytest.mark.parametrize("dtype_name", sorted(SAMPLES))
def test_reader_reads_the_package_files(dtype_name, tmp_path):
    from safetensors.torch import save_file
    tensors = _sample_tensors(dtype_name)
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"k": "v"})
    got = tst.load_file(tmp_path / "x.safetensors")
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


@pytest.mark.parametrize("dtype_name", sorted(SAMPLES))
def test_package_reads_the_writers_files(dtype_name, tmp_path):
    from safetensors.torch import load_file
    tensors = _sample_tensors(dtype_name)
    n = tst.save_file(tensors, tmp_path / "x.safetensors", metadata={"k": "v"})
    assert n == (tmp_path / "x.safetensors").stat().st_size
    got = load_file(str(tmp_path / "x.safetensors"))
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


# ------------------------------------------------------------------ native
def test_tiny_checkpoint_loads_like_jax(ckpt, jax_models):
    """CheckpointInfo.from_dir in each package: the port's trees equal
    from_jax of the JAX package's, the Mimi conv relayout included."""
    (jmimi, jmimi_params), (jlm, jlm_params) = jax_models
    info = tl.CheckpointInfo.from_dir(ckpt)
    assert info.native_format and info.num_mimi_codebooks() == 2
    mimi, mimi_params = info.get_mimi(device="cpu")
    lm, lm_params = info.get_moshi(device="cpu")
    assert lm.config == port_lm_config(jlm.config)
    assert mimi.frame_size == jmimi.frame_size == 1920
    assert_same_tree(mimi_params, from_jax(host(jmimi_params), mimi_config=mimi.config))
    assert_same_tree(lm_params, from_jax(host(jlm_params)))
    assert info.tokenizer_path == Path(ckpt) / "tokenizer_spm_32k_3.model"


@pytest.fixture(scope="module")
def q_model():
    """A JAX LM wide enough for int4 (din a multiple of 64)."""
    cfg = tiny_lm_config(dim=64, num_heads=4, depformer_dim=32)
    return cfg, JLM(cfg).init_params(jax.random.PRNGKey(3), dtype=jnp.float32)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_jax_quantized_checkpoint_loads_in_the_port(mode, q_model, tmp_path):
    _, params = q_model
    qparams = jquantize(params, min_size=1, mode=mode)
    jn.save_params(tmp_path / "q.safetensors", qparams)
    got = tn.load_params(tmp_path / "q.safetensors", "cpu")
    want = from_jax(host(qparams))
    assert_same_tree(got, want)
    kinds = {type(w) for w in (got["transformer"]["layers"]["attn"]["in_proj"],
                               got["depformer"]["layers"]["attn"]["in_proj"])}
    assert kinds == ({QTensor4, QTensor} if mode == "int4" else {QTensor})


def test_port_checkpoint_loads_in_jax(q_model, ckpt, tmp_path):
    """A port-quantized q4 LM and a Mimi tree (empty nodes, lists) saved by
    the port load in the JAX package equal to the port's trees."""
    cfg, params = q_model
    tparams = quantize_lm_params(from_jax(host(params)), min_size=1, mode="int4")
    mimi, mimi_params = tl.CheckpointInfo.from_dir(ckpt).get_mimi(device="cpu")
    tn.save_params(tmp_path / "lm.safetensors", tparams)
    assert_same_tree(from_jax(host(jn.load_params(tmp_path / "lm.safetensors"))), tparams)
    assert_same_tree(tn.load_params(tmp_path / "lm.safetensors"), tparams)
    tn.save_mimi_params(tmp_path / "mimi.safetensors", mimi, mimi_params)
    back = jn.load_params(tmp_path / "mimi.safetensors")
    assert_same_tree(from_jax(host(back), mimi_config=mimi.config), mimi_params)
    assert_same_tree(tn.load_mimi_params(tmp_path / "mimi.safetensors", mimi), mimi_params)


def test_legacy_q4_and_sentinels(tmp_path):
    """A two-plane q4 leaf is repacked, `#len` and `#empty` rebuild lists
    and empty dicts, as in the JAX package."""
    from safetensors.numpy import save_file
    rs = np.random.RandomState(0)
    p, gs, dout = 2, 32, 8
    flat = {
        "w#q4": rs.randint(-128, 128, (p, gs, dout)).astype(np.int8),
        "w#scale4": rs.rand(2 * p * gs // 32, 1, dout).astype(np.float32),
        "a/b#len": np.asarray(3, np.int32),
        "a/b/0/x": rs.randn(4).astype(np.float32),
        "a/b/1#empty": np.asarray(0, np.int32),
        "a/b/2#len": np.asarray(0, np.int32),
        "c#empty": np.asarray(0, np.int32),
    }
    save_file(flat, str(tmp_path / "legacy.safetensors"))
    got = tn.load_params(tmp_path / "legacy.safetensors")
    assert_same_tree(got, from_jax(host(jn.load_params(tmp_path / "legacy.safetensors"))))
    assert isinstance(got["w"], QTensor4) and got["w"].shape == (2 * p * gs, dout)
    assert got["a"]["b"][1] == {} and got["a"]["b"][2] == [] and got["c"] == {}


def test_lora_node_raises(tmp_path):
    """A `__lora__` node without its b and scaling is refused by name; a
    whole one loads as the JAX package loads it."""
    from safetensors.numpy import save_file
    node = {"w/__lora__/a": np.ones((2, 3), np.float32),
            "w/__lora__/base#q": np.full((2, 2), 3, np.int8),
            "w/__lora__/base#scale": np.full((1, 2), 0.5, np.float32)}
    save_file(node, str(tmp_path / "lora.safetensors"))
    with pytest.raises(ValueError, match="__lora__"):
        tn.load_params(tmp_path / "lora.safetensors")
    node.update({"w/__lora__/b": np.full((3, 2), 0.25, np.float32),
                 "w/__lora__/scaling": np.asarray(2.0, np.float32)})
    save_file(node, str(tmp_path / "lora.safetensors"))
    got = tn.load_params(tmp_path / "lora.safetensors")["w"]
    want = host(jn.load_params(tmp_path / "lora.safetensors"))["w"]
    assert isinstance(got.base, QTensor) and got.scaling == want.scaling == 2.0
    assert_same_tree({"base": got.base, "a": got.a, "b": got.b},
                     from_jax({"base": want.base, "a": want.a, "b": want.b}))


# ------------------------------------------------------------ torch layout
def _torch_state(jlm, jlm_params, dtype):
    state = export_torch.lm_params_to_torch_state(jlm, jlm_params)
    return {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in state.items()}


def _rust_names(state, cfg):
    """The rust ecosystem's per-slice layout of a PyTorch-named LM state
    (the inverse of loaders.rust_state_to_torch)."""
    out = {k: v for k, v in state.items()
           if not k.startswith(("depformer", "linears."))}
    for i in range(cfg.dep_q):
        s = f"depformer.{i}."
        out[s + "linear_in.weight"] = state[f"depformer_in.{i}.weight"]
        out[s + "linear_out.weight"] = state[f"linears.{i}.weight"]
        out[s + "emb.weight"] = state["depformer_text_emb.weight" if i == 0
                                     else f"depformer_emb.{i - 1}.weight"]
        for l in range(cfg.depformer_num_layers):
            src, dst = f"depformer.layers.{l}.", f"{s}transformer.layers.{l}."
            out[dst + "self_attn.in_proj_weight"] = state[src + f"self_attn.in_projs.{i}.weight"]
            out[dst + "self_attn.out_proj.weight"] = state[src + f"self_attn.out_projs.{i}.weight"]
            for which in ("linear_in", "linear_out"):
                out[dst + f"gating.{which}.weight"] = state[src + f"gating.{i}.{which}.weight"]
            for nrm in ("norm1", "norm2"):
                out[dst + f"{nrm}.alpha"] = state[src + f"{nrm}.alpha"]
    return out


@pytest.mark.parametrize("names", ["torch", "rust"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_layout_lm(names, dtype, jax_models, ckpt, tmp_path):
    """export_torch's PyTorch-named LM (and its rust-named form) through
    each package's get_moshi_lm: equal trees, in f32 and cast to bf16."""
    _, (jlm, jlm_params) = jax_models
    state = _torch_state(jlm, jlm_params, torch.float32)
    if names == "rust":
        state = _rust_names(state, jlm.config)
    path = tmp_path / "model.safetensors"
    tst.save_file(state, path)
    cfg = torch_layout_config(ckpt)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, jparams = jl.get_moshi_lm(path, dict(cfg), dtype=jdtype)
    lm, tparams = tl.get_moshi_lm(path, dict(cfg), dtype=dtype, device="cpu")
    assert lm.config == port_lm_config(jlm.config)
    assert_same_tree(tparams, from_jax(host(jparams)))
    if dtype == torch.float32:
        assert_same_tree(tparams, from_jax(host(jlm_params)))


def _conv_to_torch(w):
    """[K, Cin/g, Cout] -> [Cout, Cin/g, K]."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 1, 0)))


def _convtr_to_torch(w, groups):
    """[K, Cin/g, g * Cout/g] -> [Cin, Cout/g, K]."""
    w = np.asarray(w)
    K, cin_g, cout = w.shape
    w = w.reshape(K, cin_g, groups, cout // groups).transpose(2, 1, 3, 0)
    return np.ascontiguousarray(w.reshape(groups * cin_g, cout // groups, K))


def mimi_torch_state(model, params, weight_norm=None, rvq=("embedding", None)):
    """A PyTorch-named Mimi state from a JAX Mimi tree, by the documented
    conventions (moshi_tpu/models/loaders.py:10-16): weights plain or as
    weight norm (`g_v`: weight_g / weight_v; `param`: parametrizations'
    original0 / original1), codebooks under the `rvq` (sum, usage) buffer
    names (usage None: the plain `embedding`)."""
    rs = np.random.RandomState(0)
    state = {}

    def weight(key, w):
        if weight_norm is None:
            state[key] = w
            return
        g = np.sqrt(np.sum(np.square(w), axis=tuple(range(1, w.ndim)), keepdims=True))
        if weight_norm == "g_v":
            state[key + "_g"], state[key + "_v"] = g, w
        else:
            head, tail = key.rsplit(".", 1)
            state[f"{head}.parametrizations.{tail}.original0"] = g
            state[f"{head}.parametrizations.{tail}.original1"] = w

    def conv(prefix, p, groups=None):
        weight(prefix + ".weight", _conv_to_torch(p["weight"]) if groups is None
               else _convtr_to_torch(p["weight"], groups))
        if "bias" in p:
            state[prefix + ".bias"] = np.asarray(p["bias"])

    for name, net in (("encoder", model.encoder), ("decoder", model.decoder)):
        for (kind, mod, _), ti, p in zip(net.items, net.torch_indices, params[name]["model"]):
            base = f"{name}.model.{ti}"
            if kind == "conv":
                conv(f"{base}.conv.conv", p)
            elif kind == "convtr":
                conv(f"{base}.convtr.convtr", p, mod.groups)
            else:
                for j, cp in enumerate(p["block"]):
                    conv(f"{base}.block.{2 * j + 1}.conv.conv", cp)
    for name in ("encoder_transformer", "decoder_transformer"):
        export_torch.transformer_layers_to_torch(state, f"{name}.transformer",
                                                 params[name]["layers"],
                                                 model.config.transformer)
    conv("downsample.conv.conv", params["downsample"])
    conv("upsample.convtr.convtr", params["upsample"], model.upsample.convtr.groups)
    sum_name, usage_name = rvq
    for name in ("rvq_first", "rvq_rest"):
        p = params["quantizer"][name]
        for i, e in enumerate(np.asarray(p["embedding"])):
            cb = f"quantizer.{name}.vq.layers.{i}._codebook"
            if usage_name is None:
                state[f"{cb}.{sum_name}"] = e
            else:
                usage = rs.uniform(0.5, 2.0, e.shape[0]).astype(np.float32)
                state[f"{cb}.{sum_name}"] = e * usage[:, None]
                state[f"{cb}.{usage_name}"] = usage
        for proj in ("input_proj", "output_proj"):
            state[f"quantizer.{name}.{proj}.weight"] = np.ascontiguousarray(
                np.asarray(p[proj]).T[:, :, None])
    return {k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in state.items()}


MIMI_VARIANTS = {
    "plain": (None, ("embedding", None)),
    "weight_g": ("g_v", ("embedding_sum", "cluster_usage")),
    "parametrizations": ("param", ("embed_sum", "cluster_usage")),
    "old_rvq": (None, ("embed_avg", "cluster_size")),
}


@pytest.mark.parametrize("variant", sorted(MIMI_VARIANTS))
def test_torch_layout_mimi(variant, jax_models, ckpt, tmp_path):
    """A PyTorch-named Mimi (built here, checked by the JAX loader giving
    back the original tree) through each package's get_mimi.  The port
    folds weight norm in f32 in PyTorch, the JAX package in XLA: those
    weights agree within 1e-6 of their largest magnitude; everything else is
    byte-equal."""
    from safetensors.numpy import save_file
    (jmimi, jparams), _ = jax_models
    weight_norm, rvq = MIMI_VARIANTS[variant]
    save_file(mimi_torch_state(jmimi, host(jparams), weight_norm, rvq),
              str(tmp_path / "mimi.safetensors"))
    mcfg = json.loads((Path(ckpt) / "mimi_config.json").read_text())
    _, jback = jl.get_mimi(tmp_path / "mimi.safetensors", mcfg, 2)
    exact = variant == "plain"
    jtree = from_jax(host(jback))
    assert_same_tree(jtree, from_jax(host(jparams)), rtol=0 if exact else 1e-6)
    mimi, tparams = tl.get_mimi(tmp_path / "mimi.safetensors", mcfg, 2, device="cpu")
    want = from_jax(host(jback), mimi_config=mimi.config)
    if weight_norm is None:
        assert_same_tree(tparams, want)
    else:
        assert_same_tree(tparams["quantizer"], want["quantizer"])
        assert_same_tree(tparams, want, rtol=1e-6)


def test_gguf_weights_load_alike(ckpt, tmp_path, monkeypatch):
    """scripts/export_gguf.py's q8_0 file: both packages' load_weights give
    the same arrays, and their get_moshi_lm the same trees."""
    import export_gguf
    out = tmp_path / "model.gguf"
    monkeypatch.setattr(sys, "argv", ["export_gguf.py", str(ckpt), str(out)])
    export_gguf.main()
    jw, tw = jl.load_weights(out), tl.load_weights(out)
    assert set(jw) == set(tw)
    for k in jw:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]), err_msg=k)
    cfg = torch_layout_config(ckpt)
    _, jparams = jl.get_moshi_lm(out, dict(cfg), dtype=jnp.float32)
    _, tparams = tl.get_moshi_lm(out, dict(cfg), dtype=torch.float32, device="cpu")
    assert_same_tree(tparams, from_jax(host(jparams)))


# ----------------------------------------------------------------- configs
def _same_fields(tcfg, jcfg):
    for name in tcfg.__dataclass_fields__:
        tv, jv = getattr(tcfg, name), getattr(jcfg, name)
        if hasattr(tv, "__dataclass_fields__"):
            _same_fields(tv, jv)
        else:
            assert tv == jv, name


@pytest.mark.parametrize("preset", sorted(jl.LM_PRESETS))
def test_presets_match(preset):
    assert set(tl.LM_PRESETS) == set(jl.LM_PRESETS)
    _same_fields(tl.LM_PRESETS[preset](), jl.LM_PRESETS[preset]())
    info = tl.CheckpointInfo({"preset": preset})
    assert info.num_mimi_codebooks() == jl.CheckpointInfo({"preset": preset}).num_mimi_codebooks()


def test_config_parsers_match(ckpt, monkeypatch):
    cfg = torch_layout_config(ckpt)
    _same_fields(TLM(tl._lm_config(cfg)).config, jl.LmConfig.from_dict(cfg))
    mcfg = json.loads((Path(ckpt) / "mimi_config.json").read_text())
    acausal = {**mcfg, "seanet": {**mcfg["seanet"], "pad_mode": "replicate"},
               "transformer": {**mcfg["transformer"], "causal": False}}
    for d in (mcfg, None, acausal):
        _same_fields(tl.mimi_config_from_dict(d, 3), jl.mimi_config_from_dict(d, 3))
    sched = {**cfg, "depformer_weights_per_step_schedule": [0, 0]}
    _same_fields(TLM(tl._lm_config(sched)).config, jl.LmConfig.from_dict(sched))
    acausal_lm = {**cfg, "causal": False}
    _same_fields(TLM(tl._lm_config(acausal_lm)).config, jl.LmConfig.from_dict(acausal_lm))
    assert tl.LmConfig.from_dict({**cfg, "remat": True}).remat
    # hub names resolve through each package's download (stubbed here)
    for mod in (tl, jl):
        monkeypatch.setattr(mod, "_hf_hub_download",
                            lambda repo, name, revision=None: f"/hub/{repo}/{name}")
    for args in (("hf://kyutai/moshiko/model.safetensors",),
                 ("model.safetensors", "kyutai/moshiko-pytorch-bf16")):
        assert tl.hf_get(*args) == jl.hf_get(*args) == Path(
            "/hub/kyutai/moshiko" + ("" if len(args) == 1 else "-pytorch-bf16")
            + "/model.safetensors")
    info = tl.CheckpointInfo.from_dir(ckpt, tokenizer="file:///elsewhere/t.model")
    assert info.tokenizer_path == Path("/elsewhere/t.model")
    assert info._path("moshi", info.moshi_name) == Path(ckpt) / "model.native.safetensors"
    with pytest.raises(NotImplementedError):
        tl.CheckpointInfo({"lora_name": "lora.safetensors", "native_format": True},
                          root=Path(ckpt)).get_moshi()


@pytest.mark.parametrize("vocab", [64, 32000])
def test_spm_model_bytes_match_the_script(vocab):
    """The port's synthetic tokenizer is the JAX script's, byte for byte."""
    from moshi_tpu_torch.text.spm import spm_model_bytes
    assert spm_model_bytes(vocab) == make_tiny_checkpoint.spm_model_bytes(vocab)


# ------------------------------------------------------------------ parity
def test_tiny_checkpoint_serves_like_jax(ckpt, jax_models):
    """The parity bar: the tiny checkpoint loaded by each package in f32,
    greedy, 30 frames of seeded PCM through each ServerState: identical
    text tokens and Mimi codes, PCM within 1e-4 norm-relative.  The tiny
    Mimi runs 80 transformer steps a frame over a context of 25, and both
    packages decode NaN for most samples (ROADMAP C): the NaN samples must
    be the same ones, the rest within the bound."""
    (jmimi, jmimi_params), (jlm, jlm_params) = jax_models
    jstate = JServerState(jl.CheckpointInfo.from_dir(ckpt), jmimi, jmimi_params, jlm,
                          jlm_params, None, use_sampling=False)
    info = tl.CheckpointInfo.from_dir(ckpt)
    mimi, mimi_params = info.get_mimi(device="cpu")
    lm, lm_params = info.get_moshi(device="cpu")
    tstate = TServerState(mimi, mimi_params, lm, lm_params, info=info, device="cpu",
                          use_sampling=False)
    jstate.warmup()
    tstate.warmup()
    pcm = (0.3 * np.random.RandomState(7).randn(FRAMES, mimi.frame_size)).astype(np.float32)
    jout, tout = [], []
    for chunk in pcm:
        jpcm, jtok, _ = jstate.step_frame(chunk)
        tpcm, ttok = tstate.step_frame(chunk)
        assert ttok == jtok
        assert (jpcm is None) == (tpcm is None)
        if jpcm is not None:
            jout.append(jpcm)
            tout.append(tpcm)
    assert len(tout) == FRAMES - lm.config.max_delay
    np.testing.assert_array_equal(np.stack(tstate.session_tokens),
                                  np.stack(jstate.session_tokens))
    j, t = np.concatenate(jout), np.concatenate(tout)
    nan = np.isnan(j)
    np.testing.assert_array_equal(np.isnan(t), nan)
    assert np.linalg.norm(t[~nan] - j[~nan]) <= 1e-4 * np.linalg.norm(j[~nan])
