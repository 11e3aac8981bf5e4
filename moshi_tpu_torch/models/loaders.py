"""Checkpoint loading (counterpart of moshi_tpu/models/loaders.py): the
reference's PyTorch-named safetensors (or gguf) and the JAX package's
native layout -> the port's param trees, and `CheckpointInfo`, which reads
a checkpoint directory's `config.json`.

Conversion conventions (torch -> the port), as in the JAX package except
for the convolutions, which the port keeps in PyTorch's own layout for
F.conv1d / F.conv_transpose1d (utils/params.py):
- Conv1d [Cout, Cin/g, K] and ConvTranspose1d [Cin, Cout/g, K] as they are,
  weight norm folded (`weight_g` / `weight_v`, or the parametrizations'
  `original0` / `original1`);
- Linear [out, in] -> [in, out];
- per-step module lists -> stacked on a leading [W, ...] axis, a fused
  `in_proj_weight` split into W steps;
- per-layer modules -> stacked on a leading [L, ...] axis;
- RVQ codebook = embedding_sum / clamp(cluster_usage, 1e-5), the older
  buffer names included.

Trees are built on the host from the mapped file (utils/safetensors.py),
then every leaf is made contiguous on the device asked for.  LoRA weights
(`lora_weights`, a config's `lora_name`, `lora: true` with `lora_scaling`)
are fused into a PyTorch-named state at load (models/lora.fuse_lora_state),
as in the JAX package; a native checkpoint keeps its adapters in its own
tree (`__lora__` nodes), and a `lora_name` beside one is refused (the JAX
package ignores it).

Files come from a local directory or from the Hugging Face hub (`hf_get`,
`CheckpointInfo.from_hf_repo`): `hf://org/repo/path` names a file of
another repository, and a bare name inside a repository downloads into
the hub's local cache (`huggingface_hub`, imported only then).
"""

import json
import re
import warnings
from pathlib import Path

import numpy as np
import torch

from . import lm as lm_mod
from .lm import LMModel, LmConfig
from .lora import fuse_lora_state
from .mimi import MimiConfig, MimiModel
from .native_ckpt import load_mimi_params, load_params
from ..modules.seanet import SEANetConfig
from ..modules.transformer import TransformerConfig
from ..quantization.vq import RVQConfig
from ..utils.quantize import QTensor, QTensor4
from ..utils.safetensors import load_file

# --------------------------------------------------------------------- utils
def load_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """Name-keyed host tensors from safetensors or gguf (q8_0, f16 and bf16
    gguf tensors come dequantized to f32, models/gguf.py)."""
    path = Path(path)
    if path.suffix == ".gguf":
        from .gguf import read_gguf
        _, tensors = read_gguf(path)
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tensors.items()}
    return load_file(path)


def _fold_weight_norm(state: dict, key: str) -> torch.Tensor:
    """The weight at `key`, its weight-norm parametrization folded in f32."""
    g, v = key + "_g", key + "_v"
    if g not in state:
        head, tail = key.rsplit(".", 1)
        g = f"{head}.parametrizations.{tail}.original0"
        v = f"{head}.parametrizations.{tail}.original1"
        if g not in state:
            return state[key]
    wv = state[v]
    w32 = wv.float()
    norm = torch.sqrt(torch.sum(torch.square(w32), dim=tuple(range(1, wv.ndim)),
                                keepdim=True))
    return (state[g].float() * w32 / norm).to(wv.dtype)


def _lin(state: dict, key: str) -> torch.Tensor:
    return state[key].t()


def _conv_params(state: dict, prefix: str) -> dict:
    """A Conv1d's or ConvTranspose1d's weight (in PyTorch's layout, which
    the port keeps) and bias."""
    p = {"weight": _fold_weight_norm(state, prefix + ".weight")}
    if prefix + ".bias" in state:
        p["bias"] = state[prefix + ".bias"]
    return p


def _norm_params(state: dict, prefix: str, norm: str) -> dict:
    if norm.startswith("rms_norm"):
        return {"scale": state[prefix + ".alpha"].reshape(-1)}
    p = {"scale": state[prefix + ".weight"]}
    if prefix + ".bias" in state:
        p["bias"] = state[prefix + ".bias"]
    return p


def _stack(trees: list):
    """Stack identically structured trees on a new leading axis."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _stack([tr[k] for tr in trees]) for k in t}
    return torch.stack(trees)


def _to_device(tree, device):
    """Every tensor leaf contiguous on `device`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, (QTensor, QTensor4)):
        return type(tree)(_to_device(tree.q, device), _to_device(tree.scale, device))
    return tree.to(device).contiguous()


# -------------------------------------------------------------- transformer
def _attn_proj(state: dict, prefix: str, name: str, W: int) -> torch.Tensor:
    """Per-step attention projections [W, in, out], from the split
    `in_projs.{i}.weight` layout or the fused `in_proj_weight`."""
    fused_names = {"in_projs": ["in_proj_weight", "in_proj.weight"],
                   "out_projs": ["out_proj.weight"]}
    for fn in fused_names[name]:
        k = f"{prefix}.{fn}"
        if k in state:
            w = state[k]  # [W * out, in]
            return w.reshape(W, w.shape[0] // W, w.shape[1]).transpose(1, 2)
    return torch.stack([state[f"{prefix}.{name}.{i}.weight"].t() for i in range(W)])


def _out_proj_w(state: dict, prefix: str) -> torch.Tensor:
    for name in ("out_projs.0.weight", "out_proj.weight"):
        k = f"{prefix}.{name}"
        if k in state:
            return state[k].t()
    raise KeyError(f"no cross-attention out_proj under {prefix}")


def _cross_attn_proj_params(state: dict, prefix: str, cfg: TransformerConfig) -> dict:
    """Cross-attention projections from the fused [3d, d] weight or the
    separate `in_proj_weight_q` / `in_proj_weight_kv`."""
    d = cfg.d_model
    for name in ("in_projs.0.weight", "in_proj.weight", "in_proj_weight"):
        k = f"{prefix}.{name}"
        if k in state:
            w = state[k]
            return {"q_proj": w[:d].t(), "kv_proj": w[d:].t(),
                    "out_proj": _out_proj_w(state, prefix)}
    return {"q_proj": state[f"{prefix}.in_proj_weight_q"].t(),
            "kv_proj": state[f"{prefix}.in_proj_weight_kv"].t(),
            "out_proj": _out_proj_w(state, prefix)}


def _cross_attn_gate_params(state: dict, prefix: str, cfg: TransformerConfig) -> dict | None:
    g = cfg.cross_attention_gating
    if g == "normal":
        return None
    if g.startswith("constant_gated"):
        return {"alpha": state[f"{prefix}.gate.alpha"]}
    p = {"in_proj": _lin(state, f"{prefix}.gate.alpha.0.weight"),
         "out_proj": _lin(state, f"{prefix}.gate.alpha.2.weight")}
    if f"{prefix}.gate.alpha.2.bias" in state:
        p["bias"] = state[f"{prefix}.gate.alpha.2.bias"]
    return p


def transformer_layers_from_torch(state: dict, prefix: str, cfg: TransformerConfig) -> dict:
    """`<prefix>.layers.{l}.*` -> the stacked [L, ...] tree."""
    layers = []
    W = cfg.num_weights
    for l in range(cfg.num_layers):
        lp = f"{prefix}.layers.{l}" if prefix else f"layers.{l}"
        p = {
            "attn": {"in_proj": _attn_proj(state, f"{lp}.self_attn", "in_projs", W),
                     "out_proj": _attn_proj(state, f"{lp}.self_attn", "out_projs", W)},
            "norm1": _norm_params(state, f"{lp}.norm1", cfg.norm),
            "norm2": _norm_params(state, f"{lp}.norm2", cfg.norm),
        }
        if cfg.gating == "none":
            p["mlp"] = {"linear1": _lin(state, f"{lp}.linear1.weight"),
                        "linear2": _lin(state, f"{lp}.linear2.weight")}
        elif W == 1 and f"{lp}.gating.linear_in.weight" in state:
            p["mlp"] = {"linear_in": _lin(state, f"{lp}.gating.linear_in.weight")[None],
                        "linear_out": _lin(state, f"{lp}.gating.linear_out.weight")[None]}
        else:
            p["mlp"] = {which: torch.stack([_lin(state, f"{lp}.gating.{s}.{which}.weight")
                                            for s in range(W)])
                        for which in ("linear_in", "linear_out")}
        if cfg.layer_scale is not None:
            p["layer_scale_1"] = {"scale": state[f"{lp}.layer_scale_1.scale"]}
            p["layer_scale_2"] = {"scale": state[f"{lp}.layer_scale_2.scale"]}
        if cfg.cross_attention:
            if not cfg.shared_cross_attn:
                p["cross_attn"] = _cross_attn_proj_params(state, f"{lp}.cross_attention", cfg)
            gate = _cross_attn_gate_params(state, f"{lp}.cross_attention", cfg)
            if gate is not None:
                p["cross_attn_gate"] = gate
            p["norm_cross"] = _norm_params(state, f"{lp}.norm_cross",
                                           cfg.cross_attention_norm)
            if cfg.layer_scale is not None:
                p["layer_scale_cross"] = {"scale": state[f"{lp}.layer_scale_cross.scale"]}
        layers.append(p)
    return _stack(layers)


def _projected_transformer_from_torch(state: dict, prefix: str, model) -> dict:
    """Mimi's encoder / decoder transformer (a ProjectedTransformer): the
    layers, `input_proj` where the file has one, and an `output_projs`
    entry per output, empty (the identity) where the file has none."""
    p = {"layers": transformer_layers_from_torch(state, f"{prefix}.transformer",
                                                 model.config)}
    if f"{prefix}.input_proj.weight" in state:
        p["input_proj"] = {"weight": _lin(state, f"{prefix}.input_proj.weight")}
    keys = [f"{prefix}.output_projs.{i}.weight" for i in range(len(model.output_dimensions))]
    p["output_projs"] = [{"weight": _lin(state, k)} if k in state else {} for k in keys]
    return p


# --------------------------------------------------------------------- seanet
def _resblock_params(state: dict, prefix: str, block) -> dict:
    p = {"block": [_conv_params(state, f"{prefix}.block.{2 * j + 1}.conv.conv")
                   for j in range(len(block.convs))]}
    if block.shortcut is not None:
        p["shortcut"] = _conv_params(state, f"{prefix}.shortcut.conv.conv")
    return p


def seanet_from_torch(state: dict, prefix: str, net) -> dict:
    out = []
    for (kind, mod, _), ti in zip(net.items, net.torch_indices):
        base = f"{prefix}.model.{ti}"
        if kind == "conv":
            out.append(_conv_params(state, f"{base}.conv.conv"))
        elif kind == "convtr":
            out.append(_conv_params(state, f"{base}.convtr.convtr"))
        else:
            out.append(_resblock_params(state, base, mod))
    return {"model": out}


# ------------------------------------------------------------------------ RVQ
def _rvq_params(state: dict, prefix: str, n_q: int, eps: float = 1e-5) -> dict:
    embs = []
    for i in range(n_q):
        cb = f"{prefix}.vq.layers.{i}._codebook"
        for sum_name, usage_name in (("embedding_sum", "cluster_usage"),
                                     ("embed_sum", "cluster_usage"),
                                     ("embed_avg", "cluster_size")):
            if f"{cb}.{sum_name}" in state:
                s = state[f"{cb}.{sum_name}"].float()
                u = state[f"{cb}.{usage_name}"].float()
                embs.append(s / torch.clamp(u, min=eps)[:, None])
                break
        else:
            if f"{cb}.embedding" not in state:
                raise KeyError(f"no codebook buffers under {cb}")
            embs.append(state[f"{cb}.embedding"].float())
    p = {"embedding": torch.stack(embs)}
    for name in ("input_proj", "output_proj"):
        if f"{prefix}.{name}.weight" in state:
            p[name] = state[f"{prefix}.{name}.weight"][:, :, 0].t()
    return p


# ----------------------------------------------------------------------- Mimi
def mimi_params_from_torch_state(model: MimiModel, state: dict) -> dict:
    q = model.quantizer
    down = ("downsample.conv.conv.conv" if "downsample.conv.conv.conv.weight" in state
            else "downsample.conv.conv")
    up = ("upsample.convtr.convtr.convtr" if "upsample.convtr.convtr.convtr.weight" in state
          else "upsample.convtr.convtr")
    return {
        "encoder": seanet_from_torch(state, "encoder", model.encoder),
        "decoder": seanet_from_torch(state, "decoder", model.decoder),
        "encoder_transformer": _projected_transformer_from_torch(
            state, "encoder_transformer", model.encoder_transformer),
        "decoder_transformer": _projected_transformer_from_torch(
            state, "decoder_transformer", model.decoder_transformer),
        "downsample": _conv_params(state, down),
        "upsample": _conv_params(state, up),
        "quantizer": {
            "rvq_first": _rvq_params(state, "quantizer.rvq_first", q.rvq_first.config.n_q),
            "rvq_rest": _rvq_params(state, "quantizer.rvq_rest", q.rvq_rest.config.n_q),
        },
    }


def mimi_config_from_dict(d: dict | None, num_codebooks: int = 8) -> MimiConfig:
    """A MimiConfig from the reference `mimi_config` schema, the v0.1
    hyperparameters by default."""
    if d is None:
        return MimiConfig(num_codebooks=num_codebooks)
    sn = d.get("seanet", {})
    tr = d.get("transformer", {})
    qt = d.get("quantizer", {})
    seanet = SEANetConfig(
        channels=sn.get("channels", 1), dimension=sn.get("dimension", 512),
        n_filters=sn.get("n_filters", 64), n_residual_layers=sn.get("n_residual_layers", 1),
        ratios=tuple(sn.get("ratios", (8, 6, 5, 4))), kernel_size=sn.get("kernel_size", 7),
        residual_kernel_size=sn.get("residual_kernel_size", 3),
        last_kernel_size=sn.get("last_kernel_size", 3),
        dilation_base=sn.get("dilation_base", 2), compress=sn.get("compress", 2),
        pad_mode=sn.get("pad_mode", "constant"))
    transformer = TransformerConfig(
        d_model=tr.get("d_model", 512), num_heads=tr.get("num_heads", 8),
        num_layers=tr.get("num_layers", 8), dim_feedforward=tr.get("dim_feedforward", 2048),
        causal=tr.get("causal", True), context=tr.get("context", 250),
        positional_embedding=tr.get("positional_embedding", "rope"),
        max_period=tr.get("max_period", 10_000.0), gating=tr.get("gating", "none"),
        norm=tr.get("norm", "layer_norm"), layer_scale=tr.get("layer_scale", 0.01))
    quant = RVQConfig(dimension=qt.get("dimension", 256),
                      input_dimension=qt.get("input_dimension", seanet.dimension),
                      output_dimension=qt.get("output_dimension", seanet.dimension),
                      n_q=qt.get("n_q", 32), bins=qt.get("bins", 2048))
    return MimiConfig(sample_rate=d.get("sample_rate", 24_000), channels=d.get("channels", 1),
                      frame_rate=d.get("frame_rate", 12.5), seanet=seanet,
                      transformer=transformer, quantizer=quant, num_codebooks=num_codebooks)


def get_mimi(weights_path: str | Path, mimi_config: dict | None = None,
             num_codebooks: int = 8, device="cuda") -> tuple[MimiModel, dict]:
    """Mimi from a PyTorch-named checkpoint, its params on `device`."""
    model = MimiModel(mimi_config_from_dict(mimi_config, num_codebooks))
    params = mimi_params_from_torch_state(model, load_weights(weights_path))
    return model, _to_device(params, device)


# ------------------------------------------------------------------------- LM
def _emb_params(state: dict, prefix: str) -> dict:
    p = {"weight": state[f"{prefix}.weight"]}
    if f"{prefix}.low_rank.weight" in state:
        p["low_rank"] = _lin(state, f"{prefix}.low_rank.weight")
    if f"{prefix}.out1.weight" in state:
        p["out1"] = _lin(state, f"{prefix}.out1.weight")
        p["out2"] = _lin(state, f"{prefix}.out2.weight")
    return p


def rust_state_to_torch(state: dict, schedule=None) -> dict:
    """The rust ecosystem's per-slice names (`depformer.{i}.*`, one full
    weight set per depformer slice) -> the fused PyTorch layout that
    `lm_params_from_torch_state` reads.  With a weights-per-step `schedule`
    the first slice of each scheduled weight set is taken."""
    out, per_slice, slices = {}, {}, set()
    for k, v in state.items():
        m = re.match(r"depformer\.(\d+)\.(.+)$", k)
        if not m:
            out[k] = v
            continue
        i, rest = int(m.group(1)), m.group(2)
        slices.add(i)
        per_slice[(i, rest)] = v
    if not slices:
        return out
    S = max(slices) + 1
    reps = ([schedule.index(step) for step in range(max(schedule) + 1)]
            if schedule is not None else list(range(S)))
    for w, r in enumerate(reps):
        out[f"depformer_in.{w}.weight"] = per_slice[(r, "linear_in.weight")]
    for i in range(S):
        out[f"linears.{i}.weight"] = per_slice[(i, "linear_out.weight")]
        emb = "depformer_text_emb" if i == 0 else f"depformer_emb.{i - 1}"
        for sub in ("weight", "low_rank.weight"):
            if (i, f"emb.{sub}") in per_slice:
                out[f"{emb}.{sub}"] = per_slice[(i, f"emb.{sub}")]
    layer_ids = sorted({int(m.group(1)) for (_, r) in per_slice
                        for m in [re.match(r"transformer\.layers\.(\d+)\.", r)] if m})
    for l in layer_ids:
        base, dst = f"transformer.layers.{l}.", f"depformer.layers.{l}."
        for proj in ("self_attn.in_proj_weight", "self_attn.out_proj.weight"):
            out[dst + proj] = torch.cat([per_slice[(r, base + proj)] for r in reps], dim=0)
        for w, r in enumerate(reps):
            for which in ("linear_in", "linear_out"):
                out[dst + f"gating.{w}.{which}.weight"] = \
                    per_slice[(r, base + f"gating.{which}.weight")]
        for nrm in ("norm1", "norm2"):
            for sub in ("alpha", "weight", "bias"):
                if (0, base + f"{nrm}.{sub}") in per_slice:
                    out[dst + f"{nrm}.{sub}"] = per_slice[(0, base + f"{nrm}.{sub}")]
    return out


def lm_params_from_torch_state(model: LMModel, state: dict, dtype=torch.bfloat16) -> dict:
    """The LM's tree on the host from a PyTorch-named state (or a rust-named
    one), floating tensors cast to `dtype` first, the output norm in f32."""
    c = model.config
    if any(k.startswith("depformer.0.") for k in state):
        sched = c.depformer_weights_per_step_schedule
        state = rust_state_to_torch(state, list(sched) if sched else None)
    state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    p = {
        "text_emb": _emb_params(state, "text_emb"),
        "emb": {"weight": torch.stack([state[f"emb.{k}.weight"] for k in range(c.n_q)])
                if c.n_q else torch.zeros((0, c.card + 1, c.dim), dtype=dtype)},
        "transformer": {"layers": transformer_layers_from_torch(
            state, "transformer", c.transformer_config)},
        "out_norm": {k: v.float() for k, v in _norm_params(state, "out_norm", c.norm).items()},
        "text_linear": {"weight": _lin(state, "text_linear.weight")},
    }
    tcfg = c.transformer_config
    if tcfg.cross_attention and tcfg.shared_cross_attn:
        p["transformer"]["cross_attn_shared"] = _cross_attn_proj_params(
            state, "transformer.layers.0.cross_attention", tcfg)
    if c.extra_heads_num_heads:
        p["extra_heads"] = {"weight": torch.stack(
            [_lin(state, f"extra_heads.{i}.weight") for i in range(c.extra_heads_num_heads)])}
    if model.depformer is not None:
        p["depformer_in"] = {"weight": torch.stack(
            [_lin(state, f"depformer_in.{i}.weight") for i in range(c.num_depformer_in)])}
        p["depformer_text_emb"] = _emb_params(state, "depformer_text_emb")
        p["depformer_emb"] = _stack([_emb_params(state, f"depformer_emb.{k}")
                                     for k in range(c.dep_q - 1)])
        p["depformer"] = {"layers": transformer_layers_from_torch(
            state, "depformer", c.depformer_config)}
        p["linears"] = {"weight": torch.stack(
            [_lin(state, f"linears.{k}.weight") for k in range(c.dep_q)])}
    return p


def _lm_config(lm_config) -> LmConfig:
    if lm_config is None:
        return lm_mod.lm_config_v0_1()
    if isinstance(lm_config, LmConfig):
        return lm_config
    return LmConfig.from_dict(lm_config)


def get_moshi_lm(weights_path: str | Path, lm_config: dict | LmConfig | None = None,
                 dtype=torch.bfloat16, device="cuda",
                 lora_weights: str | Path | None = None,
                 lora_scaling: float = 2.0) -> tuple[LMModel, dict]:
    """The LM from a PyTorch-named (or rust-named) checkpoint, its params
    in `dtype` on `device`; with `lora_weights` the adapters are fused into
    the state first, at the config's `lora_scaling` where it has one (a
    config with `lora: true` requires them)."""
    if isinstance(lm_config, dict):
        if lora_weights is None and lm_config.get("lora"):
            raise ValueError("config requires LoRA weights (lora=true)")
        lora_scaling = lm_config.get("lora_scaling", lora_scaling)
    model = LMModel(_lm_config(lm_config))
    state = load_weights(weights_path)
    if lora_weights is not None:
        state = fuse_lora_state(state, load_file(lora_weights), lora_scaling)
    params = lm_params_from_torch_state(model, state, dtype)
    return model, _to_device(params, device)


# Named presets for checkpoints without a full config.json, selected by the
# `preset` key (moshi_tpu/models/loaders.py LM_PRESETS)
LM_PRESETS = {
    "v0_1": lm_mod.lm_config_v0_1,
    "moshi_7b": lm_mod.lm_config_v0_1,
    "v0_1_vision": lm_mod.lm_config_v0_1_vision,
    "v0_1_vision_streaming": lambda: lm_mod.lm_config_v0_1_vision(streaming=True),
    "tts_v0_1": lm_mod.lm_config_tts_v0_1,
    "s2s_v0_1": lm_mod.lm_config_s2s_v0_1,
    "asr_v0_1_1b": lm_mod.lm_config_asr_v0_1_1b,
    "asr_300m_202501": lm_mod.lm_config_asr_300m_202501,
    "tts_202501": lm_mod.lm_config_tts_202501,
    "s2s_2b_16rvq_202501": lm_mod.lm_config_s2s_2b_16rvq_202501,
}


def hf_get(filename: str | Path, hf_repo: str | None = None,
           check_local_file_exists: bool = False, revision: str | None = None) -> Path:
    """A checkpoint file on this machine (moshi_tpu loaders.py `hf_get`): a
    Path as it is; `hf://org/repo/path` downloaded from that repository;
    `file://` stripped; a bare name inside `hf_repo` (a local directory
    standing in for a repository, else a download into the hub's cache;
    with `check_local_file_exists`, a name that exists here is taken as
    it is); any other name a local path."""
    if isinstance(filename, Path):
        return filename
    if filename.startswith("hf://"):
        parts = filename.removeprefix("hf://").split("/")
        return Path(_hf_hub_download(f"{parts[0]}/{parts[1]}", "/".join(parts[2:]),
                                     revision=revision))
    if filename.startswith("file://"):
        return Path(filename.removeprefix("file://"))
    if hf_repo is not None:
        if check_local_file_exists and Path(filename).exists():
            return Path(filename)
        if Path(hf_repo).is_dir():
            return Path(hf_repo) / filename
        return Path(_hf_hub_download(hf_repo, filename, revision=revision))
    return Path(filename)


def _hf_hub_download(repo: str, filename: str, revision: str | None = None) -> str:
    """One file of a hub repository, through the hub's local cache."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError("huggingface_hub is required to resolve hub checkpoints; "
                           "pass local paths instead") from e
    return hf_hub_download(repo, filename, revision=revision)


# --------------------------------------------------------------- CheckpointInfo
class CheckpointInfo:
    """The reference repository's `config.json`, over a local directory
    (`from_dir`), a hub repository (`from_hf_repo`) or per-file paths
    (`paths`: moshi, mimi, tokenizer, mimi_config, lora)."""

    def __init__(self, config: dict | None, root: Path | None = None,
                 paths: dict | None = None):
        config = dict(config or {})
        self.raw_config = dict(config)
        self.moshi_name = config.pop("moshi_name", "model.safetensors")
        self.mimi_name = config.pop("mimi_name", "tokenizer-e351c8d8-checkpoint125.safetensors")
        self.mimi_config_name = config.pop("mimi_config_name", None)
        self.tokenizer_name = config.pop("tokenizer_name", "tokenizer_spm_32k_3.model")
        self.lora_name = config.pop("lora_name", None)
        self.model_type = config.pop("model_type", "moshi")
        self.lm_gen_config = config.pop("lm_gen_config", {})
        self.tts_config = config.pop("tts_config", {})
        self.stt_config = config.pop("stt_config", {})
        self.model_id = config.pop("model_id", {})
        # the param trees in the JAX package's flattened layout
        # (scripts/export_quantized.py, models/native_ckpt.py)
        self.native_format = bool(config.pop("native_format", False))
        self.preset = config.pop("preset", None)
        if self.preset is not None:
            if self.preset not in LM_PRESETS:
                raise ValueError(f"unknown LM preset {self.preset!r}; "
                                 f"known: {sorted(LM_PRESETS)}")
            self.lm_config = LM_PRESETS[self.preset]()
        else:
            self.lm_config = config if config else None
        self.root = None if root is None else Path(root)
        self.paths = {k: hf_get(v) for k, v in (paths or {}).items()}

    def _path(self, key: str, name: str | None) -> Path:
        if key in self.paths:
            return self.paths[key]
        if self.root is None or name is None:
            raise ValueError(f"no {key} file: no directory and no path given")
        return self.root / name

    @property
    def tokenizer_path(self) -> Path:
        return self._path("tokenizer", self.tokenizer_name)

    def get_text_tokenizer(self):
        """The SentencePiece tokenizer (text/spm.py), or None when the
        checkpoint names no file that is there."""
        from ..text.spm import SentencePieceTokenizer
        try:
            path = self.tokenizer_path
        except ValueError:
            return None
        return SentencePieceTokenizer(path) if path.exists() else None

    @classmethod
    def from_dir(cls, path: str | Path, **paths) -> "CheckpointInfo":
        """The checkpoint in directory `path`; keyword paths (moshi, mimi,
        tokenizer, mimi_config) override single files with local ones."""
        path = Path(path)
        cfg = None
        if (path / "config.json").exists():
            cfg = json.loads((path / "config.json").read_text())
        return cls(cfg, root=path, paths={k: v for k, v in paths.items() if v is not None})

    @classmethod
    def from_hf_repo(cls, hf_repo: str, moshi_weights: Path | str | None = None,
                     mimi_weights: Path | str | None = None,
                     tokenizer: Path | str | None = None,
                     config_path: Path | str | None = None,
                     mimi_config_path: Path | str | None = None,
                     lora_weights: Path | str | None = None,
                     revision: str | None = None) -> "CheckpointInfo":
        """The checkpoint of a hub repository (moshi_tpu loaders.py
        `from_hf_repo`), each file through `hf_get`; a per-file override
        is a local path or an `hf://` name.  A repository without a
        config.json is taken, with a warning, for the legacy Moshi-7B
        layout."""
        cfg = None
        if config_path is None:
            try:
                config_path = hf_get("config.json", hf_repo, revision=revision)
            except Exception:
                warnings.warn(f"Repository {hf_repo} contains no config.json; "
                              "assuming a legacy Moshi 7B layout.")
        if config_path is not None:
            cfg = json.loads(Path(config_path).read_text())
        info = cls(cfg)

        def resolve(override, name):
            if override is not None:
                return hf_get(override, revision=revision)
            return None if name is None else hf_get(name, hf_repo, revision=revision)

        info.paths = {"moshi": resolve(moshi_weights, info.moshi_name),
                      "mimi": resolve(mimi_weights, info.mimi_name),
                      "tokenizer": resolve(tokenizer, info.tokenizer_name)}
        for key, override, name in (("mimi_config", mimi_config_path, info.mimi_config_name),
                                    ("lora", lora_weights, info.lora_name)):
            path = resolve(override, name)
            if path is not None:
                info.paths[key] = path
        return info

    def num_mimi_codebooks(self) -> int:
        if self.lm_config is None:
            return 8
        if isinstance(self.lm_config, LmConfig):
            dep_q, n_q = self.lm_config.dep_q, self.lm_config.n_q
        else:
            dep_q, n_q = self.lm_config["dep_q"], self.lm_config["n_q"]
        n = max(dep_q, n_q - dep_q)
        if self.tts_config.get("multistream"):
            n //= 2
        return n

    def get_mimi(self, device="cuda") -> tuple[MimiModel, dict]:
        mimi_cfg = None
        if "mimi_config" in self.paths or self.mimi_config_name:
            mimi_cfg = json.loads(self._path("mimi_config", self.mimi_config_name).read_text())
        mimi_path = self._path("mimi", self.mimi_name)
        if self.native_format:
            model = MimiModel(mimi_config_from_dict(mimi_cfg, self.num_mimi_codebooks()))
            return model, load_mimi_params(mimi_path, model, device)
        return get_mimi(mimi_path, mimi_cfg, self.num_mimi_codebooks(), device)

    def get_moshi(self, dtype=torch.bfloat16, device="cuda") -> tuple[LMModel, dict]:
        """The LM; a native checkpoint keeps the dtypes and quantized leaves
        it was saved with, a PyTorch-named one is cast to `dtype`."""
        moshi_path = self._path("moshi", self.moshi_name)
        lora = (self._path("lora", self.lora_name)
                if self.lora_name or "lora" in self.paths else None)
        if self.native_format:
            if lora is not None:
                raise NotImplementedError(
                    "a LoRA file beside a native checkpoint (a native tree holds its "
                    "adapters as __lora__ nodes; the JAX package ignores lora_name here)")
            model = LMModel(_lm_config(self.lm_config))
            # the conditioners' tensors in the same file are get_conditioners'
            params = {k: v for k, v in load_params(moshi_path, device).items()
                      if not k.startswith("condition_provider.")}
        else:
            model, params = get_moshi_lm(moshi_path, self.lm_config, dtype, device,
                                         lora_weights=lora)
        if self.model_type == "hibiki":
            # hibiki samples EOS (2) too early now and then: its embedding
            # becomes PAD's (3), so an early EOS acts as PAD
            w = params["text_emb"]["weight"].clone()
            w[2] = w[3]
            params["text_emb"]["weight"] = w
        return model, params

    def get_conditioners(self, output_dim: int, device="cuda"):
        """The checkpoint's conditioners with their weights: (provider,
        fuser, params).  provider and params are None without a
        `conditioners` block in config.json, fuser None without a `fuser`
        block.  The weights are the moshi file's
        `condition_provider.conditioners.<name>.*` tensors (PyTorch layout),
        read from the mapped file: only they are copied."""
        from ..conditioners import ConditionFuser, conditioners_from_config

        raw = self.raw_config
        provider, params = None, None
        if raw.get("conditioners"):
            provider = conditioners_from_config(output_dim, raw["conditioners"])
            state = load_weights(self._path("moshi", self.moshi_name))
            params = {}
            for name in provider.conditioners:
                prefix = f"condition_provider.conditioners.{name}"
                p = {}
                if f"{prefix}.embed.weight" in state:
                    p["embed"] = state[f"{prefix}.embed.weight"]
                if f"{prefix}.output_proj.weight" in state:
                    p["output_proj"] = state[f"{prefix}.output_proj.weight"].t()
                if f"{prefix}.learnt_padding" in state:
                    p["learnt_padding"] = state[f"{prefix}.learnt_padding"]
                params[name] = _to_device(p, device)
        fuser = None
        if raw.get("fuser"):
            fuser = ConditionFuser({k: v for k, v in raw["fuser"].items()
                                    if k in ("sum", "cross", "prepend")})
        return provider, fuser, params
