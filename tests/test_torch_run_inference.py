"""The speech-to-speech (Hibiki) and speech-to-text halves of the port held
against the JAX package on the CPU, in f32 at a tiny size: the LM
configuration fields of Hibiki checkpoints (a depformer weight schedule,
one or many depformer_in, low-rank depformer embeddings, a demuxed second
text stream), `embed`, `depformer_step` (greedy, with CFG, over int8
leaves), `forward_depformer_training`, the quantizer's bytes, LMGen without
a depformer, the loaders (PyTorch- and rust-named states), and
`run_inference` for model_type "hibiki" and "stt" over checkpoints the JAX
package writes (its native writer, from its own init_params), in-process
and through the CLI."""

import dataclasses
import functools
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
from moshi_tpu import audio as jaudio  # noqa: E402
from moshi_tpu.conditioners import LUTConditioner as JLUT  # noqa: E402
from moshi_tpu.models import lm as jlm_mod  # noqa: E402
from moshi_tpu.models import loaders as jl  # noqa: E402
from moshi_tpu.models.lm_gen import LMGen as JGen, LMGenConfig as JGenConfig  # noqa: E402
from moshi_tpu.models.native_ckpt import save_params as jsave  # noqa: E402
from moshi_tpu.run_inference import InferenceState as JInference  # noqa: E402
from moshi_tpu.utils.quantize import quantize_lm_params as jquantize  # noqa: E402
from moshi_tpu_torch import run_inference as trun  # noqa: E402
from moshi_tpu_torch.models import lm as tlm  # noqa: E402
from moshi_tpu_torch.models import loaders as tl  # noqa: E402
from moshi_tpu_torch.models.lm_gen import LMGen as TGen, LMGenConfig as TGenConfig  # noqa: E402
from moshi_tpu_torch.models.mimi import MimiModel as TMimi  # noqa: E402
from moshi_tpu_torch.models.native_ckpt import save_mimi_params  # noqa: E402
from moshi_tpu_torch.text.spm import spm_model_bytes  # noqa: E402
from moshi_tpu_torch.utils import safetensors as tst  # noqa: E402
from moshi_tpu_torch.utils.params import from_jax  # noqa: E402
from moshi_tpu_torch.utils.quantize import quantize_lm_params  # noqa: E402
from test_importers import _torch_to_rust_layout  # noqa: E402
from test_lm import tiny_lm_config  # noqa: E402
from test_torch_checkpoint import assert_same_tree  # noqa: E402
from test_torch_port import port_lm_config, rel_err  # noqa: E402

SCHEDULE = (0, 1, 1)  # tests/test_golden.py's: 2 weight sets for 3 steps
LOW_RANK = 8
# a 24 kHz Mimi at the real geometry (frame 1920 samples, 2 transformer steps
# a frame), tiny widths, 32 bins (the LMs' card)
MIMI = {"sample_rate": 24000, "channels": 1, "frame_rate": 12.5,
        "seanet": {"channels": 1, "dimension": 32, "n_filters": 4, "n_residual_layers": 1,
                   "ratios": [8, 6, 5, 4], "kernel_size": 7, "residual_kernel_size": 3,
                   "last_kernel_size": 3, "dilation_base": 2, "compress": 2,
                   "pad_mode": "constant"},
        "transformer": {"d_model": 32, "num_heads": 2, "num_layers": 2, "causal": True,
                        "context": 25, "max_period": 10000, "gating": "none",
                        "norm": "layer_norm", "positional_embedding": "rope",
                        "dim_feedforward": 64, "layer_scale": 0.01},
        "quantizer": {"dimension": 16, "n_q": 8, "bins": 32, "input_dimension": 32,
                      "output_dimension": 32}}
LUT = {"n_bins": 2, "dim": 8, "tokenizer": "noop",
       "possible_values": ["very_bad", "very_good"]}
FS = 1920


def hibiki_config(**over):
    """A tiny Hibiki-shaped LM (JAX config): 3 generated and 3 input
    codebooks with the acoustic delay 2, the weight schedule, low rank."""
    kw = dict(n_q=6, dep_q=3, card=32, text_card=64, context=16,
              delays=(0, 0, 2, 2, 0, 2, 2), depformer_weights_per_step_schedule=SCHEDULE,
              depformer_low_rank_embeddings=LOW_RANK)
    return tiny_lm_config(**{**kw, **over})


def stt_config():
    return tiny_lm_config(n_q=4, dep_q=0, card=32, text_card=64, context=16,
                          delays=(0,) * 5)


@functools.lru_cache(maxsize=None)
def jax_lm(cfg, seed=0):
    """The JAX package's LM and its init_params in f32 (jitted: one XLA
    program instead of one per shape; the same values)."""
    model = jlm_mod.LMModel(cfg)
    return model, jax.jit(model.init_params, static_argnums=1)(jax.random.PRNGKey(seed),
                                                                jnp.float32)


def single_linear(cfg):
    """jax_lm's model and params with one depformer_in (member 0 of the
    stack): the same draws as jax_lm(cfg) but for that leaf."""
    model, params = jax_lm(cfg)
    params = {**params, "depformer_in": {"weight": params["depformer_in"]["weight"][:1]}}
    return jlm_mod.LMModel(dataclasses.replace(cfg, depformer_multi_linear=False)), params


def port(model, params):
    return tlm.LMModel(port_lm_config(model.config)), from_jax(jax.device_get(params))


# ------------------------------------------------------------------ config
FIELDS = {"schedule": {"depformer_weights_per_step_schedule": [0, 1, 1]},
          "low_rank": {"depformer_low_rank_embeddings": 8},
          "single_linear": {"depformer_multi_linear": False},
          "demux": {"demux_second_stream": True}}


@pytest.mark.parametrize("fields", sorted(FIELDS))
def test_lm_config_fields_match_jax(fields):
    """LmConfig.from_dict with each Hibiki field gives JAX's fields, its
    depformer_in count and per-step index, and its depformer config."""
    d = {**{k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(hibiki_config(
                depformer_weights_per_step_schedule=None,
                depformer_low_rank_embeddings=None)).items()
            if k not in ("causal", "remat")}, **FIELDS[fields]}
    got, want = tlm.LmConfig.from_dict(d), jlm_mod.LmConfig.from_dict(d)
    assert got == port_lm_config(want)
    assert got.num_depformer_in == want.num_depformer_in
    assert [got.depformer_in_index(k) for k in range(got.dep_q)] == [
        int(want.depformer_in_index(k)) for k in range(want.dep_q)]
    tdep, jdep = got.depformer_config, want.depformer_config
    assert (tdep.num_weights, tdep.weights_per_step_schedule) == (
        jdep.num_weights, jdep.weights_per_step_schedule)
    acausal = {**d, "causal": False}
    got, want = tlm.LmConfig.from_dict(acausal), jlm_mod.LmConfig.from_dict(acausal)
    assert got == port_lm_config(want) and not got.causal
    assert not got.transformer_config.causal and not got.depformer_config.causal


# ------------------------------------------------------------------- embed
def _table(rs, rows, width, **parts):
    p = {"weight": rs.randn(rows, width).astype(np.float32)}
    p.update({k: rs.randn(*v).astype(np.float32) for k, v in parts.items()})
    return p


@pytest.mark.parametrize("kind", ["plain", "low_rank", "demux"])
def test_embed_matches_jax(kind):
    """ZERO_TOKEN embeds to exactly zero, ids clamp into the table, and a
    demuxed id whose second stream is negative adds nothing."""
    rs = np.random.RandomState(3)
    card = 10
    table = _table(rs, card, 6, **({"low_rank": (6, 12)} if kind == "low_rank" else
                                   {"out1": (6, 12), "out2": (6, 12)} if kind == "demux"
                                   else {}))
    ids = np.array([[-1, -5, 0, 3, 9, 10, 57, card * 5 + 2, 4 * card - 1, 10 ** 6]])
    got = tlm.embed({k: torch.from_numpy(v) for k, v in table.items()}, torch.from_numpy(ids))
    want = np.asarray(jlm_mod.embed({k: jnp.asarray(v) for k, v in table.items()},
                                    jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[0, 0].any()
    if kind == "demux":  # ids below card have no second stream
        np.testing.assert_allclose(got[0, 3].numpy(), table["weight"][3] @ table["out1"],
                                   rtol=1e-6)


# ------------------------------------------------------------- depformer
DEP_CASES = [(True, 1.0, None), (True, 2.0, None), (False, 1.0, None), (False, 2.0, None),
             (True, 2.0, "int8"), (False, 1.0, "int8")]


@pytest.mark.parametrize("multi_linear,cfg_coef,quant", DEP_CASES)
def test_depformer_step_matches_jax(multi_linear, cfg_coef, quant):
    """Greedy depformer tokens over the schedule and low-rank tables equal
    JAX's, with one or many depformer_in, with CFG, over int8 leaves."""
    jm, jp = jax_lm(hibiki_config()) if multi_linear else single_linear(hibiki_config())
    if quant:
        jp = jquantize(jp, min_size=1, mode=quant)
    tm, tp = port(jm, jp)
    assert tp["depformer_in"]["weight"].shape[0] == (2 if multi_linear else 1)
    B = 3
    rs = np.random.RandomState(7)
    text = rs.randint(0, 64, (B,))
    h = rs.randn(B * (2 if cfg_coef != 1.0 else 1), 1, jm.config.dim).astype(np.float32)
    step = jax.jit(jm.depformer_step, static_argnames=("use_sampling", "cfg_coef"))
    want = step(jp, jax.random.PRNGKey(0), jnp.asarray(text, jnp.int32), jnp.asarray(h),
                use_sampling=False, cfg_coef=cfg_coef)
    got = tm.depformer_step(tp, None, torch.from_numpy(text), torch.from_numpy(h),
                            use_sampling=False, cfg_coef=cfg_coef)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("multi_linear", [True, False])
def test_forward_depformer_training_matches_jax(multi_linear):
    jm, jp = jax_lm(hibiki_config()) if multi_linear else single_linear(hibiki_config())
    tm, tp = port(jm, jp)
    rs = np.random.RandomState(1)
    B, T = 2, 5
    delayed = rs.randint(0, 32, (B, jm.config.num_codebooks, T))
    h = rs.randn(B, T, jm.config.dim).astype(np.float32)
    want = jm.forward_depformer_training(jp, jnp.asarray(delayed, jnp.int32), jnp.asarray(h))
    got = tm.forward_depformer_training(tp, torch.from_numpy(delayed), torch.from_numpy(h))
    assert rel_err(got.numpy(), np.asarray(want)) < 2e-4


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_leaves_equal_jax(mode):
    """The port's quantizer leaves the low-rank tables as they are and
    quantizes the reduced depformer_in stack, byte for byte as JAX does
    (int4 in groups of 16, so that the 32-wide temporal linears take q4)."""
    cfg = hibiki_config()
    jm, jp = jax_lm(cfg)
    kw = {"min_size": 1, "mode": mode, "group_size": 16}
    got = quantize_lm_params(from_jax(jax.device_get(jp)), **kw)
    want = jquantize(jp, **kw)
    assert_same_tree(got, from_jax(jax.device_get(want)))
    assert got["depformer_in"]["weight"].q.shape[0] == 2
    if mode == "int4":
        assert type(got["text_linear"]["weight"]).__name__ == "QTensor4"
    assert isinstance(got["depformer_emb"]["low_rank"], torch.Tensor)


# ------------------------------------------------------------------ LMGen
def test_lm_gen_without_depformer_matches_jax():
    """An LM with dep_q = 0 steps through LMGen: greedy text equal to JAX's
    over 12 frames, output frames [B, 1, 1]."""
    jm, jp = jax_lm(stt_config(), seed=2)
    tm, tp = port(jm, jp)
    B = 2
    jgen, tgen = JGen(jm, JGenConfig(use_sampling=False)), TGen(tm, TGenConfig(use_sampling=False))
    jstate = jgen.init_state(B, jax.random.PRNGKey(0), dtype=jnp.float32)
    tstate = tgen.init_state(B, None, torch.float32)
    step = jax.jit(jgen.step)
    rs = np.random.RandomState(5)
    for _ in range(12):
        toks = rs.randint(0, 32, (B, 4, 1))
        oj, jstate = step(jp, jstate, jnp.asarray(toks, jnp.int32))
        ot, tstate = tgen.step(tp, tstate, torch.from_numpy(toks))
        assert ot.shape == (B, 1, 1)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


# ---------------------------------------------------------------- loaders
def test_torch_and_rust_named_states_load_to_jax_tree(tmp_path):
    """A PyTorch-named state with low-rank depformer tables and a demuxed
    text embedding (out1 / out2), and its rust-named form with the
    schedule, load in the port to the JAX package's tree of the first
    (tests/test_importers.py holds JAX's rust-named load to it)."""
    jm, jp = jax_lm(hibiki_config())  # a demuxed text embedding has no JAX init
    cfg = hibiki_config(demux_second_text_stream=True)
    state = export_torch.lm_params_to_torch_state(jm, jp)
    rs = np.random.RandomState(4)
    for part in ("out1", "out2"):
        state[f"text_emb.{part}.weight"] = rs.randn(cfg.dim, cfg.dim).astype(np.float32)
    rust = _torch_to_rust_layout(state, 2, cfg.dep_q, cfg.depformer_num_layers, list(SCHEDULE))
    for i in range(cfg.dep_q):
        rust[f"depformer.{i}.emb.low_rank.weight"] = state[
            "depformer_text_emb.low_rank.weight" if i == 0
            else f"depformer_emb.{i - 1}.low_rank.weight"]
    cfg_dict = {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(cfg).items()}
    want = None
    for names, st in (("torch", state), ("rust", rust)):
        path = tmp_path / f"{names}.safetensors"
        tst.save_file({k: torch.from_numpy(np.array(v)) for k, v in st.items()}, path)
        if want is None:  # the JAX package's tree of the PyTorch-named state
            want = from_jax(jax.device_get(
                jl.get_moshi_lm(path, dict(cfg_dict), dtype=jnp.float32)[1]))
        _, tparams = tl.get_moshi_lm(path, dict(cfg_dict), dtype=torch.float32, device="cpu")
        assert_same_tree(tparams, want)
        assert set(tparams["text_emb"]) == {"weight", "out1", "out2"}
        assert tparams["depformer_in"]["weight"].shape[0] == 2


# ---------------------------------------------------------- run_inference
def _jsonable(cfg) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def write_checkpoint(out: Path, cfg, extra: dict, seed: int, lut: bool) -> Path:
    """A native checkpoint: the JAX package's init_params of the LM written
    by its native writer (the `description` LUT's tensors under their
    PyTorch names in the same file when `lut`), a seeded Mimi by the port's
    (the JAX package's Mimi init compiles for ~20 s on the CPU), the
    synthetic tokenizer and config.json."""
    out.mkdir(parents=True)
    lm, params = jax_lm(cfg, seed)
    tree = dict(params)
    config = {**_jsonable(cfg), **extra}
    if lut:
        cp = JLUT(output_dim=cfg.dim, **LUT).init_params(jax.random.PRNGKey(seed + 1))
        prefix = "condition_provider.conditioners.description"
        tree[f"{prefix}.embed.weight"] = cp["embed"]
        tree[f"{prefix}.output_proj.weight"] = cp["output_proj"].T
        tree[f"{prefix}.learnt_padding"] = cp["learnt_padding"]
        config.update(conditioners={"description": {"type": "lut", "lut": LUT}},
                      fuser={"sum": ["description"], "cross": []})
    jsave(out / "model.native.safetensors", tree)
    n_cb = max(cfg.dep_q, cfg.n_q - cfg.dep_q)
    mimi = TMimi(tl.mimi_config_from_dict(MIMI, n_cb))
    save_mimi_params(out / "mimi.native.safetensors", mimi,
                     mimi.init_params(torch.Generator().manual_seed(seed)))
    (out / "mimi_config.json").write_text(json.dumps(MIMI))
    (out / "tokenizer.model").write_bytes(spm_model_bytes(cfg.text_card))
    config.update(moshi_name="model.native.safetensors", mimi_name="mimi.native.safetensors",
                  mimi_config_name="mimi_config.json", tokenizer_name="tokenizer.model",
                  native_format=True, lm_gen_config={"use_sampling": False})
    (out / "config.json").write_text(json.dumps(config))
    return out


@pytest.fixture(scope="module")
def hibiki_ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("ckpt") / "hibiki", hibiki_config(),
                            {"model_type": "hibiki"}, 0, lut=True)


@pytest.fixture(scope="module")
def stt_ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("ckpt") / "stt", stt_config(),
                            {"model_type": "stt", "stt_config": {
                                "audio_silence_prefix_seconds": 0.16,
                                "audio_delay_seconds": 0.24}}, 3, lut=False)


def pcm(B: int, frames: int, seed: int = 0) -> np.ndarray:
    return (0.3 * np.random.RandomState(seed).randn(B, 1, frames * FS)).astype(np.float32)


def _states(ckpt, B, cfg_coef):
    """Each package's InferenceState over the checkpoint, greedy."""
    out = []
    for pkg, info in (("jax", jl.CheckpointInfo.from_dir(ckpt)),
                      ("port", tl.CheckpointInfo.from_dir(ckpt))):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        mimi, mimi_params = info.get_mimi(**kw)
        lm, lm_params = (info.get_moshi(dtype=jnp.float32) if pkg == "jax"
                         else info.get_moshi(device="cpu"))
        provider, fuser, cp = info.get_conditioners(lm.config.dim, **kw)
        cls = JInference if pkg == "jax" else trun.InferenceState
        out.append(cls(info, mimi, mimi_params, lm, lm_params, None, B, cfg_coef,
                       condition_provider=provider, condition_provider_params=cp,
                       fuser=fuser, use_sampling=False, **kw))
    return out


INPUT_FRAMES = 5


@pytest.mark.parametrize("cfg_coef", [1.0, 2.0])
def test_hibiki_run_matches_jax(hibiki_ckpt, cfg_coef):
    """Hibiki's loop in both packages at B = 2: the conditioned steps, one
    end-of-stream frame after the input, silence to max_steps; then with
    eos_id set to a token the streams sample after that frame, each stream
    stops at it.  Text tokens equal, PCM of as many frames."""
    jstate, tstate = _states(hibiki_ckpt, 2, cfg_coef)
    assert tstate.condition_sum.shape == (2 * (1 if cfg_coef == 1.0 else 2), 1, 32)
    max_steps = INPUT_FRAMES + 7
    x = pcm(2, INPUT_FRAMES)
    want = jstate.run(x, max_steps=max_steps)
    got = tstate.run(x, max_steps=max_steps)
    assert tstate.stats["steps"] == max_steps and tstate.stats["eos_frames"] == 1
    assert tstate.stats["lm_steps"] == max_steps + 1
    for (tt, tp), (jt, jp) in zip(got, want):
        np.testing.assert_array_equal(tt, jt)
        assert tp.shape == jp.shape == (1, len(jt) * FS)
        assert np.isfinite(tp).all()
    # the stopping rule: stream 0 stops at its first `eos` after the
    # end-of-stream frame, stream 1 where its tokens say
    first = [t for t, _ in got]
    eos = int(first[0][-1])
    jstate.rng = jax.random.PRNGKey(0)  # the JAX runner donated its key to the last run
    want = jstate.run(x, eos_id=eos, max_steps=max_steps)
    got = tstate.run(x, eos_id=eos, max_steps=max_steps)
    for (tt, tp), (jt, jp), full in zip(got, want, first):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tt, full[:len(tt)])
        assert tp.shape == jp.shape == (1, len(jt) * FS)
    assert got[0][0][-1] == eos


def test_stt_run_matches_jax(stt_ckpt):
    """Speech-to-text: the input padded by stt_config, one step a padded
    frame, the first stream's text equal to JAX's and no PCM."""
    jstate, tstate = _states(stt_ckpt, 1, 1.0)
    x = pcm(1, INPUT_FRAMES, seed=1)
    (jt, jp), = jstate.run(x)
    (tt, tp), = tstate.run(x)
    np.testing.assert_array_equal(tt, jt)
    padded = INPUT_FRAMES * FS + int(0.16 * 24000) + int((0.24 + 1.0) * 24000)
    assert tstate.stats["steps"] == padded // FS == len(tt)
    assert tp.shape == jp.shape == (1, 0)
    assert ((tt >= 0) & (tt < 64)).all()


@pytest.mark.parametrize("kind", ["hibiki", "stt"])
def test_cli_runs_on_cpu(kind, hibiki_ckpt, stt_ckpt, tmp_path):
    """`main` with the JAX CLI's flags on --device cpu: the checkpoint's
    greedy lm_gen_config, the text and (hibiki) a wav of the output."""
    ckpt = hibiki_ckpt if kind == "hibiki" else stt_ckpt
    wav, out = tmp_path / "in.wav", tmp_path / "out.wav"
    jaudio.write_wav(wav, pcm(1, 3, seed=2)[0, 0], 24000)
    state, outs = trun.main(["--checkpoint-dir", str(ckpt), "--device", "cpu",
                             "--max-steps", "8", str(wav), str(out)])
    text, audio = outs[0]
    assert len(text) == state.stats["tokens"] > 0
    assert jaudio.read_wav(out)[0].shape[-1] == audio.shape[-1]
    if kind == "hibiki":
        assert audio.shape[-1] == len(text) * FS and state.stats["eos_frames"] == 1
    else:
        assert audio.shape[-1] == 0 and state.stats["steps"] == 8
