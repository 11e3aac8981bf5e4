"""The text-only LM (Helium) in the port against the JAX package's, over the
tiny Hugging Face Llama checkpoint of tests/test_importers.py (GQA,
kv_repeat 2) imported once with scripts/import_helium.py and loaded by
both packages' CheckpointInfo in f32: embed_inputs, forward_text and a
T = 7 prefill's logits, greedy generate_text token for token, init_params
at n_q == 0, run_helium.main end to end with a synthetic tokenizer, and
the checkpoint requantized to q4 (plain GEMVs on the CPU) against the f32
logits, also written and read back as a native checkpoint.  Then
sample_token's precedence against JAX's."""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import import_helium  # noqa: E402
from moshi_tpu.models.lm import LMModel as JLM  # noqa: E402
from moshi_tpu.models.loaders import CheckpointInfo as JInfo  # noqa: E402
from moshi_tpu.run_helium import generate_text as jgenerate  # noqa: E402
from moshi_tpu.utils import sampling as jsampling  # noqa: E402
from moshi_tpu_torch import run_helium  # noqa: E402
from moshi_tpu_torch.models.lm import LMModel  # noqa: E402
from moshi_tpu_torch.models.loaders import CheckpointInfo  # noqa: E402
from moshi_tpu_torch.models.native_ckpt import save_params  # noqa: E402
from moshi_tpu_torch.text.spm import spm_model_bytes  # noqa: E402
from moshi_tpu_torch.utils import sampling  # noqa: E402
from moshi_tpu_torch.utils.quantize import QTensor4, quantize_lm_params  # noqa: E402

TOL = 1e-5          # f32, the port against JAX
# ||q4 logits - f32 logits|| / ||f32 logits|| over the prefill, at most: q4
# in groups of 16 (the tiny widths are not multiples of 64), stated before
# the first run
Q4_BOUND = 0.15
PROMPT = [1, 2, 3, 4, 5, 6, 7]
DIM, VOCAB, LAYERS, HEADS, KV_HEADS, HIDDEN = 32, 64, 2, 4, 2, 32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_lora.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """tests/test_importers.py:493's tiny HF Llama checkpoint through
    import_helium, with a synthetic tokenizer of the vocabulary."""
    from safetensors.numpy import save_file

    tmp = tmp_path_factory.mktemp("helium")
    rs = np.random.RandomState(0)
    head_dim = DIM // HEADS
    t = {"model.embed_tokens.weight": rs.randn(VOCAB, DIM) * 0.05,
         "lm_head.weight": rs.randn(VOCAB, DIM) * 0.05,
         "model.norm.weight": np.ones(DIM) + rs.randn(DIM) * 0.01}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = np.ones(DIM) + rs.randn(DIM) * 0.01
        t[p + "post_attention_layernorm.weight"] = np.ones(DIM)
        t[p + "self_attn.q_proj.weight"] = rs.randn(DIM, DIM) * 0.05
        t[p + "self_attn.k_proj.weight"] = rs.randn(KV_HEADS * head_dim, DIM) * 0.05
        t[p + "self_attn.v_proj.weight"] = rs.randn(KV_HEADS * head_dim, DIM) * 0.05
        t[p + "self_attn.o_proj.weight"] = rs.randn(DIM, DIM) * 0.05
        t[p + "mlp.gate_proj.weight"] = rs.randn(HIDDEN, DIM) * 0.05
        t[p + "mlp.up_proj.weight"] = rs.randn(HIDDEN, DIM) * 0.05
        t[p + "mlp.down_proj.weight"] = rs.randn(DIM, HIDDEN) * 0.05
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in t.items()},
              str(tmp / "hf.safetensors"))
    out = import_helium.import_model(tmp / "hf.safetensors", tmp / "helium", num_heads=HEADS,
                                     context=64)
    (out / "tokenizer_spm_32k_3.model").write_bytes(spm_model_bytes(VOCAB))
    return out


@pytest.fixture(scope="module")
def models(ckpt):
    """(JAX LM, its f32 params), (the port's LM, its f32 params)."""
    jlm, jp = JInfo.from_dir(ckpt).get_moshi(dtype=jnp.float32)
    tlm, tp = CheckpointInfo.from_dir(ckpt).get_moshi(dtype=torch.float32, device="cpu")
    return (jlm, jp), (tlm, tp)


def seq(ids) -> tuple:
    return (jnp.asarray(ids, jnp.int32)[None, None],
            torch.tensor(ids, dtype=torch.long)[None, None])


def close(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.detach().float().numpy() - want).max())


def test_checkpoint_is_text_only_gqa(models):
    (jlm, _), (tlm, tp) = models
    c = tlm.config
    assert c.n_q == c.dep_q == 0 and c.kv_repeat == HEADS // KV_HEADS == 2
    assert tlm.depformer is None and tuple(tp["emb"]["weight"].shape) == (0, 1, DIM)
    assert dataclasses.asdict(c)["text_card"] == jlm.config.text_card == VOCAB


def test_embed_inputs_equal_jax(models):
    (jlm, jp), (tlm, tp) = models
    js, ts = seq([0, 5, 63, 70, -1, 2])   # ids past the table clamp; -1 embeds to zero
    got = tlm.embed_inputs(tp, ts)
    assert got.dtype == torch.float32
    assert close(got, jlm.embed_inputs(jp, js)) <= TOL


def test_forward_text_equal_jax(models):
    (jlm, jp), (tlm, tp) = models
    js, ts = seq(PROMPT + [9, 10, 11])
    jh, jlogits = jlm.forward_text(jp, js)
    th, tlogits = tlm.forward_text(tp, ts)
    assert close(th, jh) <= TOL and close(tlogits, jlogits) <= TOL


def test_prefill_logits_equal_jax(models):
    """One T = 7 forward_text_step over a fresh f32 ring, then one step:
    the logits of every position agree."""
    (jlm, jp), (tlm, tp) = models
    jstate = jlm.transformer.init_state(1, jnp.float32)
    tstate = tlm.transformer.init_state(1, torch.float32, "cpu")
    for ids in (PROMPT, [12]):
        js, ts = seq(ids)
        _, jlogits, jstate = jlm.forward_text_step(jp, jstate, js)
        _, tlogits, tstate = tlm.forward_text_step(tp, tstate, ts)
        assert close(tlogits, jlogits) <= TOL
    assert int(tstate["offset"][0]) == len(PROMPT) + 1


@pytest.mark.parametrize("prompt", [PROMPT, [3]])
def test_greedy_generate_text_equals_jax(models, prompt):
    (jlm, jp), (tlm, tp) = models
    want = jgenerate(jlm, jp, prompt, 12, jax.random.PRNGKey(0), temp=0.0, dtype=jnp.float32)
    got = run_helium.generate_text(tlm, tp, prompt, 12, torch.Generator().manual_seed(0),
                                   temp=0.0, dtype=torch.float32)
    assert got == want and len(got) == 12


def test_sampled_generate_text_repeats_with_its_seed(models):
    _, (tlm, tp) = models
    runs = [run_helium.generate_text(tlm, tp, PROMPT, 10, torch.Generator().manual_seed(s),
                                     dtype=torch.float32, stats=stats)
            for s, stats in ((0, {}), (0, None), (1, None))]
    assert runs[0] == runs[1] != runs[2]
    assert all(0 <= t < VOCAB for t in runs[0])
    with pytest.raises(ValueError, match="CUDA"):
        run_helium.generate_text(tlm, tp, PROMPT, 2, torch.Generator(), graphed=True)


def test_init_params_text_only_matches_jax_tree(models):
    (jlm, _), (tlm, _) = models
    jtree = jax.eval_shape(lambda k: JLM(jlm.config).init_params(k, jnp.float32),
                           jax.random.PRNGKey(0))
    ttree = LMModel(tlm.config).init_params(torch.Generator().manual_seed(0), torch.float32)

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v for k, sub in tree.items()
                    for k2, v in shapes(sub, f"{path}/{k}").items()}
        return {path: tuple(tree.shape)}

    assert shapes(ttree) == shapes(jtree)
    assert shapes(ttree)["/emb/weight"] == (0, 1, DIM)
    # the fresh tree runs: a prefill and a step
    state = tlm.transformer.init_state(1, torch.float32, "cpu")
    for ids in (PROMPT, [4]):
        _, logits, state = tlm.forward_text_step(ttree, state, seq(ids)[1])
        assert torch.isfinite(logits).all() and logits.shape[-1] == VOCAB


def test_run_helium_main_end_to_end(ckpt, models, capsys):
    _, (tlm, tp) = models
    ids = run_helium.main(["--checkpoint-dir", str(ckpt), "--prompt", "w3 w4 w5",
                           "-n", "6", "--temp", "0", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.startswith("w3 w4 w5") and len(ids) == 6
    # main loads bf16 weights (the CLI's default dtype)
    _, tp16 = CheckpointInfo.from_dir(ckpt).get_moshi(device="cpu")
    assert ids == run_helium.generate_text(tlm, tp16, [3, 4, 5], 6, torch.Generator(),
                                           temp=0.0)


def test_q4_requantized_within_bound_and_native(models, tmp_path):
    """q4 in groups of 16 on every linear and the head (the plain GEMVs on
    the CPU): the prefill's logits within Q4_BOUND of the f32 ones; the
    tree written as a native checkpoint and read back by run_helium.main
    gives the in-memory tree's greedy tokens."""
    _, (tlm, tp) = models
    q4 = quantize_lm_params(tp, min_size=1, mode="int4", group_size=16)
    assert isinstance(q4["text_linear"]["weight"], QTensor4)
    layers = q4["transformer"]["layers"]
    assert all(isinstance(w, QTensor4) for w in (layers["attn"]["in_proj"],
                                                  layers["mlp"]["linear_out"]))
    errs = []
    for params in (tp, q4):
        state = tlm.transformer.init_state(1, torch.float32, "cpu")
        errs.append(tlm.forward_text_step(params, state, seq(PROMPT)[1])[1])
    rel = ((errs[1] - errs[0]).norm() / errs[0].norm()).item()
    assert 0 < rel <= Q4_BOUND, rel

    d = tmp_path / "native"
    d.mkdir()
    save_params(d / "model.q4.safetensors", q4)
    config = {k: list(v) if isinstance(v, tuple) else v
              for k, v in dataclasses.asdict(tlm.config).items()}
    config.update(moshi_name="model.q4.safetensors", model_type="helium", native_format=True)
    (d / "config.json").write_text(json.dumps(config))
    (d / "tokenizer_spm_32k_3.model").write_bytes(spm_model_bytes(VOCAB))
    ids = run_helium.main(["--checkpoint-dir", str(d), "--prompt", "w7 w8", "-n", "5",
                           "--temp", "0", "--device", "cpu"])
    assert ids == run_helium.generate_text(tlm, q4, [7, 8], 5, torch.Generator(), temp=0.0)


# ---------------------------------------------------------------- sampling
def test_sample_token_precedence_matches_jax():
    """argmax (not sampling, or temp <= 0) before top-k, top-k before the
    plain draw, as JAX's sample_token."""
    logits = np.random.RandomState(4).randn(4, 50).astype(np.float32)
    x = torch.from_numpy(logits)
    argmax = logits.argmax(-1).tolist()
    for kw in ({"use_sampling": False, "top_k": 5}, {"temp": 0.0, "top_k": 5},
               {"top_k": 1}, {"top_k": 1, "temp": 2.0}):
        mine = sampling.sample_token(torch.Generator(), x, **kw).tolist()
        theirs = np.asarray(jsampling.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits),
                                                   **kw)).tolist()
        assert mine == theirs == argmax, kw
    # top_k = 5 keeps both packages' draws inside the 5 largest; the plain
    # draw leaves them
    row = np.random.RandomState(5).randn(50).astype(np.float32)
    top5 = set(np.argsort(-row)[:5].tolist())
    rows = np.repeat(row[None], 1000, 0)
    mine = set(sampling.sample_token(torch.Generator().manual_seed(0), torch.from_numpy(rows),
                                     top_k=5).tolist())
    theirs = set(np.asarray(jsampling.sample_token(jax.random.PRNGKey(0), jnp.asarray(rows),
                                                   top_k=5)).tolist())
    assert 1 < len(mine) and mine <= top5 and 1 < len(theirs) and theirs <= top5
    plain = set(sampling.sample_token(torch.Generator().manual_seed(0),
                                      torch.from_numpy(rows)).tolist())
    assert plain - top5
