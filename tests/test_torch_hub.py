"""Checkpoints, voices and worker modules from the Hugging Face hub, the
port's against the JAX package's (moshi_tpu/models/loaders.py `hf_get`,
`CheckpointInfo.from_hf_repo`; tests/test_hf_loading.py does the same
for JAX).  No test fetches anything: both packages' `_hf_hub_download` are
replaced by one that serves a local directory, a tiny TTS checkpoint the
port writes (tests/test_torch_tts_serve_cli.py `write_tts_checkpoint`: an LM,
a 1200 Hz Mimi, a synthetic tokenizer, config.json and two voices), plus
that Mimi under its PyTorch names for the reference TOML.

Checked: `hf_get`'s forms; `from_hf_repo` with per-file overrides, a
revision and a legacy repository without config.json, field for field
against JAX's CheckpointInfo, and the weights it loads equal to a local
directory's; a reference TOML with `hf://` paths and a worker module
from `hf_repo`, both built; `hf://` voices and a hub `voice_repo` in
`run_tts` (so `simple_generate`), whose PCM equals the local files'."""

import json
import tomllib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from moshi_tpu import run_tts as jrun
from moshi_tpu.models import loaders as jl
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.serve import toml_compat as jcompat
from moshi_tpu_torch import audio as taudio
from moshi_tpu_torch import run_tts as trun
from moshi_tpu_torch.models import loaders as tl
from moshi_tpu_torch.serve import toml_compat as tcompat
from moshi_tpu_torch.serve import worker as tworker
from test_torch_checkpoint import assert_same_tree, mimi_torch_state
from test_torch_tts_serve_cli import WORDS, write_tts_checkpoint

REPO = "kyutai/tiny-test"
INFO_FIELDS = ("raw_config", "moshi_name", "mimi_name", "mimi_config_name", "tokenizer_name",
               "lora_name", "model_type", "lm_gen_config", "tts_config", "stt_config",
               "model_id", "native_format", "preset", "lm_config", "root")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_lora.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """The hub repository's files: the voiced tiny TTS checkpoint, and its
    Mimi as a PyTorch-named `mimi.safetensors` with `mimi_config.json`
    beside it."""
    out = write_tts_checkpoint(tmp_path_factory.mktemp("hub"), True)
    info = tl.CheckpointInfo.from_dir(out)
    mimi, params = info.get_mimi(device="cpu")
    mimi.relayout_jax_convs(params, to_jax=True)
    jmimi = JMimi(jl.mimi_config_from_dict(json.loads((out / "mimi_config.json").read_text()),
                                           mimi.num_codebooks))
    tree = jax.tree.map(lambda t: t.numpy(), params)
    np_save_file(mimi_torch_state(jmimi, tree), str(out / "mimi.safetensors"))
    return out


def serve(monkeypatch, root: Path, missing=(), alias=None):
    """Both packages' hub download serving `root`; each call is logged as
    (repo, filename, revision), a name in `missing` is not there, and one
    in `alias` is served from the file it names."""
    asked = []

    def download(repo, filename, revision=None):
        asked.append((repo, filename, revision))
        path = root / (alias or {}).get(filename, filename)
        if filename in missing or not path.exists():
            raise FileNotFoundError(f"{repo}/{filename}")
        return str(path)

    for mod in (tl, jl):
        monkeypatch.setattr(mod, "_hf_hub_download", download)
    return asked


def same_info(t, j):
    for name in INFO_FIELDS:
        assert getattr(t, name) == getattr(j, name), name
    assert {k: Path(v) for k, v in t.paths.items()} == \
        {k: Path(v) for k, v in j.paths.items()}


def test_hf_get_forms(repo, monkeypatch, tmp_path):
    """A Path as it is, file:// stripped, a plain name local, a name in a
    local directory, an existing file kept with check_local_file_exists,
    hf://org/repo/path and a name in a hub repository downloaded: the same
    paths as JAX's hf_get."""
    asked = serve(monkeypatch, repo)
    f = tmp_path / "weights.safetensors"
    f.write_bytes(b"x")
    cases = [(f,), (f"file://{f}",), (str(f),), ("config.json", str(repo)),
             (str(f), "kyutai/nope", True), (f"hf://{REPO}/config.json",),
             ("tokenizer.model", REPO)]
    for args in cases:
        assert tl.hf_get(*args) == jl.hf_get(*args), args
    assert tl.hf_get("tokenizer.model", REPO, revision="v1") == repo / "tokenizer.model"
    assert asked[-1] == (REPO, "tokenizer.model", "v1")
    assert [a[:2] for a in asked].count((REPO, "config.json")) == 2


def test_from_hf_repo_matches_jax(repo, monkeypatch, tmp_path):
    """The whole repository, then per-file overrides (an hf:// LM from
    another repository, a local tokenizer, an explicit Mimi config): the
    fields of JAX's CheckpointInfo, and the port loads the same weights
    as from the local directory."""
    asked = serve(monkeypatch, repo)
    t = tl.CheckpointInfo.from_hf_repo(REPO, revision="main")
    same_info(t, jl.CheckpointInfo.from_hf_repo(REPO, revision="main"))
    assert (REPO, "config.json", "main") in asked and t.root is None
    assert set(t.paths) == {"moshi", "mimi", "tokenizer", "mimi_config"}
    local = tl.CheckpointInfo.from_dir(repo)
    for get in ("get_moshi", "get_mimi"):
        (_, got), (_, want) = (getattr(i, get)(device="cpu") for i in (t, local))
        assert_same_tree(got, want)
    tok = tmp_path / "tok.model"
    tok.write_bytes((repo / "tokenizer.model").read_bytes())
    over = dict(moshi_weights="hf://other/repo/model.native.safetensors", tokenizer=str(tok),
                mimi_config_path=str(repo / "mimi_config.json"))
    t = tl.CheckpointInfo.from_hf_repo(REPO, **over)
    same_info(t, jl.CheckpointInfo.from_hf_repo(REPO, **over))
    assert ("other/repo", "model.native.safetensors", None) in asked
    assert t.paths["tokenizer"] == tok and t.get_text_tokenizer() is not None


def test_from_hf_repo_legacy_repository(repo, monkeypatch):
    """No config.json: a warning, then the Moshi-7B layout's file names,
    as in the JAX package (each served here from the tiny files)."""
    serve(monkeypatch, repo, missing=("config.json",),
          alias={"model.safetensors": "model.native.safetensors",
                 "tokenizer-e351c8d8-checkpoint125.safetensors": "mimi.safetensors",
                 "tokenizer_spm_32k_3.model": "tokenizer.model"})
    with pytest.warns(UserWarning, match="no config.json"):
        t = tl.CheckpointInfo.from_hf_repo("kyutai/legacy")
    with pytest.warns(UserWarning, match="no config.json"):
        j = jl.CheckpointInfo.from_hf_repo("kyutai/legacy")
    assert t.lm_config is None and t.moshi_name == "model.safetensors"
    assert t.paths["moshi"] == repo / "model.native.safetensors"
    same_info(t, j)


def test_reference_toml_hf_paths_and_hf_repo_module(repo, monkeypatch):
    """A reference `Mimi` module whose audio tokenizer is an hf:// path
    (its mimi_config.json beside it), and a native `mimi` module from
    `hf_repo`: both packages resolve the same files, and both modules
    build with the repository's Mimi weights."""
    serve(monkeypatch, repo)
    cfg = tomllib.loads(f"""
[modules.mimi]
type = "Mimi"
send_path = "/api/mimi_send"
recv_path = "/api/mimi_recv"
audio_tokenizer_file = "hf://{REPO}/mimi.safetensors"
""")
    m = cfg["modules"]["mimi"]
    tmod, jmod = tcompat.translate_module("mimi", m), jcompat.translate_module("mimi", m)
    tinfo = tcompat.inline_checkpoint_info(tmod["_inline"])
    assert tinfo.paths == {k: Path(v) for k, v in jcompat.inline_checkpoint_info(
        jmod["_inline"]).paths.items()}
    assert tinfo.paths["mimi_config"] == repo / "mimi_config.json"
    _, want = tl.CheckpointInfo.from_dir(repo).get_mimi(device="cpu")
    for mcfg in (m, {"type": "mimi", "route": "/api/mimi", "hf_repo": REPO}):
        route, handler, _, info = tworker.build_module("mimi", mcfg, seed=0, device="cpu")
        assert route in ("/api/mimi_send", "/api/mimi") and callable(handler)
        assert_same_tree(info["state"].params, want, rtol=1e-6)


def test_run_tts_hub_voices(repo, monkeypatch, tmp_path):
    """run_tts's simple mode with an hf:// voice and a voice named in a hub
    `--voice-repo`: the same PCM as the two voice files given as paths;
    the default `--voice-repo` is the JAX package's hub repository."""
    voices = repo / "voices"
    base = ["--device", "cpu", "--checkpoint-dir", str(repo), "--temp", "0",
            "--text", WORDS, "--text", "w7 w8"]
    local = trun.main([*base, "--voice", str(voices / "alice.abc@1.safetensors"),
                       "--voice", str(voices / "bob.abc@1.safetensors"),
                       str(tmp_path / "local")])
    asked = serve(monkeypatch, voices)
    hub = trun.main([*base, "--voice-repo", "kyutai/tts-voices", "--voice",
                     "hf://kyutai/other-voices/alice", "--voice", "bob", str(tmp_path / "hub")])
    assert [a[:2] for a in asked] == [("kyutai/other-voices", "alice.abc@1.safetensors"),
                                      ("kyutai/tts-voices", "bob.abc@1.safetensors")]
    assert len(hub) == len(local) == 2
    for a, b in zip(hub, local):
        np.testing.assert_array_equal(taudio.read_wav(a)[0], taudio.read_wav(b)[0])
    assert trun.DEFAULT_DSM_TTS_VOICE_REPO == jrun.DEFAULT_DSM_TTS_VOICE_REPO
