"""The port's worker (serve/worker.py) held against the JAX package's on one
TOML in both schemas, on the CPU: a native-schema `batched_asr` module over
a checkpoint directory, and a verbatim reference moshi-server TOML
(`type = "BatchedAsr"`, `path`, explicit PyTorch-named files from
scripts/export_torch.py, the architecture inline in `[modules.asr.model]`;
tests/test_worker.py's drop-in test without its fixture).  Each schema's
app, built by each package's `build_app`, gives the same ASR messages, and
`translate_config` the same dicts; so do the inline rust model tables
(`models/rust_config.py`) and the serving overrides' quantized bytes.
Also: auth (401 without the key),
`/api/modules_info`, `/metrics`, `/api/build_info`, a drain (503 for a new
session while an open one finishes), a `py` / `py_post` module, the keys
not ported yet, the fleet's type and keys reaching their builders, and the
CLI's refusal of `cuda` without a card."""

import asyncio
import os
import signal
import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from safetensors.numpy import load_file, save_file

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import export_torch  # noqa: E402
from moshi_tpu.models.loaders import CheckpointInfo as JInfo  # noqa: E402
from moshi_tpu.serve import toml_compat as jcompat  # noqa: E402
from moshi_tpu.serve import worker as jworker  # noqa: E402
from moshi_tpu_torch.models import asr as tasr  # noqa: E402
from moshi_tpu_torch.serve import toml_compat as tcompat  # noqa: E402
from moshi_tpu_torch.serve import worker as tworker  # noqa: E402
from moshi_tpu_torch.serve.metrics import OPEN_CHANNELS  # noqa: E402
from test_torch_batched_transport import (ASR_COND, ASR_ROUTE, COND_DELAY, DELAY,  # noqa: E402
                                          PRS_TOL,
                                          asr_lm_config, asr_pcm, drain, lockstep, recv,
                                          same_streams, write_asr_checkpoint)
from test_torch_checkpoint import mimi_torch_state  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KEY = {"kyutai-api-key": "tok"}


@pytest.fixture(scope="module")
def asr_ckpt(tmp_path_factory):
    return write_asr_checkpoint(tmp_path_factory.mktemp("asr"))


def native_toml(ckpt) -> dict:
    return tomllib.loads(f"""
authorized_ids = ["tok"]

[modules.asr]
type = "batched_asr"
route = "{ASR_ROUTE}"
checkpoint_dir = "{ckpt}"
batch_size = 2
asr_delay_in_tokens = {DELAY}
""")


def reference_toml(ckpt, out: Path) -> dict:
    """The checkpoint as a reference deployment ships it: the LM and the
    Mimi as PyTorch-named safetensors (the delay conditioner's tensors in
    the LM's file), the Mimi's config beside it, the architecture inline."""
    out.mkdir(exist_ok=True)
    info = JInfo.from_dir(ckpt)
    jlm, jlm_params = info.get_moshi()
    state = export_torch.lm_params_to_torch_state(jlm, jlm_params)
    native = load_file(str(ckpt / "model.native.safetensors"))
    state.update({k: v for k, v in native.items() if k.startswith("condition_provider.")})
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, str(out / "lm.safetensors"))
    jmimi, jmimi_params = info.get_mimi()
    save_file({k: np.ascontiguousarray(v) for k, v in
               mimi_torch_state(jmimi, jax.device_get(jmimi_params)).items()},
              str(out / "mimi.safetensors"))
    (out / "mimi_config.json").write_text((ckpt / "mimi_config.json").read_text())
    c = asr_lm_config()
    return tomllib.loads(f"""
static_dir = "/nonexistent"
log_dir = "/tmp/worker-logs"
instance_name = "worker"
authorized_ids = ["tok"]

[modules.asr]
type = "BatchedAsr"
path = "{ASR_ROUTE}"
lm_model_file = "{out}/lm.safetensors"
text_tokenizer_file = "{ckpt}/tokenizer.model"
audio_tokenizer_file = "{out}/mimi.safetensors"
asr_delay_in_tokens = {DELAY}
batch_size = 2
conditioning_delay = {COND_DELAY}

[modules.asr.model]
text_in_vocab_size = {c.text_card + 1}
text_out_vocab_size = {c.text_card}
audio_vocab_size = {c.card + 1}
audio_codebooks = {c.n_q}

[modules.asr.model.extra_heads]
num_heads = {c.extra_heads_num_heads}
dim = {c.extra_heads_dim}

[modules.asr.model.transformer]
d_model = {c.dim}
num_heads = {c.num_heads}
num_layers = {c.num_layers}
dim_feedforward = {int(c.hidden_scale * c.dim)}
causal = true
norm_first = true
bias_ff = false
bias_attn = false
context = {c.context}
max_period = 10000
use_conv_block = false
use_conv_bias = true
gating = "silu"
norm = "RmsNorm"
positional_embedding = "Rope"
conv_layout = false
conv_kernel_size = 3
kv_repeat = 1
max_seq_len = 4096

[modules.asr.model.conditioners.delay]
type = "ContinuousAttribute"
dim = {ASR_COND["dim"]}
scale_factor = {ASR_COND["scale_factor"]}
max_period = {ASR_COND["max_period"]}
""")


async def served(app, fn):
    async with TestClient(TestServer(app)) as client:
        return await fn(client)


async def asr_session(client):
    """One client in lockstep: 14 frames with markers before frames 2 and 7."""
    ws = await client.ws_connect(ASR_ROUTE, headers=KEY)
    out = [await recv(ws)]
    await lockstep(ws, asr_pcm(14, 96, 7), "msgpack", markers=(2, 7), out=out)
    await drain(ws, out)
    await ws.close()
    return {"session": out}


MIN_MARGIN = 0.02  # the least top-2 gap of a greedy text choice, over the top logit
PRS_TOL_BF16 = 2e-2  # extra-head probabilities over bf16 weights, torch against XLA


@pytest.mark.parametrize("schema", ["native", "reference"])
def test_worker_asr_matches_jax(schema, asr_ckpt, tmp_path, monkeypatch):
    """Each package's build_app over the same TOML serves the same
    messages; the reference schema's TOML translates to equal dicts in
    both packages.  The reference schema loads the LM in bf16, which
    torch and XLA round apart: every greedy text choice of the port's run
    keeps a gap of MIN_MARGIN (5 bf16 steps) to the runner-up, so the two
    runs may be held equal; their extra-head probabilities within
    PRS_TOL_BF16."""
    cfg = (native_toml(asr_ckpt) if schema == "native"
           else reference_toml(asr_ckpt, tmp_path / "reference"))
    if schema == "reference":
        got_cfg, want_cfg = tcompat.translate_config(cfg), jcompat.translate_config(cfg)
        assert got_cfg == want_cfg
        assert got_cfg["modules"]["asr"]["type"] == "batched_asr"
    gaps = []
    sample = tasr.sample_token

    def recording(generator, logits, **kw):
        top = logits.float().topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]) / top[:, 0].abs()
        gaps.append(float(gap[gap.isfinite()].min()))  # a frozen fresh slot's row is NaN
        return sample(generator, logits, **kw)

    monkeypatch.setattr(tasr, "sample_token", recording)
    got = asyncio.run(served(tworker.build_app(cfg, device="cpu"), asr_session))
    assert min(gaps[-14:]) >= MIN_MARGIN
    want = asyncio.run(served(jworker.build_app(cfg), asr_session))
    same_streams(got, want, PRS_TOL if schema == "native" else PRS_TOL_BF16)
    kinds = [m["type"] for m in got["session"]]
    assert kinds[0] == "Ready" and kinds.count("Marker") == 2 and "Step" in kinds


RUST_MOSHI = {"text_in_vocab_size": 48001, "text_out_vocab_size": 48000,
              "audio_vocab_size": 2049, "audio_codebooks": 16,
              "transformer": {"d_model": 2048, "num_heads": 16, "num_layers": 16,
                              "dim_feedforward": 8192, "causal": True, "context": 3000,
                              "max_period": 100000, "gating": "silu", "norm": "RmsNorm",
                              "positional_embedding": "Rope", "kv_repeat": 1},
              "depformer": {"num_slices": 8,
                            "transformer": {"d_model": 1024, "num_heads": 16,
                                            "num_layers": 6, "dim_feedforward": 4096,
                                            "gating": "silu", "norm": "RmsNorm",
                                            "positional_embedding": "None"}}}
RUST_GEN = {"acoustic_delay": 2, "text_pad_token": 3, "text_eop_token": 0}


@pytest.mark.parametrize("table", ["asr", "moshi"])
def test_rust_model_tables_match_jax(table, asr_ckpt, tmp_path):
    """An inline rust model table (the reference TOML's ASR one, and a
    Moshi-like one with a depformer and a `gen` table) gives the JAX
    package's LmConfig, field for field."""
    from moshi_tpu.models import rust_config as jrust
    from moshi_tpu_torch.models import rust_config as trust
    from test_torch_port import port_lm_config
    if table == "asr":
        model = dict(reference_toml(asr_ckpt, tmp_path)["modules"]["asr"]["model"])
        model.pop("conditioners")
        gen = None
    else:
        model, gen = RUST_MOSHI, RUST_GEN
    got = trust.lm_config_from_rust_dict(model, gen)
    assert got == port_lm_config(jrust.lm_config_from_rust_dict(model, gen))


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_serving_overrides_match_jax(weights):
    """apply_serving_overrides on the same f32 LM and Mimi trees: the
    quantized leaves byte-equal to the JAX package's (its rules, its bytes),
    the KV cache and context overrides in the config, the Mimi cast to
    bf16."""
    import jax.numpy as jnp
    import torch
    from moshi_tpu.models.lm import LMModel as JLM
    from moshi_tpu.utils.serving import apply_serving_overrides as japply
    from moshi_tpu_torch.models.lm import LMModel
    from moshi_tpu_torch.utils.params import from_jax
    from moshi_tpu_torch.utils.quantize import QTensor, QTensor4
    from moshi_tpu_torch.utils.serving import apply_serving_overrides
    from test_torch_port import port_lm_config

    jcfg = asr_lm_config()
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dim": 256, "num_heads": 4})
    params = LMModel(port_lm_config(jcfg)).init_params(torch.Generator().manual_seed(0),
                                                      torch.float32)
    mimi = {"w": torch.ones(3, 2), "codes": torch.arange(3)}

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        return jnp.asarray(t.numpy())

    lm, qparams, qmimi, md = apply_serving_overrides(
        LMModel(port_lm_config(jcfg)), params, mimi, kv_cache="int8", context=8,
        weights=weights, mimi_dtype="bf16")
    jlm, jparams, jmimi, _ = japply(JLM(jcfg), to_jax(params), to_jax(mimi), kv_cache="int8",
                                    context=8, weights=weights, mimi_dtype="bf16")
    assert (lm.config.kv_cache_dtype, lm.config.context) == ("int8", 8) == \
        (jlm.config.kv_cache_dtype, jlm.config.context)
    assert md == torch.bfloat16 and qmimi["w"].dtype == torch.bfloat16
    assert qmimi["codes"].dtype == torch.int64
    want = from_jax(jax.device_get(jparams))
    quantized = []

    def same(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (QTensor, QTensor4)):
            assert type(a) is type(b), path
            quantized.append(path)
            for x, y in ((a.q, b.q), (a.scale, b.scale)):
                assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert torch.equal(a, b), path

    same(qparams, want)
    assert quantized


def test_worker_endpoints_auth_and_drain(asr_ckpt, monkeypatch):
    """401 without the key (header or auth_id); modules_info, metrics and
    build_info; a drain answers 503 to a new session while the open one
    goes on, and the idle watcher then stops the server."""
    fired = []
    monkeypatch.setattr(signal, "raise_signal", lambda sig: fired.append(sig))
    app = tworker.build_app(native_toml(asr_ckpt), drain_timeout=30.0, device="cpu")
    OPEN_CHANNELS.set(0)

    async def run(client):
        r = await client.get("/api/modules_info")
        assert r.status == 401
        r = await client.get("/api/modules_info", params={"auth_id": "tok"})
        assert await r.json() == {"asr": {"type": "batched_asr", "batch_size": 2,
                                          "route": ASR_ROUTE}}
        assert (await client.get("/metrics")).status == 200
        info = await (await client.get("/api/build_info")).json()
        assert info["framework"] == "moshi_tpu_torch"
        with pytest.raises(Exception):
            await client.ws_connect(ASR_ROUTE)

        ws = await client.ws_connect(ASR_ROUTE, headers=KEY)
        out = [await recv(ws)]
        pcm = asr_pcm(4, 96, 3)
        await lockstep(ws, pcm[:2], "msgpack", out=out)
        assert (await client.post("/api/drain")).status == 401
        r = await client.post("/api/drain", headers=KEY)
        assert (await r.json()) == {"draining": True, "open": 1.0}
        assert (await client.get(ASR_ROUTE, headers=KEY)).status == 503
        assert (await client.get("/metrics")).status == 200
        await lockstep(ws, pcm[2:], "msgpack", out=out)   # the open session goes on
        assert not fired
        await ws.close()
        for _ in range(100):
            if fired:
                break
            await asyncio.sleep(0.05)
        return out

    out = asyncio.run(served(app, run))
    assert [m["type"] for m in out].count("Step") == 4
    assert fired == [signal.SIGINT]


PLUGIN = '''
import asyncio
from aiohttp import web


class App:
    def __init__(self, batch_size, config):
        self.batch_size, self.config = batch_size, config
        self.warmed, self.ticks = False, 0

    def warmup(self):
        self.warmed = True

    async def run_loop(self):
        while True:
            self.ticks += 1
            await asyncio.sleep(0.01)

    async def handle(self, request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        await ws.send_json({"greeting": self.config["greeting"],
                            "batch_size": self.batch_size, "warmed": self.warmed})
        await ws.close()
        return ws

    async def handle_post(self, request):
        return web.json_response({"echo": await request.json(), "ticks": self.ticks})


def init(batch_size, config):
    return App(batch_size, config)
'''


def test_py_modules(tmp_path):
    """A user script's `py` module (a websocket on GET, its config and
    batch size passed to init, warmed up) and `py_post` module (POST, its
    run_loop started with the server), in the native and the reference
    schema."""
    script = tmp_path / "plugin.py"
    script.write_text(PLUGIN)
    cfg = tomllib.loads(f"""
[modules.custom]
type = "py"
route = "/api/custom"
script = "{script}"
batch_size = 4
[modules.custom.config]
greeting = "hi"

[modules.post]
type = "PyPost"
path = "/api/custom-post"
script = "{script}"
""")

    async def run(client):
        ws = await client.ws_connect("/api/custom")
        hello = await ws.receive_json()
        await ws.close()
        await asyncio.sleep(0.1)
        r = await client.post("/api/custom-post", json={"x": 1})
        return hello, await r.json()

    hello, posted = asyncio.run(served(tworker.build_app(cfg, device="cpu"), run))
    assert hello == {"greeting": "hi", "batch_size": 4, "warmed": True}
    assert posted["echo"] == {"x": 1} and posted["ticks"] > 0


@pytest.mark.parametrize("module", [
    {"type": "moshi", "tp": 2}, {"type": "batched_asr", "hf_repo": "kyutai/stt"}],
    ids=lambda m: "-".join(map(str, m.values()))[:40])
def test_not_ported_types_and_keys_raise(module, monkeypatch):
    """The module key the worker does not build yet (`tp`) raises
    NotImplementedError naming its ROADMAP item, before loading anything;
    an `hf_repo` module is built from the hub repository (the download
    stubbed here to raise with what it was asked: config.json first, then
    the LM's file of a legacy repository)."""
    from moshi_tpu_torch.models import loaders as tl

    asked = []

    def download(repo, filename, revision=None):
        asked.append((repo, filename))
        raise Taken(repo, filename)

    monkeypatch.setattr(tl, "_hf_hub_download", download)
    if "hf_repo" in module:
        mcfg = {"route": "/api/x", **module}
        with pytest.warns(UserWarning, match="no config.json"), pytest.raises(Taken):
            tworker.build_module("m", mcfg, seed=0, device="cpu")
        assert asked == [("kyutai/stt", "config.json"), ("kyutai/stt", "model.safetensors")]
        return
    mcfg = {"route": "/api/x", "checkpoint_dir": "/nonexistent", **module}
    with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
        tworker.build_module("m", mcfg, seed=0, device="cpu")


class Taken(Exception):
    """Raised by the stand-ins in this file with the arguments they were
    given."""


@pytest.mark.parametrize("module", [
    {"type": "py_batched_asr", "script": "s.py", "batch_size": 2, "asr_delay_in_tokens": 2},
    {"type": "PyBatchedAsr", "path": "/p", "script": "s.py", "batch_size": 2,
     "text_tokenizer_file": "y", "asr_delay_in_tokens": 2},
    {"type": "moshi", "vault_url": "http://v"}, {"type": "moshi", "fleet_auth": "k"},
    {"type": "moshi", "log_dir": "/tmp/logs"}], ids=lambda m: "-".join(map(str, m.values()))[:40])
def test_worker_takes_fleet_types_and_keys(module, monkeypatch):
    """The module types and keys that were refused until the fleet was
    ported: `py_batched_asr` (native or the reference's `PyBatchedAsr`)
    reaches build_py_batched_asr with its table, and a `moshi` module's
    `vault_url`, `fleet_auth`, `replicate_every` and `log_dir` reach
    ServerState."""
    from moshi_tpu_torch.models import loaders
    from moshi_tpu_torch.serve import py_basr, server
    from moshi_tpu_torch.utils import serving

    class Info:
        lm_gen_config = {}

        def get_text_tokenizer(self):
            return None

        def get_mimi(self, device):
            return None, None

        def get_moshi(self, device):
            return None, None

    def take(*args, **kwargs):
        raise Taken(args, kwargs)

    monkeypatch.setattr(loaders.CheckpointInfo, "from_dir", staticmethod(lambda d: Info()))
    monkeypatch.setattr(serving, "override_lm", lambda lm, *_: lm)
    monkeypatch.setattr(server, "ServerState", take)
    monkeypatch.setattr(py_basr, "build_py_batched_asr", take)
    mcfg = {"route": "/api/x", "checkpoint_dir": "/nonexistent", **module}
    tworker._refuse_not_ported("m", mcfg)
    with pytest.raises(Taken) as got:
        tworker.build_module("m", mcfg, seed=0, device="cpu")
    args, kwargs = got.value.args
    if module["type"] == "moshi":
        key = next(k for k in module if k != "type")
        assert kwargs[key] == module[key] and kwargs["replicate_every"] == 125
        assert {"vault_url", "fleet_auth", "log_dir"} <= set(kwargs)
    else:
        name, table = args
        assert name == "m" and table["type"] == "py_batched_asr" and table["script"] == "s.py"
        assert table["batch_size"] == 2 and table["asr_delay_in_tokens"] == 2


def test_worker_refuses_cuda_without_a_card(tmp_path):
    config = tmp_path / "worker.toml"
    config.write_text("[modules]\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "moshi_tpu_torch.serve.worker",
                           "--config", str(config)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
