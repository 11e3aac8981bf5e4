"""The port's text-to-speech entry points over tiny checkpoints held
against the JAX package's, on the CPU in f32 with greedy decoding:
`run_tts` and `build_tts_from_info` on checkpoints the port writes and
both packages read (voices by name, an audio prefix), and the worker's
`tts`, `batched_tts` and `mimi` modules from a native TOML and from the
reference `Tts` / `Mimi` schema.  The engines and sockets are in
tests/test_torch_tts_serve.py, whose helpers these tests share.

Tolerances, as the JAX package's own batched-against-single test: token
streams and word events (text and start_s) equal, PCM within PCM_TOL."""

import asyncio
import json
import sys
import tomllib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp import WSMsgType
from aiohttp.test_utils import TestClient, TestServer
from safetensors.numpy import save_file as np_save_file

from moshi_tpu import audio as jaudio
from moshi_tpu import run_tts as jrun
from moshi_tpu.models.loaders import CheckpointInfo as JInfo
from moshi_tpu.serve import batched_tts as jbt
from moshi_tpu.serve import worker as jworker
from moshi_tpu_torch import conditioners as tc
from moshi_tpu_torch import run_tts as trun
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.models.loaders import CheckpointInfo
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.models.native_ckpt import flatten_tree, save_mimi_params
from moshi_tpu_torch.serve import batched_tts as tbt
from moshi_tpu_torch.serve import tts_ws as tws
from moshi_tpu_torch.serve import worker as tworker
from moshi_tpu_torch.text.spm import spm_model_bytes
from moshi_tpu_torch.utils.safetensors import save_file
from test_lm import tiny_lm_config
from test_torch_batched_transport import _jsonable
from test_torch_port import max_abs, port_lm_config

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import export_torch  # noqa: E402
from test_torch_checkpoint import mimi_torch_state  # noqa: E402
from test_torch_lora import one_thread  # noqa: E402, F401  (autouse)
from test_torch_tts_serve import (PCM_TOL, RECV_TIMEOUT, ROUTE, VOICE_D, VOICE_T,  # noqa: E402
                                  _drain_jax, _drain_port, _voice, record_jax_tokens,
                                  record_port_tokens, same_session, script, tts_client)


# ------------------------------------------------------------- checkpoints
MODEL_ID = {"sig": "abc", "epoch": 1}   # voice files end ".abc@1.safetensors"
WORDS = "w10 w21 w32 w43"               # whole pieces of the synthetic tokenizer


def tts_config(voiced: bool):
    return tiny_lm_config(n_q=2, dep_q=2, delays=(0, 0, 1), cross_attention=voiced)


def write_tts_checkpoint(out: Path, voiced: bool, distilled: bool = False) -> Path:
    """A native TTS checkpoint written by the port from seeded f32 weights:
    the tiny greedy model (with cross-attention and a `speaker_wavs`
    conditioner when voiced, and a `cfg` LUT condition summed into the
    inputs when distilled, their tensors in the LM's file under their
    PyTorch names), the 1200 Hz Mimi of the batched transports' tests, a
    synthetic tokenizer, config.json with tts_config and model_id; and,
    voiced, a voice directory of two voices."""
    from test_torch_batched_transport import ASR_MIMI
    from moshi_tpu_torch.models.loaders import mimi_config_from_dict

    out.mkdir(parents=True, exist_ok=True)
    jcfg = tts_config(voiced)
    g = torch.Generator().manual_seed(3)
    params = TLM(port_lm_config(jcfg)).init_params(g, torch.float32)
    flat = flatten_tree(params)
    config = {**_jsonable(jcfg), "model_type": "tts", "model_id": MODEL_ID,
              "tts_config": {"audio_delay": 2 / 12.5, "max_speakers": 1}}
    if voiced:
        cp = tc.TensorConditioner(output_dim=jcfg.dim, dim=VOICE_D).init_params(g)
        prefix = "condition_provider.conditioners.speaker_wavs"
        flat[f"{prefix}.output_proj.weight"] = cp["output_proj"].t().contiguous()
        flat[f"{prefix}.learnt_padding"] = cp["learnt_padding"]
        conds = {"speaker_wavs": {"type": "tensor", "tensor": {"dim": VOICE_D}}}
        fuser = {"cross": ["speaker_wavs"]}
        if distilled:
            conds["cfg"] = {"type": "lut", "lut": {"n_bins": 3, "dim": 8, "tokenizer": "noop",
                                                   "possible_values": ["1.0", "2.0", "3.0"]}}
            fuser["sum"] = ["cfg"]
            lut = tc.conditioners_from_config(jcfg.dim, {"cfg": conds["cfg"]}).conditioners[
                "cfg"].init_params(g)
            prefix = "condition_provider.conditioners.cfg"
            flat[f"{prefix}.embed.weight"] = lut["embed"]
            flat[f"{prefix}.output_proj.weight"] = lut["output_proj"].t().contiguous()
            flat[f"{prefix}.learnt_padding"] = lut["learnt_padding"]
        config.update(conditioners=conds, fuser=fuser)
        voices = out / "voices"
        voices.mkdir(exist_ok=True)
        for i, name in enumerate(("alice", "bob")):
            emb = _voice(10 + i)[None].transpose(0, 2, 1)   # stored [1, D, T]
            save_file({"speaker_wavs": torch.from_numpy(np.ascontiguousarray(emb))},
                      voices / f"{name}.abc@1.safetensors")
    save_file(flat, out / "model.native.safetensors")
    mimi = TMimi(mimi_config_from_dict(ASR_MIMI, 2))
    save_mimi_params(out / "mimi.native.safetensors", mimi, mimi.init_params(g))
    (out / "mimi_config.json").write_text(json.dumps(ASR_MIMI))
    (out / "tokenizer.model").write_bytes(spm_model_bytes(jcfg.text_card))
    config.update(moshi_name="model.native.safetensors", mimi_name="mimi.native.safetensors",
                  mimi_config_name="mimi_config.json", tokenizer_name="tokenizer.model",
                  native_format=True)
    (out / "config.json").write_text(json.dumps(config))
    return out


@pytest.fixture(scope="module")
def voiced_ckpt(tmp_path_factory):
    return write_tts_checkpoint(tmp_path_factory.mktemp("tts_voiced"), True)


@pytest.fixture(scope="module")
def distilled_ckpt(tmp_path_factory):
    return write_tts_checkpoint(tmp_path_factory.mktemp("tts_distilled"), True, True)


@pytest.fixture(scope="module")
def plain_ckpt(tmp_path_factory):
    return write_tts_checkpoint(tmp_path_factory.mktemp("tts_plain"), False)


def run_both(monkeypatch, args: list[str], outdir: Path):
    """The port's run_tts main (on the CPU) and the JAX package's on the same
    arguments, each into its own directory: (port wavs, JAX wavs)."""
    tpaths = trun.main(["--device", "cpu", *args, str(outdir / "port")])
    monkeypatch.setattr(sys, "argv", ["run_tts", *args, str(outdir / "jax")])
    jrun.main()
    jpaths = sorted((outdir / "jax").glob("tts-*.wav"))
    assert [p.name for p in tpaths] == [p.name for p in jpaths] and tpaths
    return ([jaudio.read_wav(p)[0][0] for p in tpaths],
            [jaudio.read_wav(p)[0][0] for p in jpaths])


def same_pcm(got, want):
    assert [len(p) for p in got] == [len(p) for p in want] and all(len(p) for p in got)
    for a, b in zip(got, want):
        assert max_abs(a, b) <= PCM_TOL


def serve_hub(monkeypatch, root: Path):
    """Both packages' hub download replaced by one that serves `root` (a
    repository's files by name, whatever the repository)."""
    from moshi_tpu.models import loaders as jloaders
    from moshi_tpu_torch.models import loaders as tloaders

    def download(repo, filename, revision=None):
        path = root / filename
        if not path.exists():
            raise FileNotFoundError(f"{repo}/{filename}")
        return str(path)

    for mod in (jloaders, tloaders):
        monkeypatch.setattr(mod, "_hf_hub_download", download)


def test_build_tts_from_info_matches_jax(voiced_ckpt, monkeypatch):
    tt, tp, tm, tcp = trun.build_tts_from_info(CheckpointInfo.from_dir(voiced_ckpt),
                                               voice_repo=str(voiced_ckpt / "voices"),
                                               device="cpu")
    jt, *_ = jrun.build_tts_from_info(JInfo.from_dir(voiced_ckpt),
                                      voice_repo=str(voiced_ckpt / "voices"))
    assert (tt.delay_steps, tt.max_speakers, tt.voice_suffix, tt.n_q, tt.temp) == (
        jt.delay_steps, jt.max_speakers, jt.voice_suffix, jt.n_q, jt.temp) == (
        2, 1, ".abc@1.safetensors", 2, 0.6)
    assert tt.multi_speaker and set(tcp) == {"speaker_wavs"}
    assert tt.get_voice_path("alice") == jt.get_voice_path("alice") == \
        voiced_ckpt / "voices" / "alice.abc@1.safetensors"
    np.testing.assert_array_equal(tt.load_voice_embedding(tt.get_voice_path("bob")),
                                  jt.load_voice_embedding(jt.get_voice_path("bob")))
    serve_hub(monkeypatch, voiced_ckpt / "voices")
    assert tt.get_voice_path("hf://kyutai/tts-voices/alice") == \
        jt.get_voice_path("hf://kyutai/tts-voices/alice") == \
        voiced_ckpt / "voices" / "alice.abc@1.safetensors"


def test_run_tts_simple_mode_matches_jax(voiced_ckpt, tmp_path, monkeypatch):
    """Greedy simple mode, two texts in two voices, one an hf:// name
    fetched from the hub (both packages' download served from the voice
    directory), one named in the local voice directory: the port's wavs are
    JAX's."""
    serve_hub(monkeypatch, voiced_ckpt / "voices")
    args = ["--checkpoint-dir", str(voiced_ckpt), "--temp", "0", "--voice-repo",
            str(voiced_ckpt / "voices"), "--text", WORDS, "--text", "w7 w8",
            "--voice", "hf://kyutai/tts-voices/alice", "--voice", "bob"]
    same_pcm(*run_both(monkeypatch, args, tmp_path))


def test_run_tts_jsonl_matches_jax(voiced_ckpt, tmp_path, monkeypatch):
    """The JSONL mode, turns with voice files, greedy: the wavs and the
    --debug-json transcripts are JAX's."""
    voices = voiced_ckpt / "voices"
    lines = [{"turns": [WORDS, "w3 w4"], "voices": [str(voices / "alice.abc@1.safetensors")]},
             {"text": "w50 w51 w52", "voices": [str(voices / "bob.abc@1.safetensors")]}]
    infile = tmp_path / "script.jsonl"
    infile.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    base = ["--checkpoint-dir", str(voiced_ckpt), "--temp", "0", str(infile)]
    tpaths = trun.main(["--device", "cpu", "--debug-json", str(tmp_path / "t.json"), *base,
                        str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["run_tts", "--debug-json", str(tmp_path / "j.json"),
                                      *base, str(tmp_path / "jax")])
    jrun.main()
    same_pcm([jaudio.read_wav(p)[0][0] for p in tpaths],
             [jaudio.read_wav(tmp_path / "jax" / p.name)[0][0] for p in tpaths])
    got, want = (json.loads((tmp_path / n).read_text()) for n in ("t.json", "j.json"))
    assert got == want and len(got["transcripts"]) == 2 and got["transcripts"][0]


def test_run_tts_audio_prefix_matches_jax(plain_ckpt, tmp_path, monkeypatch):
    """A model without speaker conditioning takes its voice as an audio
    prefix, `file://x.wav`: read at the Mimi's rate, encoded, forced; the
    port's wav is JAX's."""
    wav = tmp_path / "voice.wav"
    jaudio.write_wav(wav, (0.3 * np.random.RandomState(5).randn(12 * 96)).astype(np.float32),
                     1200)
    args = ["--checkpoint-dir", str(plain_ckpt), "--temp", "0", "--text", WORDS,
            "--voice", f"file://{wav}"]
    same_pcm(*run_both(monkeypatch, args, tmp_path))


# ------------------------------------------------------------------ worker
def native_toml(ckpt: Path) -> dict:
    return tomllib.loads(f"""
[modules.tts]
type = "tts"
route = "/api/tts"
checkpoint_dir = "{ckpt}"
temp = 0.0
voice_dir = "{ckpt / 'voices'}"

[modules.batched]
type = "batched_tts"
route = "/api/tts_batched"
checkpoint_dir = "{ckpt}"
batch_size = 2
temp = 0.0
voice_dir = "{ckpt / 'voices'}"

[modules.mimi]
type = "mimi"
route = "/api/mimi"
checkpoint_dir = "{ckpt}"
rooms = ["room"]
""")


async def voiced_session(client, route: str, voice: np.ndarray) -> list:
    """A Voice message, words and Eos; the JSON messages up to Eos (audio
    counted as one "audio" entry per frame)."""
    ws = await client.ws_connect(route)
    ready = json.loads((await ws.receive(timeout=RECV_TIMEOUT)).data)
    assert ready["type"] == "Ready"
    await ws.send_str(json.dumps({"type": "Voice", "embeddings": voice.ravel().tolist(),
                                  "shape": list(voice.shape)}))
    for t in script(WORDS):
        await ws.send_str(t)
    out = []
    while not out or out[-1] != {"type": "Eos"}:
        m = await ws.receive(timeout=RECV_TIMEOUT)
        out.append("audio" if m.type == WSMsgType.BINARY else json.loads(m.data))
    await ws.close()
    return out


async def mimi_session(client, route: str, pcm: np.ndarray) -> tuple[bytes, bytes]:
    """PCM in two ragged chunks to the tokenizer socket: the codes reply,
    then the PCM reply to those codes."""
    ws = await client.ws_connect(route)
    data = pcm.astype(np.float32).tobytes()
    await ws.send_bytes(b"\x01" + data[:150])
    await ws.send_bytes(b"\x01" + data[150:] + b"\x00\x00")   # ragged: cut to whole floats
    codes = await ws.receive_bytes(timeout=RECV_TIMEOUT)
    await ws.send_bytes(b"\x09" + codes[1:])
    back = await ws.receive_bytes(timeout=RECV_TIMEOUT)
    await ws.close()
    return codes, back


def test_worker_native_toml_matches_jax(voiced_ckpt):
    """The worker's tts, batched_tts and mimi modules from one native TOML,
    built on the CPU by each package: a voiced session on each TTS route
    gives JAX's messages, the Mimi socket JAX's codes and PCM, and
    modules_info names the three."""
    cfg = native_toml(voiced_ckpt)
    voice = _voice(20)
    pcm = (0.3 * np.random.RandomState(6).randn(2 * 96 + 10)).astype(np.float32)

    async def drive(client):
        info = await (await client.get("/api/modules_info")).json()
        tts = await voiced_session(client, "/api/tts", voice)
        batched = await voiced_session(client, "/api/tts_batched", voice)
        codes = await mimi_session(client, "/api/mimi", pcm)
        return info, tts, batched, codes

    async def serve(app):
        async with TestClient(TestServer(app)) as client:
            return await drive(client)

    app = tworker.build_app(cfg, device="cpu")
    modules = app["modules"]
    assert isinstance(modules["tts"]["state"], tws.TTSStreamer)
    assert modules["batched"]["state"].voice_frames == VOICE_T
    got = asyncio.run(serve(app))
    want = asyncio.run(serve(jworker.build_app(cfg)))
    assert got[0] == {"tts": {"type": "tts", "route": "/api/tts"},
                      "batched": {"type": "batched_tts", "batch_size": 2,
                                  "route": "/api/tts_batched"},
                      "mimi": {"type": "mimi", "route": "/api/mimi"}}
    for g, w in zip(got[1:3], want[1:3]):
        words = [m["text"] for m in g if isinstance(m, dict) and m["type"] == "Text"]
        assert g == w and g.count("audio") > 5 and words == WORDS.split()
    assert got[3][0] == want[3][0] and len(got[3][0]) == 1 + 4 * 2 * 2
    assert max_abs(np.frombuffer(got[3][1][1:], np.float32),
                   np.frombuffer(want[3][1][1:], np.float32)) <= PCM_TOL


def test_worker_builds_cfg_above_16_rows(voiced_ckpt):
    """cfg_coef on a model without CFG distillation doubles the model batch:
    a batched_tts module of 9 slots builds with 18 model rows (its frames
    are held against JAX's in tests/test_torch_configs.py)."""
    mcfg = {"type": "batched_tts", "route": "/t", "checkpoint_dir": str(voiced_ckpt),
            "batch_size": 9, "cfg_coef": 2.0}
    _, _, _, info = tworker.build_module("tts", mcfg, seed=0, device="cpu")
    st = info["state"]
    assert (st.batch_size, st.mult, st.h.shape[0]) == (9, 2, 18)


async def two_voiced_sessions(st, drain, tokens):
    """Two greedy sessions side by side on a batched engine, each with its
    voice: (token rows [T, 2, 1 + dep_q], each slot's events, each slot's
    PCM frames)."""
    slots = [await st.acquire_slot() for _ in range(2)]
    for i, (b, words) in enumerate(zip(slots, (WORDS, "w7 w8 w9"))):
        st.set_slot_voice(b, _voice(30 + i))
        st.feed_words(b, [words])
        st.feed_eos(b)
    for _ in range(200):
        active = st.steppable()
        if not active:
            break
        st.step_batch(active)
    assert all(st.slots[b].done for b in slots)
    out = [([], []) for _ in slots]
    for b, (pcms, texts) in zip(slots, out):
        drain(b, pcms, texts)
    return np.stack(tokens)[:, slots], [t for _, t in out], [p for p, _ in out]


def test_distilled_cfg_is_the_voices_condition(distilled_ckpt):
    """On a CFG-distilled checkpoint the port's engine takes cfg_coef 2.0 as
    its voices' `cfg` condition, with the model batch undoubled (the
    deliberate difference from the JAX package's engine, which would run
    true CFG): greedy, it gives the tokens, words and PCM of the JAX
    package's engine made to the same semantics (LMGen's cfg_coef 1, the
    voices' attributes made with cfg 2.0); and not those of cfg_coef 1."""
    voices = str(distilled_ckpt / "voices")

    def port(cfg_coef):
        st = tbt.build_state(CheckpointInfo.from_dir(distilled_ckpt), batch_size=2,
                             device="cpu", temp=0.0, cfg_coef=cfg_coef, voice_dir=voices)
        tokens = []
        record_port_tokens(st, tokens)
        got = asyncio.run(two_voiced_sessions(
            st, lambda s, p, t: _drain_port(st, s, p, t), tokens))
        return st, got

    st, got = port(2.0)
    assert (st.mult, st.cfg_condition) == (1, 2.0)
    assert {a.text["cfg"] for a in st.slot_attrs} == {"2.0"}
    streamer = tws.build_streamer(CheckpointInfo.from_dir(distilled_ckpt), device="cpu",
                                  temp=0.0, cfg_coef=2.0, voice_dir=voices)
    assert (streamer.engine.mult, streamer.engine.cfg_condition) == (1, 2.0)
    # undoubled, 16 slots fit the GEMV kernels' rows
    assert tbt.build_state(CheckpointInfo.from_dir(distilled_ckpt), batch_size=16,
                           device="cpu", cfg_coef=2.0, voice_dir=voices).mult == 1

    jt, jp, jm, jcp = jrun.build_tts_from_info(JInfo.from_dir(distilled_ckpt), temp=0.0,
                                               voice_repo=voices)
    assert jt.cfg_coef == 1.0 and jt.valid_cfg_conditionings == {1.0, 2.0, 3.0}
    make_attrs = jt.make_condition_attributes
    jt.make_condition_attributes = lambda v, cfg_coef=None: make_attrs(v, 2.0)
    jst = jbt.BatchedTTSState(jt, jp, jm, batch_size=2, rng=jax.random.PRNGKey(2),
                              condition_params=jcp)
    jtokens = []
    record_jax_tokens(jst, jtokens)
    want = asyncio.run(two_voiced_sessions(
        jst, lambda s, p, t: _drain_jax(jst.slots[s], p, t), jtokens))
    np.testing.assert_array_equal(got[0], want[0])
    for b in range(2):
        same_session((got[0][:, b], got[1][b], got[2][b]),
                     (want[0][:, b], want[1][b], want[2][b]))
    assert [e["text"] for e in got[1][0]] == WORDS.split()
    _, plain = port(1.0)
    assert not (plain[0].shape == got[0].shape and np.array_equal(plain[0], got[0])
                and all(max_abs(a, b) <= PCM_TOL for a, b in zip(plain[2][0], got[2][0])))


def reference_toml(ckpt: Path, out: Path) -> dict:
    """The plain checkpoint as a reference moshi-server deployment ships it:
    PyTorch-named LM and Mimi files, the architecture inline, a `Tts` and
    a `Mimi` module."""
    out.mkdir(exist_ok=True)
    info = JInfo.from_dir(ckpt)
    jlm, jlm_params = info.get_moshi()
    np_save_file({k: np.ascontiguousarray(v) for k, v in
                  export_torch.lm_params_to_torch_state(jlm, jlm_params).items()},
                  str(out / "lm.safetensors"))
    jmimi, jmimi_params = info.get_mimi()
    np_save_file({k: np.ascontiguousarray(v) for k, v in
                  mimi_torch_state(jmimi, jax.device_get(jmimi_params)).items()},
                  str(out / "mimi.safetensors"))
    (out / "mimi_config.json").write_text((ckpt / "mimi_config.json").read_text())
    c = tts_config(False)
    return tomllib.loads(f"""
[modules.tts]
type = "Tts"
path = "{ROUTE}"
lm_model_file = "{out}/lm.safetensors"
text_tokenizer_file = "{ckpt}/tokenizer.model"
audio_tokenizer_file = "{out}/mimi.safetensors"
temp = 0.0

[modules.tts.generation]
acoustic_delay = 1
text_audio_delay_in_tokens = 2

[modules.tts.model]
text_in_vocab_size = {c.text_card + 1}
text_out_vocab_size = {c.text_card}
audio_vocab_size = {c.card + 1}
audio_codebooks = {c.n_q}

[modules.tts.model.transformer]
d_model = {c.dim}
num_heads = {c.num_heads}
num_layers = {c.num_layers}
dim_feedforward = {int(c.hidden_scale * c.dim)}
context = {c.context}
max_period = 10000
gating = "silu"
norm = "RmsNorm"
positional_embedding = "Rope"

[modules.tts.model.depformer]
num_slices = {c.dep_q}

[modules.tts.model.depformer.transformer]
d_model = {c.depformer_dim}
num_heads = {c.depformer_num_heads}
num_layers = {c.depformer_num_layers}
dim_feedforward = {c.depformer_dim_feedforward}
gating = "silu"
norm = "RmsNorm"
positional_embedding = "None"

[modules.mimi]
type = "Mimi"
send_path = "/api/mimi_send"
recv_path = "/api/mimi_recv"
audio_tokenizer_file = "{out}/mimi.safetensors"
rooms = ["room"]
default_room = "room"
""")


def test_worker_reference_toml(plain_ckpt, tmp_path):
    """A verbatim reference TOML with a `Tts` and a `Mimi` module: the TTS
    session gives the native checkpoint's words through the JAX package's
    worker on the same TOML; the room's listener gets the handshake and the
    producer's codes decoded, as a fresh codec state decodes them."""
    cfg = reference_toml(plain_ckpt, tmp_path / "ref")
    rs = np.random.RandomState(7)
    codes = rs.randint(0, 32, (3, 8)).astype(np.uint32)   # 3 frames x 8 codebooks

    async def drive(client):
        session = await tts_client(client, script(WORDS))
        listener = await client.ws_connect("/api/mimi_recv")
        hello = await listener.receive_bytes(timeout=RECV_TIMEOUT)
        producer = await client.ws_connect("/api/mimi_send")
        await producer.send_bytes(b"\x09" + codes.tobytes())
        audio = [await listener.receive_bytes(timeout=RECV_TIMEOUT) for _ in range(3)]
        await producer.close()
        await listener.close()
        return session, hello, audio

    async def serve(app):
        async with TestClient(TestServer(app)) as client:
            return await drive(client)

    app = tworker.build_app(cfg, device="cpu")
    session, hello, audio = asyncio.run(serve(app))
    want = asyncio.run(serve(jworker.build_app(cfg)))[0]
    assert session[1] == want[1] and [m["type"] for m in session[1]].count("Text") >= 2
    assert hello == b"\x00" * 9 and all(a[:1] == b"\x01" for a in audio)
    from moshi_tpu_torch.serve.mimi_ws import MimiWsState
    state = MimiWsState(*CheckpointInfo(None, paths={
        "mimi": tmp_path / "ref" / "mimi.safetensors",
        "mimi_config": tmp_path / "ref" / "mimi_config.json"}).get_mimi(device="cpu"))
    ref = state.decode_codes(state.new_session(), codes.astype(np.int64).T)
    assert np.array_equal(np.concatenate([np.frombuffer(a[1:], np.float32) for a in audio]),
                          ref)


# ------------------------------------------------------------- entry points
@pytest.mark.parametrize("argv", [
    ["moshi_tpu_torch.serve.worker", "--config", "{toml}"],
    ["moshi_tpu_torch.serve.tts_ws", "--checkpoint-dir", "{ckpt}"],
    ["moshi_tpu_torch.run_tts", "--checkpoint-dir", "{ckpt}", "--text", "w1", "{ckpt}/out"]],
    ids=["worker", "tts_ws", "run_tts"])
def test_entry_points_refuse_cuda_without_a_card(voiced_ckpt, tmp_path, argv):
    """Every entry point runs on `cuda` unless told otherwise: without a card
    it exits non-zero saying so, and nothing falls back to the CPU."""
    import os
    import subprocess
    toml = tmp_path / "worker.toml"
    toml.write_text(f'[modules.tts]\ntype = "tts"\nroute = "/t"\n'
                    f'checkpoint_dir = "{voiced_ckpt}"\n')
    args = [a.format(toml=toml, ckpt=voiced_ckpt) for a in argv]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", *args], cwd=Path(__file__).resolve().parents[1],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_audio_encoder_needs_libopus(monkeypatch, tmp_path):
    """At an opus rate the encoder is the native codec: when it cannot be
    built (no libopus) that raises, with no raw-PCM fallback; at another
    rate the audio goes as raw f32le."""
    from moshi_tpu_torch import native
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIBS", ("-l:libopus_missing_for_this_test.so.0",))
    with pytest.raises(RuntimeError, match="opus"):
        tws.make_audio_encoder(24000)
    pcm = np.arange(4, dtype=np.float32)
    assert tws.make_audio_encoder(1200).append_pcm(pcm) == pcm.tobytes()
