"""The port's text-to-speech entry points held against the JAX package's,
on the CPU in f32 with greedy decoding: the one-session streamer
(serve/tts_ws.py `TTSStreamer`) over JAX's incremental script, with and
without a voice; a batched session that leaves with a resume id and goes
on on another slot through both packages' async `acquire_slot` /
`release_slot`; both websocket handlers (opus audio, Ready with a resume
id, "full", a bad message, a client gone while starved); `run_tts` and
`build_tts_from_info` on tiny checkpoints the port writes and both
packages read (voices by name, an audio prefix); and the worker's `tts`,
`batched_tts` and `mimi` modules from a native TOML and from the
reference `Tts` / `Mimi` schema.

Tolerances, as the JAX package's own batched-against-single test: token
streams and word events (text and start_s) equal, PCM within PCM_TOL."""

import asyncio
import json
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import WSMsgType, web
from aiohttp.test_utils import TestClient, TestServer
from safetensors.numpy import save_file as np_save_file

from moshi_tpu import audio as jaudio
from moshi_tpu import run_tts as jrun
from moshi_tpu.models import tts as jtts
from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.loaders import CheckpointInfo as JInfo
from moshi_tpu.models.loaders import mimi_config_from_dict as jmimi_config
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.serve import batched_tts as jbt
from moshi_tpu.serve import tts_ws as jws
from moshi_tpu.serve import worker as jworker
from moshi_tpu_torch import conditioners as tc
from moshi_tpu_torch import run_tts as trun
from moshi_tpu_torch.models import tts as ttts
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.models.loaders import CheckpointInfo
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.models.native_ckpt import flatten_tree, save_mimi_params
from moshi_tpu_torch.native import load as load_codec
from moshi_tpu_torch.serve import batched_tts as tbt
from moshi_tpu_torch.serve import tts_ws as tws
from moshi_tpu_torch.serve import worker as tworker
from moshi_tpu_torch.serve.metrics import OPEN_CHANNELS
from moshi_tpu_torch.text.spm import spm_model_bytes
from moshi_tpu_torch.utils.params import from_jax
from moshi_tpu_torch.utils.safetensors import save_file
from test_lm import tiny_lm_config
from test_serving_extra import _tiny_tts_greedy, _tiny_tts_voiced
from test_torch_batched_transport import MOSHI_MIMI, _jsonable
from test_torch_port import max_abs, port_lm_config, port_mimi_config
from test_tts_asr import FakeTokenizer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import export_torch  # noqa: E402
from test_torch_checkpoint import mimi_torch_state  # noqa: E402

PCM_TOL = 1e-5
RECV_TIMEOUT = 60
ROUTE = "/api/tts_streaming"
VOICE_T, VOICE_D = 4, 6   # the voiced tiny model's speaker embeddings


# ------------------------------------------------------------------ models
def port_tts(jt, jparams, jmparams, jcp=None, tokenizer=None):
    """The port's counterpart of a JAX TTSModel and its weights."""
    tmcfg = port_mimi_config(jt.mimi.config)
    provider = fuser = None
    if jt.condition_provider is not None:
        provider = tc.ConditionProvider({"speaker_wavs": tc.TensorConditioner(
            output_dim=jt.lm.config.dim, dim=VOICE_D)})
        fuser = tc.ConditionFuser({"cross": ["speaker_wavs"]})
    m = jt.machine
    machine = ttts.StateMachine(ttts.TokenIds(card=m.token_ids.card),
                                max_padding=m.max_padding, initial_padding=m.initial_padding)
    tt = ttts.TTSModel(TLM(port_lm_config(jt.lm.config)), TMimi(tmcfg),
                       tokenizer or FakeTokenizer(), machine, jt.delay_steps,
                       condition_provider=provider, fuser=fuser, max_speakers=jt.max_speakers,
                       temp=jt.temp, n_q=jt.n_q, max_gen_length=jt.max_gen_length,
                       final_padding=jt.final_padding)
    cp = None if jcp is None else from_jax(jax.device_get(jcp))
    return (tt, from_jax(jax.device_get(jparams)),
            from_jax(jax.device_get(jmparams), mimi_config=tmcfg), cp)


def opus_tts():
    """The greedy tiny TTS of test_serving_extra with an 8 kHz Mimi (opus
    takes its rate), in both packages."""
    cfg = tiny_lm_config(n_q=2, dep_q=2, delays=(0, 0, 1))
    jlm = JLM(cfg)
    params = jlm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    jmimi = JMimi(jmimi_config(MOSHI_MIMI, 2))
    mparams = jmimi.init_params(jax.random.PRNGKey(1))
    machine = jtts.StateMachine(jtts.TokenIds(card=cfg.text_card + 1), max_padding=3,
                                initial_padding=1)
    jt = jtts.TTSModel(jlm, jmimi, FakeTokenizer(), machine, delay_steps=2, temp=0.0, n_q=2,
                       max_gen_length=200, final_padding=2)
    return (jt, params, mparams), port_tts(jt, params, mparams)


def _voice(seed: int = 0, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.RandomState(seed).randn(VOICE_T, VOICE_D)).astype(np.float32)


# -------------------------------------------------------------- recording
def record_jax_tokens(engine, out: list):
    """Append each frame's output tokens [B, 1 + dep_q] of a JAX engine
    (TTSStreamer or BatchedTTSState) to `out`."""
    depth = engine._depth_decode

    def recording(*args):
        res = depth(*args)
        out.append(np.asarray(res[0])[:, :, 0])
        return res
    engine._depth_decode = recording


def record_port_tokens(engine, out: list):
    step = engine.step_batch

    def recording(active, sessions=None):
        res = step(active, sessions)
        out.append(res[0][:, :, 0])
        return res
    engine.step_batch = recording


def incremental(s, tokens):
    """JAX's incremental script (test_serving_extra.py
    test_tts_streamer_incremental): words, then late words whenever the
    session starves before step 60, then EOS.  Returns (token rows, Text
    events, PCM frames)."""
    s.feed_words(["hello world"])
    pcms, events = [], []
    for i in range(150):
        if s.finished:
            break
        if s.starved:
            if i < 60:
                s.feed_words(["again"])
            else:
                s.feed_eos()
            continue
        pcm, ev = s.step()
        events += ev
        if pcm is not None:
            pcms.append(pcm)
    assert s.finished
    return np.stack(tokens)[:, 0], events, pcms


def same_session(got, want):
    """(tokens, events, PCM frames) equal, PCM within PCM_TOL."""
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert len(got[2]) == len(want[2]) > 0
    for a, b in zip(got[2], want[2]):
        assert max_abs(a, b) <= PCM_TOL


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("voiced", [False, True], ids=["no_voice", "voice"])
def test_streamer_matches_jax(voiced):
    """The port's TTSStreamer over JAX's incremental script (late words,
    starvation, then EOS) gives JAX's TTSStreamer's tokens, words and PCM;
    with a voice, on the cross-attention model of
    test_tts_voice_conditioning_streamers."""
    if voiced:
        jt, jp, jm, jcp = _tiny_tts_voiced(temp=0.0)
    else:
        (jt, jp, jm), jcp = _tiny_tts_greedy(), None
    tt, tp, tm, tcp = port_tts(jt, jp, jm, jcp)
    js = jws.TTSStreamer(jt, jp, jm, jax.random.PRNGKey(2), condition_params=jcp)
    ts = tws.TTSStreamer(tt, tp, tm, condition_params=tcp, device="cpu")
    jtok, ttok = [], []
    record_jax_tokens(js, jtok)
    record_port_tokens(ts.engine, ttok)
    if voiced:
        js.set_voice(_voice())
        ts.set_voice(_voice())
    want, got = incremental(js, jtok), incremental(ts, ttok)
    same_session(got, want)
    assert [e["text"] for e in got[1]][:2] == ["hello", "world"] and len(got[0]) > 20
    # a reset streamer repeats the session
    ttok.clear()
    ts.reset()
    if voiced:
        ts.set_voice(_voice())
    same_session(incremental(ts, ttok), want)


def _drain_jax(slot, pcms, texts):
    while not slot.queue.empty():
        kind, payload = slot.queue.get_nowait()
        if kind == "pcm":
            pcms.append(payload)
        elif kind == "event":
            texts.append(payload)


def _drain_port(st, slot, pcms, texts):
    for s in list(st.slot_queues):
        st._deliver(s)
    q = st.slot_queues[slot]
    while not q.empty():
        kind, payload = q.get_nowait()
        if kind == "pcm":
            pcms.append(payload)
        elif kind == "event":
            texts.append(payload)


async def resume_script(st, drain, tokens, active_log):
    """test_serving_extra.py test_batched_tts_slot_resume's script: a
    session leaves with a resume id after 8 frames, a tenant takes and
    dirties its slot for 3, the session resumes on the other slot and runs
    to its end.  Returns (the session's token rows, events, PCM frames) and
    the slots it used."""
    pcms, texts = [], []
    b = await st.acquire_slot()
    st.feed_words(b, ["hello world again"])
    st.feed_eos(b)
    rid = st.issue_resume_id(b)
    rows = []

    def frame(slot_of_session):
        active = st.steppable()
        if not active:
            return False
        st.step_batch(active)
        if slot_of_session in active:
            rows.append(tokens[-1][slot_of_session])
        return True

    for _ in range(8):
        assert frame(b)
    drain(b, pcms, texts)
    await st.release_slot(b)
    other = await st.acquire_slot()
    assert other == b
    st.feed_words(other, ["noise"])
    for _ in range(3):
        frame(None)
    back = await st.acquire_slot(resume=rid)
    assert back is not None and back != other and st.slot_resumed[back] is True
    for _ in range(200):
        if not frame(back) or st.slots[back].done:
            break
    st.steppable()
    assert st.slots[back].done
    drain(back, pcms, texts)
    return (np.stack(rows), texts, pcms), (b, other, back)


def test_batched_resume_matches_jax():
    """A batched session resumed on another slot, while a tenant dirties its
    old one, through both packages' async acquire_slot / release_slot:
    equal tokens, events and PCM; and both equal the unbroken session."""
    jt, jp, jm = _tiny_tts_greedy()
    tt, tp, tm, _ = port_tts(jt, jp, jm)

    async def run_jax_tracked():
        st = jbt.BatchedTTSState(jt, jp, jm, batch_size=2, rng=jax.random.PRNGKey(2))
        tokens = []
        record_jax_tokens(st, tokens)

        def drain(slot, pcms, texts):
            _drain_jax(st.slots[slot], pcms, texts)
        return await resume_script(st, drain, tokens, None)

    async def run_port():
        st = tbt.BatchedTTSState(tt, tp, tm, 2, device="cpu")
        tokens = []
        record_port_tokens(st, tokens)
        return await resume_script(st, lambda s, p, t: _drain_port(st, s, p, t), tokens, None)

    want, jslots = asyncio.run(run_jax_tracked())
    got, tslots = asyncio.run(run_port())
    assert tslots == jslots
    same_session(got, want)
    # the unbroken session
    s = tws.TTSStreamer(tt, tp, tm, device="cpu")
    rows = []
    record_port_tokens(s.engine, rows)
    s.feed_words(["hello world again"])
    s.feed_eos()
    pcms, events = [], []
    while not s.finished:
        pcm, ev = s.step()
        events += ev
        pcms += [] if pcm is None else [pcm]
    same_session(got, (np.stack(rows)[:, 0], events, pcms))


def test_departing_tenant_voice_is_dropped():
    """A voice queued by a session that leaves before the next frame does
    not reach the slot's next tenant, in both packages; the resumed slot
    keeps its own voice."""
    jt, jp, jm, jcp = _tiny_tts_voiced(temp=0.0)
    tt, tp, tm, tcp = port_tts(jt, jp, jm, jcp)

    async def run(st, to_dict):
        b = await st.acquire_slot()
        st.set_slot_voice(b, _voice())
        await st.release_slot(b)
        assert not [op for op in st.pending_ops if op[0] == "voice"]
        b2 = await st.acquire_slot()
        st.steppable()
        assert b2 == b and st.slot_attrs[b] is None
        return "k_cross" in to_dict(st)

    assert not asyncio.run(run(jbt.BatchedTTSState(jt, jp, jm, batch_size=2,
                                                   rng=jax.random.PRNGKey(2),
                                                   condition_params=jcp),
                               lambda st: st.gstate["transformer"]))
    port = tbt.BatchedTTSState(tt, tp, tm, 2, condition_params=tcp, voice_frames=VOICE_T,
                               device="cpu")
    asyncio.run(run(port, lambda st: st.gen_state["transformer"]))
    assert not port.conditioned


# ----------------------------------------------------------------- sockets
def tts_app(handler, engine=None):
    """An app serving `handler` on ROUTE, with `engine.run_loop()` running
    beside it when an engine is given."""
    app = web.Application()
    app.router.add_get(ROUTE, handler)
    if engine is not None:
        async def start(app_):
            app_["loop"] = asyncio.create_task(engine.run_loop())

        async def stop(app_):
            app_["loop"].cancel()
        app.on_startup.append(start)
        app.on_cleanup.append(stop)
    return app


async def tts_client(client, texts, params=None, clock=None):
    """One session: Ready, then `texts` sent (strings, JSON or not), then
    every message up to Eos or an Error "full".  Returns (Ready, the JSON
    messages after it, the audio payloads); `clock` (a dict) gets the
    loop times of Ready and of the last message."""
    ws = await client.ws_connect(ROUTE, params=params or {})
    ready = json.loads((await ws.receive(timeout=RECV_TIMEOUT)).data)
    loop = asyncio.get_running_loop()
    if clock is not None:
        clock["ready"] = loop.time()
    msgs, audio = [], []
    if ready["type"] == "Ready":
        for t in texts:
            await ws.send_str(t)
        while True:
            m = await ws.receive(timeout=RECV_TIMEOUT)
            if m.type == WSMsgType.BINARY:
                assert m.data[:1] == b"\x01"
                audio.append(m.data[1:])
                continue
            assert m.type == WSMsgType.TEXT, m
            msgs.append(json.loads(m.data))
            if msgs[-1]["type"] == "Eos":
                break
    if clock is not None:
        clock["end"] = loop.time()
    await ws.close()
    return ready, msgs, audio


def script(*words) -> list[str]:
    return [json.dumps({"type": "Text", "text": w}) for w in words] + [json.dumps({"type": "Eos"})]


def decoded_samples(audio, rate: int) -> int:
    reader = load_codec().OpusStreamReader(rate)
    return sum(np.frombuffer(reader.append_bytes(p), np.float32).size for p in audio)


def engine_samples(tt, tp, tm, words, rate: int) -> int:
    """The samples that a whole session of `words` on a fresh port streamer
    decodes to after the opus encoder (the decoder drops the encoder's
    lookahead): what the socket's audio must decode to."""
    s = tws.TTSStreamer(tt, tp, tm, device="cpu")
    s.feed_words(words)
    s.feed_eos()
    writer, pcms = tws.make_audio_encoder(rate), []
    while not s.finished:
        pcm = s.step()[0]
        if pcm is not None:
            pcms.append(pcm)
    assert pcms
    return decoded_samples([writer.append_pcm(p) for p in pcms], rate)


def test_tts_socket_matches_jax():
    """The one-session socket: the same words give JAX's handler's Text
    events and Eos; the opus audio decodes to the engine's PCM length; a
    bad message earns an Error and the session goes on; a second
    connection waits for the first session's end, then gets its words
    again from the reset streamer."""
    (jt, jp, jm), (tt, tp, tm, _) = opus_tts()
    words = ("hello world", "how are you")
    rate = tt.mimi.config.sample_rate

    async def run_jax():
        app = tts_app(lambda r: jws.handle_tts_socket(
            r, lambda: jws.TTSStreamer(jt, jp, jm, jax.random.PRNGKey(0))))
        async with TestClient(TestServer(app)) as client:
            return await tts_client(client, script(*words))

    streamer = tws.TTSStreamer(tt, tp, tm, device="cpu")

    async def run_port():
        app = tts_app(lambda r: tws.handle_tts_socket(r, streamer))
        async with TestClient(TestServer(app)) as client:
            first = await tts_client(client, script(*words))
            clocks = ({}, {})
            both = await asyncio.gather(
                tts_client(client, ["not json"] + script(*words), clock=clocks[0]),
                tts_client(client, script(*words), clock=clocks[1]))
            return first, both, clocks

    want = asyncio.run(run_jax())
    first, both, clocks = asyncio.run(run_port())
    assert first[0] == want[0] == {"type": "Ready"}
    assert first[1] == want[1] and [m["type"] for m in want[1]].count("Text") >= 2
    assert decoded_samples(first[2], rate) == engine_samples(tt, tp, tm, list(words), rate)
    bad, good = both
    assert bad[1][0]["type"] == "Error" and "bad message" in bad[1][0]["message"]
    assert bad[1][1:] == good[1] == want[1]
    assert min(clocks[0]["ready"], clocks[1]["ready"]) < max(clocks[0]["ready"],
                                                              clocks[1]["ready"])
    later = max((0, 1), key=lambda i: clocks[i]["ready"])
    assert clocks[later]["ready"] >= clocks[1 - later]["end"] - 1e-3


def test_batched_socket_matches_jax():
    """The batched socket: Ready with a resume id (not resumed), the same
    Text events and Eos as JAX's handler, audio of the engine's PCM
    length; "full" when every slot is taken; a bad message earns an Error
    and the session goes on; a client gone while its slot is starved frees
    the slot."""
    (jt, jp, jm), (tt, tp, tm, _) = opus_tts()
    words = ("hello world", "again")
    rate = tt.mimi.config.sample_rate
    resume = {"resume_support": "1"}

    async def run_jax():
        st = jbt.BatchedTTSState(jt, jp, jm, batch_size=1, rng=jax.random.PRNGKey(0))
        app = tts_app(lambda r: jbt.handle_batched_tts_socket(r, st), st)
        async with TestClient(TestServer(app)) as client:
            return await tts_client(client, script(*words), resume)

    st = tbt.BatchedTTSState(tt, tp, tm, 1, device="cpu")

    async def run_port():
        app = tts_app(lambda r: tbt.handle_batched_tts_socket(r, st), st)
        async with TestClient(TestServer(app)) as client:
            first = await tts_client(client, script(*words), resume)
            bad = await tts_client(client, ["{not json"] + script(*words))
            # a starved client holds the one slot: a second is refused
            ws = await client.ws_connect(ROUTE)
            assert json.loads((await ws.receive(timeout=RECV_TIMEOUT)).data)["type"] == "Ready"
            await ws.send_str(json.dumps({"type": "Text", "text": "hi"}))
            while (await ws.receive(timeout=RECV_TIMEOUT)).type != WSMsgType.TEXT:
                pass  # its first word event, after its first audio
            full = await tts_client(client, script("x"))
            opened = OPEN_CHANNELS.value
            await ws.close()
            for _ in range(500):
                if st.slots == [None] and not st.slot_queues:
                    break
                await asyncio.sleep(0.01)
            return first, bad, full, opened

    want = asyncio.run(run_jax())
    first, bad, full, opened = asyncio.run(run_port())
    assert set(first[0]) == {"type", "resume_id", "resumed"} and first[0]["resumed"] is False
    assert set(want[0]) == set(first[0])
    assert first[1] == want[1] and [m["type"] for m in want[1]].count("Text") >= 2
    assert decoded_samples(first[2], rate) == engine_samples(tt, tp, tm, list(words), rate)
    assert bad[1][0]["type"] == "Error" and bad[1][1:] == want[1]
    assert full[0] == {"type": "Error", "message": "full"}
    assert st.slots == [None] and not st.slot_queues and OPEN_CHANNELS.value == opened - 1


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
