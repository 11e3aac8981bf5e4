"""The port's text-to-speech engines and sockets held against the JAX
package's, on the CPU in f32 with greedy decoding: the one-session
streamer (serve/tts_ws.py `TTSStreamer`) over JAX's incremental script,
with and without a voice; a batched session that leaves with a resume id
and goes on on another slot through both packages' async `acquire_slot` /
`release_slot`; both websocket handlers (opus audio, Ready with a resume
id, "full", a bad message, a client gone while starved).  The entry points
over checkpoints (`run_tts`, the worker's modules) are in
tests/test_torch_tts_serve_cli.py.

Tolerances, as the JAX package's own batched-against-single test: token
streams and word events (text and start_s) equal, PCM within PCM_TOL."""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp import WSMsgType, web
from aiohttp.test_utils import TestClient, TestServer

from moshi_tpu.models import tts as jtts
from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.loaders import mimi_config_from_dict as jmimi_config
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.serve import batched_tts as jbt
from moshi_tpu.serve import tts_ws as jws
from moshi_tpu_torch import conditioners as tc
from moshi_tpu_torch.models import tts as ttts
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.native import load as load_codec
from moshi_tpu_torch.serve import batched_tts as tbt
from moshi_tpu_torch.serve import tts_ws as tws
from moshi_tpu_torch.serve.metrics import OPEN_CHANNELS
from moshi_tpu_torch.utils.params import from_jax
from test_lm import tiny_lm_config
from test_serving_extra import _tiny_tts_greedy, _tiny_tts_voiced
from test_torch_batched_transport import MOSHI_MIMI
from test_torch_lora import one_thread  # noqa: F401  (autouse)
from test_torch_port import max_abs, port_lm_config, port_mimi_config
from test_tts_asr import FakeTokenizer

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
