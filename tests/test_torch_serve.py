"""The port's websocket server and offline runner over the tiny checkpoint
(scripts/make_tiny_checkpoint.py), held against the JAX package's on the
same files: the handshake, the metadata echo, greedy raw-PCM sessions
(text pieces), ping, pause and restart, the FIFO queue with its position
messages, an opus session through the port's own codec build, and
run_inference; the port's modules import neither aiohttp nor safetensors
nor msgpack nor jax; a server asked for CUDA on a machine without it
exits non-zero.
Sessions run on aiohttp's TestServer / TestClient, and the scripted one
also through the session coroutine alone (the in-process transport)."""

import asyncio
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import make_tiny_checkpoint  # noqa: E402
from moshi_tpu import audio as jaudio  # noqa: E402
from moshi_tpu.models.loaders import CheckpointInfo as JInfo  # noqa: E402
from moshi_tpu.run_inference import InferenceState as JInference  # noqa: E402
from moshi_tpu.serve import protocol as jproto  # noqa: E402
from moshi_tpu.serve.server import ServerState as JServerState  # noqa: E402
from moshi_tpu.text.spm import SentencePieceTokenizer as JTokenizer  # noqa: E402
from moshi_tpu_torch import run_inference as trun  # noqa: E402
from moshi_tpu_torch.models.loaders import CheckpointInfo  # noqa: E402
from moshi_tpu_torch.serve import protocol as proto  # noqa: E402
from moshi_tpu_torch.serve.server import ServerState  # noqa: E402
from moshi_tpu_torch.text.spm import SentencePieceTokenizer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 12
RECV_TIMEOUT = 60


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_checkpoint.make(tmp_path_factory.mktemp("tiny"))


def port_state(ckpt, **kw) -> ServerState:
    info = CheckpointInfo.from_dir(ckpt)
    mimi, mimi_params = info.get_mimi(device="cpu")
    lm, lm_params = info.get_moshi(device="cpu")
    state = ServerState(mimi, mimi_params, lm, lm_params, info=info,
                        text_tokenizer=SentencePieceTokenizer(info.tokenizer_path),
                        device="cpu", use_sampling=False, **kw)
    state.warmup()
    return state


@pytest.fixture(scope="module")
def servers(ckpt):
    """A greedy ServerState of each package over the tiny checkpoint,
    warmed up."""
    info = JInfo.from_dir(ckpt)
    mimi, mimi_params = info.get_mimi()
    lm, lm_params = info.get_moshi()
    jstate = JServerState(info, mimi, mimi_params, lm, lm_params,
                          JTokenizer(info.tokenizer_path), use_sampling=False)
    jstate.warmup()
    return port_state(ckpt), jstate


def pcm_frames(n, frame_size, seed=0):
    return (0.3 * np.random.RandomState(seed).randn(n, frame_size)).astype(np.float32)


def raw(frame) -> bytes:
    return proto.msg(proto.MT_PCM, np.ascontiguousarray(frame, np.float32).tobytes())


RAW_PCM = proto.msg(proto.MT_METADATA, json.dumps({"raw_pcm": True}).encode())
PING = proto.msg(proto.MT_PING)


def ctrl(c) -> bytes:
    return proto.msg(proto.MT_CONTROL, bytes([c]))


async def with_client(handler, fn):
    app = web.Application()
    app.router.add_get("/api/chat", handler)
    async with TestClient(TestServer(app)) as client:
        return await fn(client)


async def receive_until(ws, kind, count=1) -> list[bytes]:
    """The messages up to and with the `count`-th of type `kind`."""
    out = []
    while count:
        m = await ws.receive_bytes(timeout=RECV_TIMEOUT)
        out.append(m)
        count -= m[0] == kind
    return out


def scripted(handler, payloads, query=None, pings=1):
    """Send `payloads` on one socket, read until `pings` pings came back."""
    async def run(client):
        ws = await client.ws_connect("/api/chat", params=query or {})
        for p in payloads:
            await ws.send_bytes(p)
        out = await receive_until(ws, proto.MT_PING, pings)
        await ws.close()
        return out
    return asyncio.run(with_client(handler, run))


def texts(msgs) -> list[str]:
    return [m[1:].decode() for m in msgs if m[0] == proto.MT_TEXT]


def not_pcm(msgs) -> list[bytes]:
    """Every message but the PCM frames, whose floats the packages round
    apart."""
    return [m for m in msgs if m[0] != proto.MT_PCM]


def pcms(msgs) -> list[np.ndarray]:
    return [np.frombuffer(m[1:], np.float32) for m in msgs if m[0] == proto.MT_PCM]


def test_handshake_and_echo_match_jax(servers):
    """The first message is the JAX protocol's handshake; the metadata
    echo for a query with overrides (and keys to ignore) is the JAX
    server's, byte for byte."""
    tstate, jstate = servers
    query = {"text_temperature": "0.5", "text_topk": "10", "audio_seed": "3",
             "text_seed": "x", "max_steps": "100", "repetition_penalty": "1.2",
             "repetition_penalty_context": "8", "audio_topk": "many", "bogus": "1"}
    got = [scripted(s.handle_chat, [PING], query) for s in (tstate, jstate)]
    assert got[0][0] == jproto.handshake() == got[1][0]
    assert got[0][1] == got[1][1] and got[0][1][0] == proto.MT_METADATA
    echo = json.loads(got[0][1][1:])
    assert echo["text_temperature"] == 0.5 and echo["max_steps"] == 100
    assert echo == {**jstate._session_cfg_dict(), "resumed": False}
    bare = scripted(tstate.handle_chat, [PING])
    assert bare == [jproto.handshake(), jproto.msg(jproto.MT_PING)]


def test_greedy_raw_pcm_session_matches_jax(servers):
    """The same frames through each server: the same text pieces in order
    and one PCM frame per generated frame."""
    tstate, jstate = servers
    payloads = [RAW_PCM] + [raw(f) for f in pcm_frames(FRAMES, tstate.frame_size)] + [PING]
    got = [scripted(s.handle_chat, payloads) for s in (tstate, jstate)]
    assert got[0][1] == got[1][1]  # the raw-PCM reply
    assert texts(got[0]) == texts(got[1]) and texts(got[0])
    expected = FRAMES - 1 - tstate.lm.config.max_delay
    assert len(pcms(got[0])) == len(pcms(got[1])) == expected
    assert all(p.shape == (tstate.frame_size,) for p in pcms(got[0]))


def test_colored_text(ckpt, servers):
    """colored_text sends each piece as MT 7, a colour byte (the sampled
    token's probability in tenths) before the text of the MT 2 piece."""
    tstate, _ = servers
    colored = port_state(ckpt, colored_text=True)
    payloads = [RAW_PCM] + [raw(f) for f in pcm_frames(FRAMES, tstate.frame_size)] + [PING]
    plain, got = scripted(tstate.handle_chat, payloads), scripted(colored.handle_chat, payloads)
    pieces = [m for m in got if m[0] == proto.MT_COLOREDTEXT]
    assert [m[2:].decode() for m in pieces] == texts(plain) and not texts(got)
    assert all(0 <= m[1] <= 10 for m in pieces)


def session_script(frame_size):
    """Pause, frames to discard, start, a session, ping; restart, the same
    session again, ping."""
    frames = pcm_frames(FRAMES, frame_size, seed=1)
    junk = pcm_frames(3, frame_size, seed=2)
    session = [raw(f) for f in frames] + [PING]
    return ([RAW_PCM, ctrl(proto.CTRL_PAUSE)] + [raw(f) for f in junk]
            + [ctrl(proto.CTRL_START)] + session + [ctrl(proto.CTRL_RESTART)] + session)


def in_process(state, payloads, query=None) -> list[bytes]:
    """One session through ServerState.run_session alone."""
    out = []

    async def messages():
        for p in payloads:
            yield p

    async def send(b):
        out.append(b)

    asyncio.run(state.run_session(query or {}, messages(), send))
    return out


def test_ping_pause_restart(servers):
    """Paused input is discarded; restart answers {"event": "restarted"}
    and the frames after it give what a fresh session gives; every reply
    but the PCM (handshake, raw-PCM reply, text, ping, restart) is the JAX
    server's, byte for byte; the in-process transport sends what the
    socket does."""
    tstate, jstate = servers
    script = session_script(tstate.frame_size)
    got = scripted(tstate.handle_chat, script, pings=2)
    jgot = scripted(jstate.handle_chat, script, pings=2)
    assert not_pcm(got) == not_pcm(jgot) and len(got) == len(jgot)
    assert got == in_process(tstate, script)
    restarted = proto.msg(proto.MT_METADATA, json.dumps({"event": "restarted"}).encode())
    i = got.index(restarted)
    first, second = got[2:i], got[i + 1:]
    assert first == second and first[-1] == PING
    fresh = scripted(tstate.handle_chat, [RAW_PCM] + script[-FRAMES - 1:])
    assert fresh[2:] == second
    assert len(pcms(first)) == FRAMES - 1 - tstate.lm.config.max_delay


def test_queued_client_gets_positions_and_is_served(ckpt):
    """While a session runs, a second client that opted in (a session
    parameter) gets MT 4 queue positions, then its handshake, its echo
    and a session once the first one closes."""
    state = port_state(ckpt)
    frames = pcm_frames(4, state.frame_size)

    async def run(client):
        a = await client.ws_connect("/api/chat")
        assert await a.receive_bytes(timeout=RECV_TIMEOUT) == proto.handshake()
        b = await client.ws_connect("/api/chat", params={"text_temperature": "0.7"})
        waiting = json.loads((await b.receive_bytes(timeout=RECV_TIMEOUT))[1:])
        assert waiting == {"status": "wait", "queue_position": 1}
        await a.close()
        msgs = await receive_until(b, proto.MT_HANDSHAKE)
        assert all(json.loads(m[1:])["status"] == "wait" for m in msgs[:-1])
        echo = json.loads((await b.receive_bytes(timeout=RECV_TIMEOUT))[1:])
        assert echo["text_temperature"] == 0.7
        for p in [RAW_PCM] + [raw(f) for f in frames] + [PING]:
            await b.send_bytes(p)
        out = await receive_until(b, proto.MT_PING)
        await b.close()
        return out

    out = asyncio.run(with_client(state.handle_chat, run))
    assert len(pcms(out)) == 4 - 1 - state.lm.config.max_delay


def test_opus_session(servers):
    """Ogg-opus in and out through the port's own build of the native
    codec: audio and text come back."""
    if shutil.which("g++") is None or not any(
            Path(d, "libopus.so.0").exists()
            for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/usr/lib64",
                      "/usr/lib")):
        pytest.skip("needs g++ and libopus.so.0 to build the opus codec")
    from moshi_tpu_torch import native
    tstate, _ = servers
    codec = native.load()
    writer = codec.OpusStreamWriter(24000)
    payloads = []
    for f in pcm_frames(20, tstate.frame_size, seed=3):
        b = writer.append_pcm(f)
        if b:
            payloads.append(proto.msg(proto.MT_AUDIO, b))
    got = scripted(tstate.handle_chat, payloads + [PING])
    reader = codec.OpusStreamReader(24000)
    audio = [np.frombuffer(reader.append_bytes(m[1:]), np.float32)
             for m in got if m[0] == proto.MT_AUDIO]
    assert sum(a.size for a in audio) > 0 and texts(got)
    assert native.library_path().parent == ROOT / "build" / "native"


def test_run_inference_matches_jax(ckpt, tmp_path):
    """A 1 s wav through each package's InferenceState, greedy: the same
    text; the port's CLI writes a wav of the same length."""
    rate = 24000
    wav = tmp_path / "in.wav"
    jaudio.write_wav(wav, 0.3 * np.random.RandomState(4).randn(rate).astype(np.float32), rate)
    pcm = jaudio.read_wav(wav, rate)[0][None, :1]
    info = JInfo.from_dir(ckpt)
    (jmimi, jmimi_params), (jlm, jlm_params) = info.get_mimi(), info.get_moshi()
    (jtext, jpcm), = JInference(info, jmimi, jmimi_params, jlm, jlm_params, None, 1,
                                use_sampling=False).run(pcm)
    tinfo = CheckpointInfo.from_dir(ckpt)
    (mimi, mimi_params), (lm, lm_params) = tinfo.get_mimi("cpu"), tinfo.get_moshi(device="cpu")
    (ttext, tpcm), = trun.InferenceState(tinfo, mimi, mimi_params, lm, lm_params, None, 1,
                                         device="cpu", use_sampling=False).run(pcm)
    np.testing.assert_array_equal(ttext, jtext)
    assert tpcm.shape == jpcm.shape == (1, len(jtext) * mimi.frame_size)
    out = tmp_path / "out.wav"
    trun.main(["--checkpoint-dir", str(ckpt), "--device", "cpu", str(wav), str(out)])
    assert jaudio.read_wav(out)[0].shape == jpcm.shape


def test_port_modules_import_no_optional_packages():
    """Importing every module of the port leaves aiohttp, safetensors,
    msgpack and jax out of sys.modules (and builds nothing)."""
    code = ("import importlib, pkgutil, sys, moshi_tpu_torch\n"
            "for m in pkgutil.walk_packages(moshi_tpu_torch.__path__, 'moshi_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('aiohttp', 'safetensors', 'msgpack', 'jax',\n"
            "                                    'moshi_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_server_refuses_cuda_without_a_card(ckpt):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "moshi_tpu_torch.serve.server",
                           "--checkpoint-dir", str(ckpt), "--device", "cuda"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
