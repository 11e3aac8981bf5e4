"""The port's batched transports held against the JAX package's on the same
checkpoints, on the CPU in f32 with greedy decoding: the speech-to-text
socket (serve/batched_asr.py `handle_asr_socket`: the MessagePack and the
legacy framing, Init, markers, a leave and resume across slots, "server
full", a malformed message) and the batched Moshi socket
(serve/batched_moshi.py `handle_chat`: opus in and out, text, restart, a
resume), plus each engine's resumed session against its unbroken twin.
Checkpoints are written by the port's native writer from seeded weights:
a tiny speech-to-text model (two extra heads, a `delay` conditioner) with
a 1200 Hz Mimi, and a tiny Moshi with an 8 kHz Mimi (opus needs one of
its rates)."""

import asyncio
import dataclasses
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from moshi_tpu.models import asr as jasr
from moshi_tpu.models.loaders import CheckpointInfo as JInfo
from moshi_tpu.serve import batched_asr as jbasr
from moshi_tpu.serve import batched_moshi as jbm
from moshi_tpu.text.spm import SentencePieceTokenizer as JTokenizer
from moshi_tpu_torch.conditioners import ContinuousAttributeConditioner
from moshi_tpu_torch.models.lm import LMModel
from moshi_tpu_torch.models.loaders import CheckpointInfo, mimi_config_from_dict
from moshi_tpu_torch.models.mimi import MimiModel
from moshi_tpu_torch.models.native_ckpt import flatten_tree, save_mimi_params
from moshi_tpu_torch.serve import batched_asr as tbasr
from moshi_tpu_torch.serve import batched_moshi as tbm
from moshi_tpu_torch.serve import protocol as proto
from moshi_tpu_torch.serve.msgpack_codec import packb, unpackb
from moshi_tpu_torch.text.spm import spm_model_bytes
from moshi_tpu_torch.utils.safetensors import save_file
from test_lm import tiny_lm_config
from test_torch_port import max_abs, port_lm_config

B = 3
DELAY = 2           # asr_delay_in_tokens
COND_DELAY = 0.5    # the `delay` condition's value
PRS_TOL = 1e-5      # f32 extra-head softmax after the whole temporal stack
PCM_TOL = 1e-4      # f32 Mimi decode, port vs JAX (tests/test_torch_mimi.py)
RECV_TIMEOUT = 60
ASR_ROUTE = "/api/asr-streaming"

# the 1200 Hz Mimi of tests/test_mimi.py (frame 96 samples), in config.json's schema
ASR_MIMI = {"sample_rate": 1200, "channels": 1, "frame_rate": 12.5,
            "seanet": {"channels": 1, "dimension": 32, "n_filters": 4,
                       "n_residual_layers": 1, "ratios": [4, 3, 2], "kernel_size": 7,
                       "residual_kernel_size": 3, "last_kernel_size": 3,
                       "dilation_base": 2, "compress": 2, "pad_mode": "constant"},
            "transformer": {"d_model": 32, "num_heads": 2, "num_layers": 2, "causal": True,
                            "context": 25, "max_period": 10000, "gating": "none",
                            "norm": "layer_norm", "positional_embedding": "rope",
                            "dim_feedforward": 64, "layer_scale": 0.01},
            "quantizer": {"dimension": 16, "n_q": 8, "bins": 32, "input_dimension": 32,
                          "output_dimension": 32}}
# an 8 kHz one (frame 640 samples, 20 transformer steps a frame)
MOSHI_MIMI = {**ASR_MIMI, "sample_rate": 8000,
              "seanet": {**ASR_MIMI["seanet"], "ratios": [4, 4, 2]}}
ASR_COND = {"dim": 4, "scale_factor": 1.0, "max_period": 10.0}
PAD_LOGIT_SCALE = 8.0  # the text head's pad columns (0, 3) scaled up, so words end


def asr_lm_config():
    """The tiny dep_q = 0 model of tests/test_torch_asr.py (JAX config)."""
    return tiny_lm_config(n_q=4, dep_q=0, delays=(0,) * 5, extra_heads_num_heads=2,
                          extra_heads_dim=2, context=16)


def _jsonable(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def write_checkpoint(out: Path, jcfg, mimi_cfg: dict, seed: int, extra_config: dict,
                     cond: dict | None = None) -> Path:
    """A native checkpoint directory written by the port from seeded f32
    weights: the LM (text head's pad columns scaled by PAD_LOGIT_SCALE),
    the Mimi with its config beside it, a tokenizer and config.json; with
    `cond`, a `delay` conditioner whose tensors sit in the LM's file under
    their PyTorch names (its projection at a fifth of its size: at full
    size it pins a tiny model's text stream to one token)."""
    out.mkdir(parents=True, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    lm = LMModel(port_lm_config(jcfg))
    params = lm.init_params(g, torch.float32)
    params["text_linear"]["weight"][:, [0, 3]] *= PAD_LOGIT_SCALE
    flat = flatten_tree(params)
    config = {**_jsonable(jcfg), **extra_config}
    if cond is not None:
        cparams = ContinuousAttributeConditioner(output_dim=jcfg.dim, **cond).init_params(g)
        prefix = "condition_provider.conditioners.delay"
        flat[f"{prefix}.output_proj.weight"] = (0.2 * cparams["output_proj"]).t().contiguous()
        flat[f"{prefix}.learnt_padding"] = cparams["learnt_padding"]
        config["conditioners"] = {"delay": {"type": "continuous_attribute",
                                            "continuous_attribute": cond}}
    save_file(flat, out / "model.native.safetensors")
    n_cb = max(jcfg.dep_q, jcfg.n_q - jcfg.dep_q)
    mimi = MimiModel(mimi_config_from_dict(mimi_cfg, n_cb))
    save_mimi_params(out / "mimi.native.safetensors", mimi, mimi.init_params(g))
    (out / "mimi_config.json").write_text(json.dumps(mimi_cfg))
    (out / "tokenizer.model").write_bytes(spm_model_bytes(jcfg.text_card))
    config.update(moshi_name="model.native.safetensors", mimi_name="mimi.native.safetensors",
                  mimi_config_name="mimi_config.json", tokenizer_name="tokenizer.model",
                  native_format=True)
    (out / "config.json").write_text(json.dumps(config))
    return out


def write_asr_checkpoint(out: Path) -> Path:
    """The speech-to-text checkpoint.  Its seed and PAD_LOGIT_SCALE were
    picked so that words end within a few frames and, run in bf16 (the
    reference schema's load dtype), no greedy choice is a near-tie
    (test_torch_worker.py holds it: bf16 rounds apart in torch and XLA)."""
    return write_checkpoint(out, asr_lm_config(), ASR_MIMI, 1,
                            {"model_type": "stt",
                             "stt_config": {"audio_delay_seconds": DELAY / 12.5,
                                            "conditioning_delay": COND_DELAY}},
                            cond=ASR_COND)


def jax_asr_state(ckpt: Path, batch: int, info=None):
    """moshi_tpu's BatchedAsrState over the checkpoint, as its worker builds
    one (f32 weights as stored, the delay condition, the tokenizer)."""
    info = info or JInfo.from_dir(ckpt)
    mimi, mimi_params = info.get_mimi()
    lm, lm_params = info.get_moshi()
    cond = jasr.asr_sum_condition(info, lm.config.dim, conditioning_delay=COND_DELAY)
    eng = jasr.StreamingASR(mimi, lm, batch, asr_delay_in_tokens=DELAY, temperature=0.0,
                            text_tokenizer=JTokenizer(info.tokenizer_path), sum_condition=cond)
    return jbasr.BatchedAsrState(eng, mimi_params, lm_params, jax.random.PRNGKey(0))


def port_asr_state(ckpt: Path, batch: int):
    info = CheckpointInfo.from_dir(ckpt)
    state = tbasr.build_state(info, batch_size=batch, device="cpu",
                              text_tokenizer=info.get_text_tokenizer())
    state.warmup()
    return state


@pytest.fixture(scope="module")
def asr_ckpt(tmp_path_factory):
    return write_asr_checkpoint(tmp_path_factory.mktemp("asr"))


def asr_pcm(n: int, frame_size: int, seed: int) -> np.ndarray:
    return (0.3 * np.random.RandomState(seed).randn(n, frame_size)).astype(np.float32)


async def serve(app, fn):
    """Run fn(client) against `app` on aiohttp's TestServer, with the app's
    background loop (when it has one) running."""
    async with TestClient(TestServer(app)) as client:
        return await fn(client)


def asr_app(state, handler):
    app = web.Application()
    app.router.add_get(ASR_ROUTE, lambda r: handler(r, state))

    async def start(app_):
        app_["loop"] = asyncio.create_task(state.run_loop())

    async def stop(app_):
        app_["loop"].cancel()

    app.on_startup.append(start)
    app.on_cleanup.append(stop)
    return app


async def recv(ws) -> dict:
    return unpackb(await ws.receive_bytes(timeout=RECV_TIMEOUT))


async def recv_until_step(ws, out: list):
    """Read messages into `out` up to and with the next Step."""
    while True:
        m = await recv(ws)
        out.append(m)
        if m["type"] == "Step":
            return


async def drain(ws, out: list, timeout: float = 1.0):
    while True:
        try:
            m = await ws.receive_bytes(timeout=timeout)
        except (asyncio.TimeoutError, TypeError):
            return
        out.append(unpackb(m))


def audio_msg(frame, framing: str) -> bytes:
    if framing == "legacy":
        return b"\x08" + np.ascontiguousarray(frame, np.float32).tobytes()
    return packb({"type": "Audio", "pcm": frame.tolist()})


async def lockstep(ws, frames, framing, markers=(), out=None) -> list:
    """Send each frame and wait for its Step (the slot's frame ran), with a
    Marker (id = the frame's index) before the frames in `markers`."""
    out = [] if out is None else out
    for k, frame in enumerate(frames):
        if k in markers:
            await ws.send_bytes(packb({"type": "Marker", "id": k}))
        await ws.send_bytes(audio_msg(frame, framing))
        await recv_until_step(ws, out)
    return out


def asr_script(framing):
    """One client: Ready, Init -> Ready, 12 frames in lockstep with markers
    before frames 2 and 7, a malformed Audio and a Marker without an id
    (each answered with an Error), 2 more frames; then a second client on
    another slot that leaves after 4 frames with a resume id and comes
    back for 4 more, beside a third that fills the batch; then a fourth
    that finds the batch full."""
    async def run(client):
        fs = 96
        pcm = asr_pcm(22, fs, 7)
        ws = await client.ws_connect(ASR_ROUTE)
        first = [await recv(ws)]
        await ws.send_bytes(packb({"type": "Init"}))
        first.append(await recv(ws))
        await lockstep(ws, pcm[:12], framing, markers=(2, 7), out=first)
        await ws.send_bytes(packb({"type": "Audio", "pcm": "not a list"}))
        first.append(await recv(ws))
        await ws.send_bytes(packb({"type": "Marker"}))
        first.append(await recv(ws))
        await lockstep(ws, pcm[12:14], framing, out=first)
        await drain(ws, first)
        await ws.close()

        other = asr_pcm(8, fs, 8)
        ws2 = await client.ws_connect(ASR_ROUTE, params={"resume_support": "1"})
        ready = await recv(ws2)
        rid, left = ready.pop("resume_id"), [ready]
        await lockstep(ws2, other[:4], framing, out=left)
        await ws2.close()
        ws3 = await client.ws_connect(ASR_ROUTE)
        third = [await recv(ws3)]
        ws2 = await client.ws_connect(ASR_ROUTE, params={"resume": rid})
        back = [await recv(ws2)]
        assert "resume_id" in back[0]
        back[0].pop("resume_id")
        ws4 = await client.ws_connect(ASR_ROUTE)
        full = [await recv(ws4)]
        await lockstep(ws2, other[4:], framing, out=back)
        await lockstep(ws3, pcm[:2], framing, out=third)
        await drain(ws2, back)
        for w in (ws2, ws3, ws4):
            await w.close()
        return {"first": first, "left": left, "back": back, "third": third, "full": full}
    return run


def same_streams(got: dict, want: dict, prs_tol: float = PRS_TOL):
    """Equal message streams: types in order, Word text and start_time,
    EndWord stop_time, Marker ids, Step step_idx and buffered_pcm exactly,
    Step prs within prs_tol."""
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], want[name]
        assert [m["type"] for m in g] == [m["type"] for m in w], name
        for a, b in zip(g, w):
            if b["type"] == "Step":
                assert (a["step_idx"], a["buffered_pcm"]) == (b["step_idx"], b["buffered_pcm"])
                assert max_abs(a["prs"], b["prs"]) <= prs_tol
            else:
                assert a == b, name


@pytest.mark.parametrize("framing", ["msgpack", "legacy"])
def test_asr_socket_matches_jax(asr_ckpt, framing):
    """Both packages' handlers over the same checkpoint and PCM give equal
    message streams: Ready and the Init reply, Words with their text,
    EndWords and Markers in order, Steps, the malformed messages' Errors
    (the loop goes on after them), a session resumed on another slot with
    `resumed` true, and "server full"."""
    got = asyncio.run(serve(asr_app(port_asr_state(asr_ckpt, 2), tbasr.handle_asr_socket),
                            asr_script(framing)))
    want = asyncio.run(serve(asr_app(jax_asr_state(asr_ckpt, 2), jbasr.handle_asr_socket),
                             asr_script(framing)))
    same_streams(got, want)
    first = got["first"]
    kinds = [m["type"] for m in first]
    assert kinds[:2] == ["Ready", "Ready"] and "Word" in kinds and "EndWord" in kinds
    assert [m["id"] for m in first if m["type"] == "Marker"] == [2, 7]
    assert [m for m in first if m["type"] == "Error"][0]["message"].startswith("bad message")
    assert got["back"][0] == {"type": "Ready", "resumed": True}
    assert got["full"] == [{"type": "Error", "message": "server full"}]


def test_asr_resume_equals_the_unbroken_twin(asr_ckpt):
    """On each package's engine, a session that leaves after 5 frames and
    resumes on another slot says what its twin, an unbroken session on the
    same PCM, says: the same Words and EndWords."""
    async def run(client):
        pcm = asr_pcm(14, 96, 9)
        twin = await client.ws_connect(ASR_ROUTE)
        ws = await client.ws_connect(ASR_ROUTE, params={"resume_support": "1"})
        out_twin, out = [await recv(twin)], [await recv(ws)]
        rid = out[0]["resume_id"]
        for frame in pcm[:5]:
            for w, o in ((twin, out_twin), (ws, out)):
                await w.send_bytes(audio_msg(frame, "msgpack"))
                await recv_until_step(w, o)
        await ws.close()
        ws = await client.ws_connect(ASR_ROUTE, params={"resume": rid})
        out.append(await recv(ws))
        for frame in pcm[5:]:
            for w, o in ((twin, out_twin), (ws, out)):
                await w.send_bytes(audio_msg(frame, "msgpack"))
                await recv_until_step(w, o)
        for w, o in ((twin, out_twin), (ws, out)):
            await drain(w, o)
            await w.close()
        return out_twin, out

    for state, handler in ((port_asr_state(asr_ckpt, 3), tbasr.handle_asr_socket),
                           (jax_asr_state(asr_ckpt, 3), jbasr.handle_asr_socket)):
        twin, resumed = asyncio.run(serve(asr_app(state, handler), run))
        words = [[m for m in msgs if m["type"] in ("Word", "EndWord")]
                 for msgs in (twin, resumed)]
        assert words[0] and words[0] == words[1]
        assert [m.get("resumed") for m in resumed if m["type"] == "Ready"] == [False, True]


# ------------------------------------------------------------ batched Moshi
def moshi_lm_config():
    """tests/test_lm.py's tiny Moshi, its audio vocabulary the Mimi's 32
    codes."""
    return tiny_lm_config(card=32, context=30)


@pytest.fixture(scope="module")
def moshi_ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("moshi"), moshi_lm_config(), MOSHI_MIMI,
                            1, {"model_type": "moshi",
                                "lm_gen_config": {"use_sampling": False}})


def have_opus() -> bool:
    return shutil.which("g++") is not None and any(
        Path(d, "libopus.so.0").exists()
        for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/usr/lib64",
                  "/usr/lib"))


class RecordingSlots(dict):
    """A state's slot_queues: every queue put in it records what is queued
    (one list per session, in the order the sessions opened)."""

    def __init__(self):
        super().__init__()
        self.sessions = []

    def __setitem__(self, slot, q):
        items = []
        self.sessions.append(items)
        put = q.put_nowait

        def put_nowait(item):
            items.append(item)
            put(item)

        q.put_nowait = put_nowait
        super().__setitem__(slot, q)


def jax_moshi_state(ckpt, batch):
    info = JInfo.from_dir(ckpt)
    mimi, mimi_params = info.get_mimi()
    lm, lm_params = info.get_moshi()
    state = jbm.BatchedMoshiState(mimi, mimi_params, lm, lm_params,
                                  JTokenizer(info.tokenizer_path), batch,
                                  jax.random.PRNGKey(0), **info.lm_gen_config)
    state.warmup()
    state.slot_queues = RecordingSlots()
    return state


def port_moshi_state(ckpt, batch):
    info = CheckpointInfo.from_dir(ckpt)
    state = tbm.build_state(info, batch_size=batch, device="cpu",
                            text_tokenizer=info.get_text_tokenizer())
    state.warmup()
    state.slot_queues = RecordingSlots()
    return state


def moshi_app(state, handler):
    app = web.Application()
    app.router.add_get("/api/chat", lambda r: handler(r, state))

    async def start(app_):
        app_["loop"] = asyncio.create_task(state.run_loop())

    async def stop(app_):
        app_["loop"].cancel()

    app.on_startup.append(start)
    app.on_cleanup.append(stop)
    return app


async def wait_for(cond, what: str, timeout: float = RECV_TIMEOUT):
    t0 = asyncio.get_running_loop().time()
    while not cond():
        if asyncio.get_running_loop().time() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def frames_of(codec, payloads, rate, fs, carry: int = 0) -> tuple[int, int]:
    """(whole frames, samples left over) that a server's opus reader makes
    of `payloads` after `carry` samples already in the backlog."""
    reader = codec.OpusStreamReader(rate)
    n = carry + sum(np.frombuffer(reader.append_bytes(p[1:]), np.float32).size
                    for p in payloads)
    return n // fs, n % fs


def text_of(item) -> int:
    """The text token of a queued frame: the port queues (PCM, the frame's
    tokens), the JAX package (PCM, the text token)."""
    return int(np.asarray(item[1]).reshape(-1)[0])


def new_items(later, earlier):
    """The items of `later` not queued before in `earlier` (a resumed
    session's queue starts with the undelivered frames it took over)."""
    return [x for x in later if not any(x is y for y in earlier)]


def moshi_script(state, codec, rate, fs):
    """Two sessions over opus.  The first sends 10 frames, restarts once
    they have all come back, sends 8 more and reads until the text pieces
    of all its frames came.  The second (with resume_support) sends 8,
    leaves, and resumes with 6 more.  Returns what the first received and
    whether the last was resumed."""
    async def run(client):
        skip = 1 + state.lm.config.max_delay  # frames a fresh session yields nothing for
        sessions = state.slot_queues.sessions
        pcm = asr_pcm(18, fs, 11)
        writer = codec.OpusStreamWriter(rate)
        parts = [[proto.msg(proto.MT_AUDIO, b) for b in map(writer.append_pcm, pcm[a:b]) if b]
                 for a, b in ((0, 10), (10, 18))]
        ws = await client.ws_connect("/api/chat")
        first = [await ws.receive_bytes(timeout=RECV_TIMEOUT)]
        n0, left = frames_of(codec, parts[0], rate, fs)
        for p in parts[0]:
            await ws.send_bytes(p)
        await wait_for(lambda: sessions and len(sessions[0]) == n0 - skip, "the first frames")
        await ws.send_bytes(proto.msg(proto.MT_CONTROL, bytes([proto.CTRL_RESTART])))
        reader = codec.OpusStreamReader(rate)
        for p in parts[0]:
            reader.append_bytes(p[1:])
        n1 = sum(np.frombuffer(reader.append_bytes(p[1:]), np.float32).size
                 for p in parts[1]) // fs
        for p in parts[1]:
            await ws.send_bytes(p)
        total = n0 - skip + n1 - skip
        await wait_for(lambda: len(sessions[0]) == total, "the frames after the restart")
        pieces = sum(text_of(item) not in (0, 3) for item in sessions[0])
        while sum(m[0] == proto.MT_TEXT for m in first) < pieces:
            first.append(await ws.receive_bytes(timeout=RECV_TIMEOUT))
        await ws.close()

        other = asr_pcm(14, fs, 12)
        ws = await client.ws_connect("/api/chat", params={"resume_support": "1"})
        await ws.receive_bytes(timeout=RECV_TIMEOUT)
        rid = json.loads((await ws.receive_bytes(timeout=RECV_TIMEOUT))[1:])["resume_id"]
        payloads = opus_payloads(codec, other[:8], rate)
        n2, left = frames_of(codec, payloads, rate, fs)
        for p in payloads:
            await ws.send_bytes(p)
        await wait_for(lambda: len(sessions[1]) == n2 - skip, "the second session's frames")
        await ws.close()
        ws = await client.ws_connect("/api/chat", params={"resume": rid})
        await ws.receive_bytes(timeout=RECV_TIMEOUT)
        resumed = json.loads((await ws.receive_bytes(timeout=RECV_TIMEOUT))[1:])["resumed"]
        payloads = opus_payloads(codec, other[8:], rate)
        n3, _ = frames_of(codec, payloads, rate, fs, carry=left)
        for p in payloads:
            await ws.send_bytes(p)
        await wait_for(lambda: len(sessions) > 2 and len(new_items(sessions[2], sessions[1]))
                       == n3, "the resumed frames")
        await ws.close()
        return first, resumed
    return run


def opus_payloads(codec, pcm, rate):
    writer = codec.OpusStreamWriter(rate)
    return [proto.msg(proto.MT_AUDIO, b) for b in map(writer.append_pcm, pcm) if b]


def _texts(msgs):
    return [m[1:].decode() for m in msgs if m[0] == proto.MT_TEXT]


def _same_pcm(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    nan = np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), nan)
    assert not (~nan).any() or max_abs(a[~nan], b[~nan]) <= PCM_TOL


@pytest.mark.skipif(not have_opus(), reason="needs g++ and libopus.so.0 for the opus codec")
def test_batched_moshi_socket_matches_jax(moshi_ckpt):
    """Both packages' batched chat handlers over the same checkpoint and
    opus bytes: the same handshake and MT 2 text, each session's queued
    frames with the same text tokens and PCM (NaN positions equal, the
    rest within 1e-4), a restart answered and started afresh, a session
    resumed with `resumed` true."""
    from moshi_tpu_torch import native
    codec = native.load()
    rate, fs = MOSHI_MIMI["sample_rate"], 640
    results = []
    for make, handler in ((port_moshi_state, tbm.handle_chat),
                          (jax_moshi_state, jbm.handle_chat)):
        state = make(moshi_ckpt, 2)
        first, resumed = asyncio.run(serve(moshi_app(state, handler),
                                           moshi_script(state, codec, rate, fs)))
        results.append((first, resumed, state.slot_queues.sessions))
    (tfirst, tresumed, tq), (jfirst, jresumed, jq) = results
    assert tfirst[0] == jfirst[0] == proto.handshake()
    assert _texts(tfirst) == _texts(jfirst) and _texts(tfirst)
    restarted = [json.loads(m[1:]) for m in tfirst if m[0] == proto.MT_METADATA]
    assert restarted == [{"event": "restarted"}]
    assert tresumed is jresumed is True
    assert len(tq) == len(jq) == 3
    tq[2], jq[2] = new_items(tq[2], tq[1]), new_items(jq[2], jq[1])
    for got, want in zip(tq, jq):
        assert len(got) == len(want) > 0
        for t, j in zip(got, want):
            assert text_of(t) == text_of(j)
            _same_pcm(t[0], j[0])


async def _engine_twins(state, fs, feed):
    """Two slots on one PCM stream; the second leaves after 6 frames with a
    resume id, a new session takes a slot, and the first resumes for the
    other 6: the queued frames of the twin and of the two halves."""
    loop = asyncio.create_task(state.run_loop())
    pcm = asr_pcm(13, fs, 13)
    twin = await state.acquire_slot()
    s = await state.acquire_slot()
    rid = state.issue_resume_id(s)
    sessions = state.slot_queues.sessions
    feed(state, twin, pcm.reshape(-1))
    feed(state, s, pcm[:7].reshape(-1))
    await wait_for(lambda: len(sessions[1]) >= 7 - 1 - state.lm.config.max_delay,
                   "the first half")
    await state.release_slot(s)
    tenant = await state.acquire_slot()
    feed(state, tenant, asr_pcm(3, fs, 14).reshape(-1))
    s = await state.acquire_slot(rid)
    feed(state, s, pcm[7:].reshape(-1))
    n = 13 - 1 - state.lm.config.max_delay
    await wait_for(lambda: len(sessions[0]) == n
                   and len(sessions[1]) + len(new_items(sessions[3], sessions[1])) == n,
                   "every frame")
    loop.cancel()
    return sessions[0], sessions[1] + new_items(sessions[3], sessions[1]), state.slot_resumed[s]


def test_batched_moshi_resume_equals_the_unbroken_twin(moshi_ckpt):
    """On each package's engine, driven through acquire_slot / the slot's
    backlog / release_slot under its run_loop: a session that leaves and
    resumes on a slot a new tenant did not take queues the same text
    tokens as its unbroken twin, and PCM within 1e-4 (NaN positions
    equal)."""
    def port_feed(state, slot, pcm):
        state.feed_pcm(slot, pcm)

    def jax_feed(state, slot, pcm):
        state.slot_pcm[slot] = np.concatenate([state.slot_pcm[slot], pcm])

    for make, feed in ((port_moshi_state, port_feed), (jax_moshi_state, jax_feed)):
        state = make(moshi_ckpt, 3)
        twin, halves, resumed = asyncio.run(_engine_twins(state, 640, feed))
        assert resumed and len(twin) == len(halves) > 0
        for t, h in zip(twin, halves):
            assert text_of(t) == text_of(h)
            _same_pcm(h[0], t[0])
