"""The port's `py_batched_asr` worker module (moshi_tpu_torch/serve/py_basr.py)
held against the JAX package's: tests/test_worker.py's toy script, speaking
the bitmask step protocol, served by each package's worker (the reference
TOML's `PyBatchedAsr`), driven frame by frame over the msgpack ASR socket:
the same messages, byte for byte (Ready, Step, Word / EndWord from the
server's word assembly, Marker); the module's table errors; the engine's
frame and marker clock on its own.  Tolerance: none, bytes."""

import asyncio
import tomllib

import numpy as np
import pytest
from aiohttp import WSMsgType
from aiohttp.test_utils import TestClient, TestServer

from moshi_tpu.serve import py_basr as jbasr
from moshi_tpu.serve import worker as jworker
from moshi_tpu_torch.serve import py_basr as tbasr
from moshi_tpu_torch.serve import worker as tworker
from moshi_tpu_torch.serve.msgpack_codec import packb, unpackb
from moshi_tpu_torch.text.spm import spm_model_bytes

TOY = '''
import numpy as np
class App:
    def __init__(self, batch_size, config):
        assert config.get('greeting') == 'hi'
        self.steps = np.zeros(batch_size, np.int64)
        self.warmed = False
    def warmup(self):
        self.warmed = True
    def step(self, pcm, flags, tokens, extra, updates):
        assert self.warmed
        for i, u in enumerate(updates):
            flags[i] = 0
            if u == -2:
                self.steps[i] = 0
                flags[i] = 1
            elif u == -1:
                flags[i] = 1
            elif u > 0:
                flags[i] = 2
            if flags[i] & 3:
                self.steps[i] += 1
                # a 3-token word, then a pad, every 4th step
                tokens[i] = 3 if self.steps[i] % 4 == 0 else 4 + (self.steps[i] % 3)
                extra[i, :] = float(self.steps[i] % 2) + 0.25 * i + 0.1 * float(pcm[i * 1920])
def init(batch_size, config):
    return App(batch_size, config)
'''
FRAMES = 9
DELAY = 2
TIMEOUT = 60


def toml(script, tokenizer) -> dict:
    return tomllib.loads(f"""
authorized_ids = []

[modules.pyasr]
type = "PyBatchedAsr"
path = "/api/py-asr"
script = "{script}"
batch_size = 2
text_tokenizer_file = "{tokenizer}"
asr_delay_in_tokens = {DELAY}

[modules.pyasr.py]
greeting = "hi"
""")


async def session(client, pcm) -> list[bytes]:
    """Ready, then each frame once the last one's Step came, a Marker after
    FRAMES frames and DELAY + 2 frames after it; every message received,
    raw, until the Marker and the last Step."""
    ws = await client.ws_connect("/api/py-asr")
    got = []

    async def until_step():
        while True:
            m = await ws.receive(timeout=TIMEOUT)
            assert m.type == WSMsgType.BINARY
            got.append(m.data)
            if unpackb(m.data)["type"] == "Step":
                return

    got.append((await ws.receive(timeout=TIMEOUT)).data)  # Ready
    await until_step()  # the session's reset takes a frame
    for k, frame in enumerate(pcm):
        if k == FRAMES:
            await ws.send_bytes(packb({"type": "Marker", "id": 9}))
            await until_step()
        await ws.send_bytes(packb({"type": "Audio", "pcm": frame.tolist()}))
        await until_step()
    while {"type": "Marker", "id": 9} not in [unpackb(m) for m in got]:
        got.append((await ws.receive(timeout=TIMEOUT)).data)
    await ws.close()
    return got


def test_py_batched_asr_matches_jax(tmp_path):
    """The toy script's session over each package's worker: the same
    msgpack messages byte for byte, with Words, EndWords, every frame's
    Step and the Marker among them; modules_info names the type."""
    script = tmp_path / "toy_basr.py"
    script.write_text(TOY)
    tokenizer = tmp_path / "tok.model"
    tokenizer.write_bytes(spm_model_bytes(64))
    pcm = (0.3 * np.random.RandomState(0).randn(FRAMES + DELAY + 2, 1920)).astype(np.float32)

    async def run(build_app):
        kw = {"device": "cpu"} if build_app is tworker.build_app else {}
        async with TestClient(TestServer(build_app(toml(script, tokenizer), **kw))) as client:
            info = await (await client.get("/api/modules_info")).json()
            return info, await session(client, pcm)

    (tinfo, tmsgs), (jinfo, jmsgs) = (asyncio.run(run(b)) for b in (tworker.build_app,
                                                                      jworker.build_app))
    assert tinfo == jinfo and tinfo["pyasr"]["type"] == "py_batched_asr"
    assert tmsgs == jmsgs
    kinds = [unpackb(m)["type"] for m in tmsgs]
    assert kinds[0] == "Ready" and kinds.count("Step") == 1 + len(pcm) + 1
    assert kinds.count("Word") == kinds.count("EndWord") >= 2 and kinds.count("Marker") == 1
    # echoed once the clock passed the marker's tick + the delay
    assert kinds.index("Marker") > [i for i, k in enumerate(kinds) if k == "Step"][FRAMES + 1]
    words = [unpackb(m) for m in tmsgs if unpackb(m)["type"] == "Word"]
    assert all(w["text"] for w in words)


@pytest.mark.parametrize("case", ["no_script", "no_init"])
def test_py_batched_asr_table_errors_match_jax(case, tmp_path):
    """A table without `script`, or a script without `init()`, raises the
    JAX package's ValueError."""
    script = tmp_path / "empty.py"
    script.write_text("x = 1\n")
    mcfg = {"route": "/r", "batch_size": 2, "asr_delay_in_tokens": 2}
    if case == "no_init":
        mcfg["script"] = str(script)
    errors = []
    for mod in (tbasr, jbasr):
        with pytest.raises(ValueError) as e:
            mod.build_py_batched_asr("m", dict(mcfg))
        errors.append(str(e.value).replace("moshi_tpu_torch", "moshi_tpu"))
    assert errors[0] == errors[1]


def test_py_batched_asr_state_clock_matches_jax():
    """The engine on its own (no socket): the same script, slots and frames
    give each package's state the same step clock, word stream and marker
    echo."""
    ns: dict = {}
    exec(TOY, ns)

    async def run(mod):
        state = mod.PyBatchedAsrState(ns["init"](2, {"greeting": "hi"}), 2, DELAY)
        state.app.warmup()
        a, b = await state.acquire_slot(), await state.acquire_slot()
        loop = asyncio.ensure_future(state.run_loop())
        pcm = np.random.RandomState(1).randn(6 * 1920).astype(np.float32)
        state.feed_pcm(a, pcm)
        state.add_marker(b, 4)
        state.feed_pcm(b, pcm[:3 * 1920])
        # a: its reset and 6 frames; b, beside it: its reset, the marker
        # and 3 frames
        for _ in range(2000):
            if state.step_idx >= 7:
                break
            await asyncio.sleep(0.005)
        await asyncio.sleep(0.05)
        loop.cancel()
        out = {s: [] for s in (a, b)}
        for s in (a, b):
            while not state.slot_queues[s].empty():
                out[s].append(state.slot_queues[s].get_nowait())
        await state.release_slot(a)
        await state.release_slot(b)
        return state.steps, out

    assert asyncio.run(run(tbasr)) == asyncio.run(run(jbasr))
