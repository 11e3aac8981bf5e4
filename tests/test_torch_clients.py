"""The port's clients and their pure helpers against the JAX package's:
client_utils' printed text, client_tui's render_lines and client_gradio's handler, all byte for byte
on the same inputs; client_gradio's main naming the missing package; and
client.run (opus through the port's native codec) against the port's
serve/server.py on loopback over scripts/make_tiny_checkpoint.py's
checkpoint."""

import asyncio
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import make_tiny_checkpoint  # noqa: E402
from moshi_tpu import client_gradio as jgradio  # noqa: E402
from moshi_tpu import client_tui as jtui  # noqa: E402
from moshi_tpu import client_utils as jutils  # noqa: E402
from moshi_tpu_torch import audio, client, client_gradio, client_tui, client_utils  # noqa: E402
from moshi_tpu_torch.serve import protocol as proto  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_lora.py): the tiny server's
    models run faster without torch's thread pool beside other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- client_utils
def printer_text(mod, cls, **kw):
    out, err = io.StringIO(), io.StringIO()
    p = getattr(mod, cls)(stream=out, err_stream=err, **kw)
    p.print_header()
    for tok in [" hello", " world", " again", "abcdefghijklmnopqrstuvwxyz", " and", " more",
                " wrapping", " words", "é"]:
        p.print_token(tok)
    p.print_lag()
    p.print_lag()
    if hasattr(p, "clear_lag"):
        p.clear_lag()
    p.print_lag()
    p.log("warning", "slow")
    p.print_token(" after")
    p.close()
    return out.getvalue(), err.getvalue()


def test_printers_equal_jax():
    for cls, kw in (("Printer", {"max_cols": 12}), ("Printer", {"max_cols": 80}),
                    ("RawPrinter", {})):
        assert printer_text(client_utils, cls, **kw) == printer_text(jutils, cls, **kw)
    for level in ("info", "warning", "error", "debug"):
        assert client_utils.make_log(level, "m") == jutils.make_log(level, "m")
    assert isinstance(client_utils.make_printer(io.StringIO()), client_utils.RawPrinter)


# ---------------------------------------------------------------- client_tui
def tui_state(mod, lag: bool, exiting: bool, ticker: int):
    st = mod.TuiState()
    st.on_sent(np.ones(1920, np.float32) * 0.5)
    st.on_sent(np.full(1920, 1e-4, np.float32))
    st.on_audio(np.zeros(3840, np.float32))
    for piece in (" hello", " world,", " this transcript is long enough to wrap across lines",
                  " " + "x" * 130):
        st.on_text(piece)
    for i in range(40):
        st.log("info", f"line {i}")
    st.lag, st.ticker = lag, ticker
    if exiting:
        st.state = "EXITING"
    return st


@pytest.mark.parametrize("size", [(100, 24), (60, 30), (20, 5), (160, 50)])
def test_tui_render_lines_equal_jax(size):
    for lag, exiting, ticker in ((False, False, 0), (True, False, 5), (True, True, 9)):
        mine = client_tui.render_lines(tui_state(client_tui, lag, exiting, ticker), *size)
        theirs = jtui.render_lines(tui_state(jtui, lag, exiting, ticker), *size)
        assert mine == theirs
    assert client_tui._wrap([" a b", " c" * 40], 7, 3) == jtui._wrap([" a b", " c" * 40], 7, 3)


# ------------------------------------------------------------- client_gradio
class FakeWs:
    def __init__(self, incoming):
        self.sent, self.incoming = [], list(incoming)

    def send(self, data):
        self.sent.append(bytes(data))

    def __iter__(self):
        return iter(self.incoming)

    def close(self):
        pass


def gradio_script(mod):
    """The handler's downlink items and uplink frames over a fake socket."""
    h = mod.MoshiHandler("https://example:8998")
    pcm1 = (np.arange(1920, dtype=np.float32) / 4000.0).tobytes()
    pcm2 = (np.ones(960, np.float32) * 0.25).tobytes()
    h.ws = FakeWs([proto.msg(proto.MT_METADATA, b"not json"),
                   proto.msg(proto.MT_METADATA, json.dumps({"raw_pcm": True}).encode()),
                   proto.msg(proto.MT_PCM, pcm1), proto.msg(proto.MT_TEXT, "hello".encode()),
                   proto.msg(proto.MT_PCM, pcm2), proto.msg(proto.MT_PCM, pcm2), b""])
    items = []
    for _ in range(5):
        out = h.emit()
        if isinstance(out, tuple):
            items.append(("pcm", out[0], out[1].shape, out[1].tobytes()))
        elif out is None:
            items.append(None)
        else:
            items.append(("text", out.args))
    mic = np.ones((1, 960), np.int16) * 16384
    h.receive((24000, mic))
    h.receive((24000, mic))
    h.reset()
    c = h.copy()
    return (h.ws_url, items, h.ws.sent, type(c) is type(h), c.url, c.output_sample_rate,
            c.expected_layout, c.output_frame_size, c.input_sample_rate)


def test_gradio_handler_equal_jax():
    assert gradio_script(client_gradio) == gradio_script(jgradio)


def test_gradio_main_names_the_missing_package():
    missing = [m for m in client_gradio.EXTRAS if not _importable(m)]
    if not missing:
        pytest.skip("the gradio extras are installed")
    with pytest.raises(ImportError, match=repr(missing[0])):
        client_gradio.main(["--url", "http://localhost:8998"])


def _importable(name: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(name) is not None


# ------------------------------------------- client.run against the port's server
@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_checkpoint.make(tmp_path_factory.mktemp("tiny"))


def test_client_session_against_the_port_server(ckpt, tmp_path):
    """client.run streams a wav (opus through native.py) to the port's
    ServerState on 127.0.0.1 at 8x real time: the handshake arrives, text
    and audio come back, and the reply wav is written."""
    from aiohttp import web
    from aiohttp.test_utils import TestServer
    from moshi_tpu_torch.models.loaders import CheckpointInfo
    from moshi_tpu_torch.serve.server import ServerState
    from moshi_tpu_torch.text.spm import SentencePieceTokenizer

    info = CheckpointInfo.from_dir(ckpt)
    mimi, mimi_params = info.get_mimi(device="cpu")
    lm, lm_params = info.get_moshi(device="cpu")
    state = ServerState(mimi, mimi_params, lm, lm_params, info=info,
                        text_tokenizer=SentencePieceTokenizer(info.tokenizer_path),
                        device="cpu", use_sampling=False)
    state.warmup()
    frames = 8
    in_wav, out_wav = tmp_path / "in.wav", tmp_path / "out.wav"
    audio.write_wav(in_wav, (np.random.RandomState(0).randn(1920 * frames) * 0.05
                             ).astype(np.float32), 24000)

    async def scenario():
        app = web.Application()
        app.router.add_get("/api/chat", state.handle_chat)
        srv = TestServer(app, host="127.0.0.1")
        await srv.start_server()
        try:
            return await client.run(f"ws://127.0.0.1:{srv.port}/api/chat", str(in_wav),
                                    str(out_wav), rt_factor=8.0)
        finally:
            await srv.close()

    text = asyncio.run(scenario())
    assert isinstance(text, str) and text.strip()
    assert state.steps_done >= frames // 2
    pcm, sr = audio.read_wav(out_wav)
    assert sr == 24000 and pcm.shape[-1] >= 1920
