"""Gradio WebRTC demo client for a moshi_tpu_torch, moshi_tpu (or
reference) server (counterpart of moshi_tpu/client_gradio.py).

Behavioral analog of the reference `moshi/moshi/client_gradio.py:1-161`:
a `gr.Blocks` page with a WebRTC audio widget streaming mic audio to the
server's `/api/chat` websocket and playing the reply, plus a chatbot pane
accumulating the streamed text.

Differences from the reference (TPU-stack idioms):
- Audio rides the raw-PCM MT-10 extension when the server grants it
  (negotiated via metadata {"raw_pcm": true}, see serve/protocol.py) — no
  opus codec needed on the client.  Against a reference server the client
  falls back to ogg-opus framing via the port's opus codec (native.py).
- `gradio`, `gradio_webrtc` and `websockets` are optional extras, imported
  only where they are used: in `main()` (which raises an ImportError naming
  the missing package) and in the socket's connect.  The handler's protocol
  logic is plain Python over a stand-in of gradio_webrtc's StreamHandler
  fields; `main()` mixes it with the real StreamHandler.

Usage: python -m moshi_tpu_torch.client_gradio --url http://localhost:8998
"""

import argparse
import importlib
import json

import numpy as np

from .serve import protocol as proto

EXTRAS = ("gradio", "gradio_webrtc", "websockets")


class StreamFields:
    """The fields of gradio_webrtc's StreamHandler that the handler reads."""

    def init_stream(self, expected_layout="mono", output_sample_rate=24000,
                    output_frame_size=480, input_sample_rate=24000):
        self.expected_layout = expected_layout
        self.output_sample_rate = output_sample_rate
        self.output_frame_size = output_frame_size
        self.input_sample_rate = input_sample_rate


class AdditionalOutputs:
    """A text piece for the page (main()'s handler yields gradio_webrtc's
    own class instead)."""

    def __init__(self, *args):
        self.args = args


FRAME_SIZE = 1920
SAMPLE_RATE = 24000


class MoshiHandler(StreamFields):
    """gradio_webrtc StreamHandler bridging WebRTC audio <-> the moshi
    websocket protocol (rust/protocol.md)."""

    text_output = AdditionalOutputs

    def __init__(self, url: str, expected_layout: str = "mono",
                 output_sample_rate: int = SAMPLE_RATE,
                 output_frame_size: int = 480) -> None:
        self.url = url
        scheme, rest = url.split("://", 1)
        ws_scheme = "wss" if scheme in ("https", "wss") else "ws"
        self.ws_url = f"{ws_scheme}://{rest}/api/chat"
        self.ws = None
        self._generator = None
        self._raw_pcm = False
        self._opus_reader = None
        self._opus_writer = None
        self._pending_out = np.zeros((0,), np.float32)
        self._pending_in = np.zeros((0,), np.float32)
        self.init_stream(expected_layout, output_sample_rate,
                         output_frame_size, input_sample_rate=SAMPLE_RATE)

    # ------------------------------------------------------------- transport
    def _connect(self):
        import websockets.sync.client
        self.ws = websockets.sync.client.connect(self.ws_url)
        # offer the raw-PCM extension; the server answers with metadata if it
        # supports it (serve/server.py), a reference server stays silent and
        # we fall back to opus lazily on the first audio frame.
        self.ws.send(proto.msg(proto.MT_METADATA,
                               json.dumps({"raw_pcm": True,
                                           "client": "moshi_tpu-gradio"})
                               .encode()))

    def _ensure_opus(self):
        if self._opus_writer is None:
            from .native import load
            moshi_native = load()
            self._opus_writer = moshi_native.OpusStreamWriter(SAMPLE_RATE)
            self._opus_reader = moshi_native.OpusStreamReader(SAMPLE_RATE)

    # ------------------------------------------------- gradio_webrtc callbacks
    def receive(self, frame) -> None:
        """Mic frame in: int16 WebRTC audio -> f32 -> ws."""
        if self.ws is None:
            self._connect()
        _, array = frame
        pcm = array.squeeze().astype(np.float32) / 32768.0
        if self._raw_pcm:
            self._pending_in = np.concatenate([self._pending_in, pcm])
            while self._pending_in.shape[-1] >= FRAME_SIZE:
                chunk = self._pending_in[:FRAME_SIZE]
                self._pending_in = self._pending_in[FRAME_SIZE:]
                self.ws.send(proto.msg(
                    proto.MT_PCM, np.ascontiguousarray(chunk).tobytes()))
        else:
            self._ensure_opus()
            payload = self._opus_writer.append_pcm(
                np.ascontiguousarray(pcm))
            if payload:
                self.ws.send(proto.msg(proto.MT_AUDIO, payload))

    def _messages(self):
        """Decode incoming ws messages into (sample_rate, pcm) audio chunks
        and AdditionalOutputs(text) items."""
        for message in self.ws:
            if not message:
                yield None
                continue
            kind, payload = message[0], message[1:]
            if kind == proto.MT_METADATA:
                try:
                    meta = json.loads(payload.decode("utf-8"))
                except (UnicodeDecodeError, json.JSONDecodeError):
                    continue
                if isinstance(meta, dict) and meta.get("raw_pcm"):
                    self._raw_pcm = True
            elif kind == proto.MT_PCM:
                yield from self._audio(np.frombuffer(payload, np.float32))
            elif kind == proto.MT_AUDIO:
                self._ensure_opus()
                pcm = np.frombuffer(self._opus_reader.append_bytes(payload),
                                    np.float32)
                yield from self._audio(pcm)
            elif kind == proto.MT_TEXT:
                yield self.text_output(payload.decode("utf-8"))

    def _audio(self, pcm: np.ndarray):
        self._pending_out = np.concatenate([self._pending_out, pcm])
        while self._pending_out.shape[-1] >= FRAME_SIZE:
            chunk = self._pending_out[:FRAME_SIZE]
            self._pending_out = self._pending_out[FRAME_SIZE:]
            yield (self.output_sample_rate, chunk.reshape(1, -1))

    def emit(self):
        if self.ws is None:
            return None
        if self._generator is None:
            self._generator = self._messages()
        try:
            return next(self._generator)
        except StopIteration:
            self.reset()
            return None

    def reset(self) -> None:
        self._generator = None
        self._pending_out = np.zeros((0,), np.float32)
        self._pending_in = np.zeros((0,), np.float32)

    def copy(self) -> "MoshiHandler":
        return type(self)(self.url, self.expected_layout,
                          self.output_sample_rate, self.output_frame_size)

    def shutdown(self) -> None:
        if self.ws is not None:
            self.ws.close()


def load_extras():
    """The demo's optional packages, or an ImportError naming the first one
    missing."""
    mods = {}
    for name in EXTRAS:
        try:
            mods[name] = importlib.import_module(name)
        except ImportError as e:
            raise ImportError(
                f"client_gradio needs the optional package {name!r} (demo extras: "
                "pip install gradio gradio-webrtc websockets)") from e
    return mods


def main(argv=None):
    mods = load_extras()
    gr = mods["gradio"]
    WebRTC, StreamHandler = mods["gradio_webrtc"].WebRTC, mods["gradio_webrtc"].StreamHandler

    class WebRTCHandler(MoshiHandler, StreamHandler):
        text_output = mods["gradio_webrtc"].AdditionalOutputs

        def init_stream(self, *args, **kwargs):
            StreamHandler.__init__(self, *args, **kwargs)

    parser = argparse.ArgumentParser("client_gradio")
    parser.add_argument("--url", type=str, required=True,
                        help="URL of the moshi server, e.g. http://host:8998")
    parser.add_argument("--time-limit", type=int, default=90,
                        help="per-conversation limit in seconds")
    args = parser.parse_args(argv)

    with gr.Blocks(title="moshi_tpu") as demo:
        gr.Markdown("# moshi_tpu · full-duplex dialogue (WebRTC)")
        chatbot = gr.Chatbot(type="messages", value=[])
        webrtc = WebRTC(label="Conversation", modality="audio",
                        mode="send-receive")
        webrtc.stream(WebRTCHandler(args.url), inputs=[webrtc, chatbot],
                      outputs=[webrtc], time_limit=args.time_limit)

        def append_text(history, piece):
            if not history:
                history.append({"role": "assistant", "content": ""})
            history[-1]["content"] += piece
            return history

        webrtc.on_additional_outputs(append_text, inputs=[chatbot],
                                     outputs=chatbot, queue=False,
                                     show_progress="hidden")
        demo.launch()


if __name__ == "__main__":
    main()
