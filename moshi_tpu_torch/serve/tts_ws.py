"""Streaming text-to-speech over a websocket, one session at a time
(counterpart of moshi_tpu/serve/tts_ws.py): words in, audio out, while
the words are still coming.

    python -m moshi_tpu_torch.serve.tts_ws --checkpoint-dir DIR [--device cuda]

The protocol (JSON text frames in, binary and JSON out):
  -> {"type": "Text", "text": "word"}            queue words
  -> {"type": "Voice", "embeddings": [...], "shape": [T, D]}  the voice
  -> {"type": "Eos"}                             no more words
  <- {"type": "Ready"}                           the session has started
  <- b"\\x01" + ogg-opus audio
  <- {"type": "Text", "text": ..., "start_s": ...}  a word's timing
  <- {"type": "Error", "message": ...}           a bad message (the session goes on)
  <- {"type": "Eos"}                             the audio is complete
Generation pauses while the session is starved of words; a client that
leaves while it waits for words ends its session as an Eos would.

`TTSStreamer` is one session at B = 1: a BatchedTTSState of one slot
(serve/batched_tts.py), whose two programs run as CUDA graphs on the card.
Unlike the JAX package, which builds a streamer with its own compiled
programs for every connection, a server here holds one captured streamer
and its sessions take it in turn: the next session resets it in place
(the generator seeded again, so a session's draws do not depend on the
ones before it), and a connection waits while another session runs.
"""

import argparse
import asyncio
import collections
import json
import time

import numpy as np

from ..utils.graphs import run_on_device
from .batched_tts import BatchedTTSState

OPUS_RATES = (8000, 12000, 16000, 24000, 48000)


def make_audio_encoder(sample_rate: int):
    """The streaming ogg-opus encoder of the outbound audio (serve's native
    codec; raises when it cannot be built, e.g. without libopus), or, at
    a rate opus does not take, raw f32le PCM."""
    if sample_rate in OPUS_RATES:
        from ..native import load
        return load().OpusStreamWriter(sample_rate)

    class _Raw:
        def append_pcm(self, pcm):
            return np.ascontiguousarray(pcm, np.float32).tobytes()

    return _Raw()


class TTSStreamer:
    """Incremental TTS of one session at a time: words can be fed while the
    audio is being made; a session starved of words pauses.  Over a
    BatchedTTSState of one slot on `device` (its keywords); `reset()` starts
    the next session in place."""

    def __init__(self, tts, lm_params, mimi_params, **engine_kwargs):
        self.tts = tts
        self.engine = BatchedTTSState(tts, lm_params, mimi_params, 1, **engine_kwargs)
        self.rng_seed = engine_kwargs.get("rng_seed", 0)
        self.lock = asyncio.Lock()  # the session that holds the streamer
        # host ms of each frame served (graph 1, the machine, graph 2)
        self.frame_times = collections.deque(maxlen=10_000)
        self.engine.open_slot(0)

    @property
    def device(self):
        return self.engine.device

    @property
    def session(self):
        return self.engine.slots[0]

    def warmup(self):
        self.engine.warmup()

    def capture(self):
        self.engine.capture()

    def reset(self):
        """A new session: fresh streaming state (applied before its first
        frame), no voice, the generator seeded again."""
        self.engine.close_slot(0)
        self.engine.open_slot(0)
        self.engine.generator.manual_seed(self.rng_seed)

    def set_voice(self, voice_embedding: np.ndarray):
        """The session's speaker embedding [T, D] (ignored by a model
        without speaker conditioning)."""
        self.engine.set_slot_voice(0, voice_embedding)

    def feed_words(self, words: list[str]):
        """Queue text, normalized; `<break time="Ns"/>` becomes padding."""
        self.engine.feed_words(0, words)

    def feed_eos(self):
        self.engine.feed_eos(0)

    @property
    def eos(self) -> bool:
        return self.session.eos

    @property
    def offset(self) -> int:
        return self.session.offset

    @property
    def starved(self) -> bool:
        """Whether the machine would pad only because no words are queued
        yet (and the client has not said it is done)."""
        return self.engine._starved(self.session)

    @property
    def finished(self) -> bool:
        return self.engine._finished(self.session)

    def apply_pending_ops(self):
        """The queued reset and voice change, in place (between frames)."""
        self.engine.apply_pending_ops()

    def step(self):
        """One frame.  Returns (PCM [frame_size] or None, Text events)."""
        self.apply_pending_ops()
        return self.step_frame()

    def step_frame(self):
        """step() without the queued ops (a server applies them on its event
        loop's thread and runs the frame on a worker thread)."""
        s = self.session
        t0 = time.perf_counter()
        self.engine.step_batch([0], [s])
        self.frame_times.append((time.perf_counter() - t0) * 1e3)
        pcm, events = None, []
        for kind, payload in s.outbox:
            if kind == "event":
                events.append(payload)
            elif kind == "pcm":
                pcm = payload
        s.outbox.clear()
        return pcm, events


async def run_session(streamer: TTSStreamer, messages, send):
    """One session on a reset streamer: `messages` is an async iterator of
    the client's JSON texts, `send` an async callable taking a JSON message
    (a dict) or a PCM frame (an array).  Frames run on a worker thread;
    ends with an Eos message once the audio is complete."""
    recv_done = asyncio.Event()

    async def receiver():
        # recv_done is set on every exit: a receiver that has ended while
        # the session is starved means no word will ever come
        try:
            async for data in messages:
                try:
                    msg = json.loads(data)
                    kind = msg.get("type")
                    if kind == "Text":
                        streamer.feed_words([str(msg["text"])])
                    elif kind == "Voice":
                        streamer.set_voice(np.asarray(msg["embeddings"], np.float32)
                                           .reshape(msg["shape"]))
                    elif kind == "Eos":
                        streamer.feed_eos()
                except Exception as e:
                    # one bad message must not end the session
                    await send({"type": "Error", "message": f"bad message: {e}"})
        finally:
            recv_done.set()

    recv_task = asyncio.create_task(receiver())
    try:
        while not streamer.finished:
            if recv_done.is_set() and not streamer.eos:
                streamer.feed_eos()
            if recv_task.done() and recv_task.exception() is not None:
                raise recv_task.exception()
            if streamer.starved:
                await asyncio.sleep(0.01)
                continue
            streamer.apply_pending_ops()
            pcm, events = await asyncio.to_thread(run_on_device, streamer.device,
                                                  streamer.step_frame)
            for e in events:
                await send(e)
            if pcm is not None:
                await send(pcm)
            await asyncio.sleep(0)
        await send({"type": "Eos"})
    finally:
        recv_task.cancel()


async def handle_tts_socket(request, streamer: TTSStreamer):
    """aiohttp handler of the streaming TTS route: waits for the streamer,
    resets it, says Ready, then runs the session."""
    from aiohttp import WSMsgType, web

    ws = web.WebSocketResponse()
    await ws.prepare(request)
    writer = make_audio_encoder(streamer.tts.mimi.config.sample_rate)

    async def messages():
        async for message in ws:
            if message.type == WSMsgType.TEXT:
                yield message.data

    async def send(item):
        if isinstance(item, dict):
            await ws.send_str(json.dumps(item))
            return
        data = writer.append_pcm(np.ascontiguousarray(item, np.float32))
        if data:
            await ws.send_bytes(b"\x01" + data)

    try:
        async with streamer.lock:
            streamer.reset()
            await ws.send_str(json.dumps({"type": "Ready"}))
            await run_session(streamer, messages(), send)
    finally:
        await ws.close()
    return ws


def build_streamer(info, *, rng_seed: int = 0, **knobs) -> TTSStreamer:
    """A TTSStreamer over the checkpoint of `info`, with the knobs of
    batched_tts.load_tts; not warmed up."""
    from .batched_tts import load_tts

    tts, lm_params, mimi_params, kw = load_tts(info, **knobs)
    return TTSStreamer(tts, lm_params, mimi_params, rng_seed=rng_seed, **kw)


def main(argv=None):
    import gc

    from aiohttp import web

    from ..models.loaders import CheckpointInfo
    from ..utils.serving import serving_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8990)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--temp", type=float, default=0.6)
    ap.add_argument("--voice-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = serving_device(args.device)
    streamer = build_streamer(CheckpointInfo.from_dir(args.checkpoint_dir), device=device,
                              temp=args.temp, voice_dir=args.voice_dir)
    streamer.warmup()
    streamer.capture()
    gc.freeze()  # what the warm-up made lives as long as the server
    app = web.Application()
    app.router.add_get("/api/tts_streaming", lambda req: handle_tts_socket(req, streamer))
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
