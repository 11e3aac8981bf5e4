"""The full-duplex websocket server (counterpart of moshi_tpu/serve/server.py):
one session at a time over `/api/chat`, in the reference's binary protocol
(serve/protocol.py), each 80 ms frame Mimi encode -> LMGen.step -> Mimi
decode on the card.

    python -m moshi_tpu_torch.serve.server --checkpoint-dir DIR [--device cuda]

`main` reads the checkpoint through `CheckpointInfo` (config.json, native
or PyTorch-named weights, the SentencePiece tokenizer), warms up and
serves.  A session opens with the handshake (MT 0), then takes ogg-opus
audio (MT 1) or, after the client's `{"raw_pcm": true}` metadata, raw f32
PCM frames (MT 10), and answers with audio in the same form and text
pieces (MT 2, or MT 7 with a confidence colour).  Its first frame only
primes the encoder (the reference's first-frame skip).  Controls pause
(input discarded), start and restart (a fresh session in place, answered
with `{"event": "restarted"}`) are honoured, pings answered, and an error
from the client ends the session.  Query parameters set the session's
sampling (`_SESSION_PARAMS`), its seed (`text_seed`, `audio_seed`) and
`max_steps`; a client that passes any of them also gets the effective
config echoed (MT 4) and, while it waits in the FIFO queue for the one
session, its queue position (MT 4, once a second).

The session loop reads an async iterator of binary payloads and writes
through a `send` coroutine, so the same code runs under aiohttp
(`handle_chat`) and under an in-process transport; only `handle_chat`,
`make_app` and `main` import aiohttp, when called.

Not ported yet (ROADMAP A.12): session resume of this server (the batched
servers have it), the migration vault, the HTTP queue API, `--tp`,
`--ssl` (the worker has it) and `--log-dir`.
"""

import argparse
import asyncio
import gc
import json
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..models.lm import UNGENERATED_TOKEN
from ..models.lm_gen import LMGen, LMGenConfig
from ..utils.graphs import GraphedStep
from ..utils.quantize import QTensor, QTensor4
from ..utils.trees import copy_into
from . import protocol as proto
from .metrics import CONNECT_COUNT, OPEN_CHANNELS


def log(level: str, msg: str):
    print(f"[{level}] {msg}", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, (QTensor, QTensor4)):
        return [tree.q, tree.scale]
    return [tree]


class _SessionGen:
    """An LMGen with its streaming state and its (graphed) step, which
    writes the step's tokens, and the text token's probability when
    `colored`, into the engine's output buffers."""

    def __init__(self, lm_gen: LMGen, state: dict, lm_params: dict, out: torch.Tensor,
                 prob: torch.Tensor, colored: bool, graphed: bool, device,
                 generator: torch.Generator):
        self.lm_gen, self.state, self.lm_params = lm_gen, state, lm_params
        self.out, self.prob, self.colored = out, prob, colored
        self.step = GraphedStep(self._step, graphed=graphed, device=device,
                                generators=(generator,))

    def _step(self, codes):
        if self.colored:
            out, prob, _ = self.lm_gen.step_with_text_prob(self.lm_params, self.state, codes)
            self.prob.copy_(prob)
        else:
            out, _ = self.lm_gen.step(self.lm_params, self.state, codes)
        self.out.copy_(out)
        return self.out


class _LazyOpus:
    """The opus codec's stream object, made at first use: raw-PCM sessions
    never load the codec."""

    def __init__(self, kind: str, rate: int):
        self._kind, self._rate, self._inst = kind, rate, None

    def __getattr__(self, name):
        if self._inst is None:
            from .. import native
            self._inst = getattr(native.load(), self._kind)(self._rate)
        return getattr(self._inst, name)


class ServerState:
    """One model, B = 1 streaming state on `device`, one session at a time.
    The codec runs in the dtype of its parameters; the KV cache is bf16, as
    in the JAX server.

    The frame runs as the JAX server's three programs: Mimi encode,
    LMGen.step, and Mimi decode (skipped while the LM's output is still
    UNGENERATED_TOKEN).  `graphed` (the default on a CUDA device) captures
    each as a CUDA graph at its first frame after `warmup()` and replays
    it at every frame after; the state, the generator and the PCM input
    buffer are allocated once and written in place.  `graphed=False` runs
    the same functions eagerly (the CPU's only path).

    Each set of session sampling overrides gets its own LMGen and captured
    step, made (and warmed) the first time a session asks for it and kept
    for later ones; they share the temporal transformer's state, the
    generator and the output buffers that the decode graph reads."""

    def __init__(self, mimi, mimi_params, lm, lm_params, *, info=None, text_tokenizer=None,
                 cfg_coef: float = 1.0, device="cuda", rng_seed: int = 0,
                 graphed: bool | None = None, session_timeout: float = 360.0,
                 **lm_gen_kwargs):
        self.info = info
        self.mimi, self.mimi_params = mimi, mimi_params
        self.lm, self.lm_params = lm, lm_params
        self.text_tokenizer = text_tokenizer
        self.device = dev = torch.device(device)
        self.graphed = dev.type == "cuda" if graphed is None else graphed
        if self.graphed and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        for t in _leaves(lm_params) + _leaves(mimi_params):
            if t.device.type != dev.type:
                raise ValueError(f"a parameter lies on {t.device}, the server on {dev}")
        self.mimi_dtype = md = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        self.frame_size = mimi.frame_size
        merged = dict(lm_gen_kwargs)
        merged.setdefault("cfg_coef", cfg_coef)
        # confidence-coloured text (MT 7): the default for hibiki checkpoints
        self.colored_text = bool(merged.pop(
            "colored_text", info is not None and info.model_type == "hibiki"))
        self.session_seed = self.rng_seed = rng_seed
        self.session_timeout = session_timeout
        self.max_steps = 4500
        self.generator = torch.Generator(device=dev)
        self.enc_state = mimi.init_encode_state(1, md, dev)
        self.dec_state = mimi.init_decode_state(1, md, dev)
        self.pcm_in = torch.zeros(self.frame_size, dtype=torch.float32, device=dev)
        self.tokens_out = torch.zeros((1, 1 + lm.config.dep_q, 1), dtype=torch.long,
                                      device=dev)
        self.prob_out = torch.zeros(1, dtype=torch.float32, device=dev)
        self.encode = GraphedStep(self._encode, graphed=self.graphed, device=dev)
        self.decode = GraphedStep(self._decode, graphed=self.graphed, device=dev)
        default = LMGen(lm, LMGenConfig.from_dict(merged))
        self._gens = {(): self._make_gen(default, None)}
        self._gen = self._gens[()]
        self.session_tokens: list[np.ndarray] = []
        self.lock = asyncio.Lock()
        # session ids in arrival order: asyncio.Lock wakes its waiters in
        # FIFO order, so a session's index is its queue position
        self._session_order: list[int] = []
        self._session_counter = 0
        self.reset()

    # the active session's LMGen, state and step
    @property
    def lm_gen(self) -> LMGen:
        return self._gen.lm_gen

    @property
    def gen_state(self) -> dict:
        return self._gen.state

    @property
    def step(self) -> GraphedStep:
        return self._gen.step

    def _make_gen(self, lm_gen: LMGen, shared: _SessionGen | None) -> _SessionGen:
        state = lm_gen.init_state(1, self.generator, torch.bfloat16, self.device)
        if shared is not None:
            state["transformer"] = shared.state["transformer"]
        return _SessionGen(lm_gen, state, self.lm_params, self.tokens_out, self.prob_out,
                           self.colored_text, self.graphed, self.device, self.generator)

    def _encode(self, pcm):
        codes, _ = self.mimi.encode_step(self.mimi_params, self.enc_state,
                                         pcm.to(self.mimi_dtype)[None, None])
        return codes

    def _decode(self, out):
        pcm, _ = self.mimi.decode_step(self.mimi_params, self.dec_state,
                                       out[:, 1:].clamp(min=0))
        return pcm[0, 0].float()

    # ------------------------------------------------------- session config
    # query parameter -> (LMGenConfig field, parser), the reference client's
    # names
    _SESSION_PARAMS = {
        "text_temperature": ("temp_text", float),
        "text_topk": ("top_k_text", int),
        "audio_temperature": ("temp", float),
        "audio_topk": ("top_k", int),
        "pad_mult": ("padding_bonus", float),
        "repetition_penalty": ("text_rep_penalty", float),
        "repetition_penalty_context": ("text_rep_context", int),
    }
    # any of these marks a client that knows this server: it gets the
    # config echo and queue positions (a bare reference client sees the
    # handshake first)
    _KNOWN_PARAMS = (set(_SESSION_PARAMS) |
                     {"text_seed", "audio_seed", "max_steps", "resume", "resume_support"})

    def apply_session_config(self, query) -> dict:
        """Select (or make) the LMGen for the session's sampling overrides
        in `query` (str -> str; unknown keys and unparsable values are
        ignored), fold `text_seed` / `audio_seed` into the session seed and
        set `max_steps`.  Returns the effective config, the metadata
        echo."""
        overrides = {}
        for name, (field, parse) in self._SESSION_PARAMS.items():
            if name in query:
                try:
                    overrides[field] = parse(query[name])
                except ValueError:
                    pass
        seed = self.rng_seed
        for name in ("text_seed", "audio_seed"):
            if name in query:
                try:
                    # one generator draws text and audio: both seeds fold in
                    seed = (seed * 1000003 + int(query[name])) & 0x7FFFFFFF
                except ValueError:
                    pass
        self.session_seed = seed
        try:
            self.max_steps = min(4500, int(query.get("max_steps", 4500)))
        except ValueError:
            self.max_steps = 4500
        self._gen = self._gen_for_overrides(overrides)
        return self._session_cfg_dict()

    def _gen_for_overrides(self, overrides: dict) -> _SessionGen:
        """The memoized LMGen and step of an override set, over the
        server's default config, warmed up when new (the caller resets)."""
        key = tuple(sorted(overrides.items()))
        if key not in self._gens:
            default = self._gens[()]
            gen = self._make_gen(LMGen(self.lm, replace(default.lm_gen.gc, **overrides)),
                                 default)
            codes = torch.zeros((1, gen.lm_gen.num_input_audio, 1), dtype=torch.long,
                                device=self.device)
            for _ in range(2):
                gen.step.warm_up(codes)
            self._gens[key] = gen
            log("info", f"made session config {overrides}")
        return self._gens[key]

    def _session_cfg_dict(self) -> dict:
        c = self.lm_gen.gc
        return {"text_temperature": c.temp_text, "text_topk": c.top_k_text,
                "audio_temperature": c.temp, "audio_topk": c.top_k,
                "pad_mult": c.padding_bonus, "repetition_penalty": c.text_rep_penalty,
                "repetition_penalty_context": c.text_rep_context,
                "max_steps": self.max_steps, "seed": self.session_seed}

    # --------------------------------------------------------------- frames
    def reset(self):
        """A fresh session: the streaming states rewritten in place with the
        values of new ones, the generator reseeded with `session_seed`.  No
        tensor moves, so captured graphs stay valid."""
        dev, md = self.device, self.mimi_dtype
        copy_into(self.enc_state, self.mimi.init_encode_state(1, md, dev))
        copy_into(self.dec_state, self.mimi.init_decode_state(1, md, dev))
        copy_into(self.gen_state, self.lm_gen.init_state(1, None, torch.bfloat16, dev))
        self.generator.manual_seed(self.session_seed)
        self.steps_done = 0
        self.session_tokens = []

    def reset_encoder(self):
        copy_into(self.enc_state, self.mimi.init_encode_state(1, self.mimi_dtype, self.device))

    def warmup(self):
        """Run zero frames eagerly through the whole path (decode included:
        max_delay + 2 frames, at least 4), on the graphs' side streams when
        graphed, then reset.  A graphed engine needs it before its first
        frame."""
        for _ in range(max(4, self.lm.config.max_delay + 2)):
            self._frame(np.zeros(self.frame_size, np.float32), warm=True)
        self.reset()

    def capture(self):
        """Capture the three graphs now (zero frames until one is decoded),
        then reset: a server whose card other engines' threads use captures
        nothing while serving its default config.  Eager engines do
        nothing."""
        if self.graphed:
            for _ in range(self.lm.config.max_delay + 2):
                self.step_frame(np.zeros(self.frame_size, np.float32))
            self.reset()

    def skip_frame(self, chunk: np.ndarray):
        """The session's first frame: encoded, then the encoder reset, so
        the next frame sees the encoder's left padding again (the
        reference's first-frame skip)."""
        self.pcm_in.copy_(torch.as_tensor(chunk, dtype=torch.float32))
        self.encode(self.pcm_in)
        self.reset_encoder()

    def step_frame(self, chunk: np.ndarray):
        """One 80 ms frame of PCM [frame_size] -> (pcm [frame_size] float32
        or None, text token or None).  Nothing is decoded while the LM's
        output is still UNGENERATED_TOKEN (the first max_delay frames)."""
        return self._frame(chunk, warm=False)[:2]

    def _frame(self, chunk, warm: bool):
        """-> (pcm or None, text token or None, its probability or None)."""
        def run(step, *args):
            return step.warm_up(*args) if warm else step(*args)

        self.steps_done += 1
        self.pcm_in.copy_(torch.as_tensor(chunk, dtype=torch.float32))
        out = run(self.step, run(self.encode, self.pcm_in))
        out_np = out.cpu().numpy().copy()  # a copy: out is the step's output buffer
        if (out_np == UNGENERATED_TOKEN).any():
            return None, None, None
        prob = float(self.prob_out.cpu()) if self.colored_text else None
        self.session_tokens.append(out_np[0, :, 0])
        pcm = run(self.decode, out)
        return pcm.cpu().numpy(), int(out_np[0, 0, 0]), prob

    # -------------------------------------------------------------- sessions
    def _text_msg(self, token: int, prob: float | None) -> bytes | None:
        """MT 2 text, or MT 7 with a colour byte (0-10) first; None for the
        pad tokens and without a tokenizer."""
        if token in (0, 3) or self.text_tokenizer is None:
            return None
        text = self.text_tokenizer.id_to_piece(token).replace("▁", " ").encode("utf-8")
        if prob is None:
            return proto.msg(proto.MT_TEXT, text)
        return proto.msg(proto.MT_COLOREDTEXT, bytes([max(0, min(10, round(prob * 10)))]) + text)

    async def run_session(self, query: dict, messages, send, closed=lambda: False):
        """Queue for the session lock, then serve one session.  `messages`
        is an async iterator of the client's binary payloads, `send` a
        coroutine that sends one, `closed()` true once the client is
        gone."""
        CONNECT_COUNT.inc()
        sid = self._session_counter
        self._session_counter += 1
        self._session_order.append(sid)
        notify = bool(self._KNOWN_PARAMS & set(query))
        if not await self._acquire_session(sid, notify, send, closed):
            return
        OPEN_CHANNELS.inc()
        try:
            await self._serve_session(query, messages, send)
        finally:
            OPEN_CHANNELS.dec()
            self._session_order.remove(sid)
            self.lock.release()

    async def _acquire_session(self, sid: int, notify: bool, send, closed) -> bool:
        """FIFO-acquire the session lock, sending the queue position (MT 4)
        once a second to a client that opted in.  False, without the lock,
        when the client leaves while queued."""
        acquire = asyncio.ensure_future(self.lock.acquire())
        try:
            while not acquire.done():
                pos = self._session_order.index(sid)
                if pos > 0 and notify:
                    await send(proto.msg(proto.MT_METADATA, json.dumps(
                        {"status": "wait", "queue_position": pos}).encode()))
                if closed():
                    raise ConnectionResetError("the client closed its socket")
                await asyncio.wait({acquire}, timeout=1.0)
            return True
        except (ConnectionError, RuntimeError, asyncio.CancelledError) as e:
            # a failed send or a closed socket: the client is gone
            acquire.cancel()
            try:
                await acquire
            except asyncio.CancelledError:
                pass
            else:  # the lock came before the cancellation
                self.lock.release()
            self._session_order.remove(sid)
            log("info", f"queued client {sid} left")
            if isinstance(e, asyncio.CancelledError):
                raise
            return False

    async def _serve_session(self, query: dict, messages, send):
        session_cfg = self.apply_session_config(query)
        self.reset()
        session_cfg["resumed"] = False
        await send(proto.handshake())
        if self._KNOWN_PARAMS & set(query):
            await send(proto.msg(proto.MT_METADATA, json.dumps(session_cfg).encode()))
        try:
            await asyncio.wait_for(self._recv_loop(messages, send), timeout=self.session_timeout)
        except asyncio.TimeoutError:
            log("info", "session timeout")
        log("info", "connection closed")

    async def _recv_loop(self, messages, send, skip_frames: int = 1):
        """Serve the session's messages until the client goes, sends an
        error, or the session reaches max_steps."""
        rate = self.mimi.config.sample_rate
        opus_reader = _LazyOpus("OpusStreamReader", rate)
        opus_writer = _LazyOpus("OpusStreamWriter", rate)
        all_pcm = np.zeros((0,), np.float32)
        paused = raw_pcm = False
        async for data in messages:
            if not data:
                continue
            kind = data[0]
            if kind == proto.MT_PCM and raw_pcm:
                pcm = np.frombuffer(data[1:len(data) - (len(data) - 1) % 4], np.float32)
            elif kind == proto.MT_AUDIO:
                pcm = np.frombuffer(opus_reader.append_bytes(data[1:]), np.float32)
            else:
                if kind == proto.MT_CONTROL and len(data) >= 2:
                    ctrl = data[1]
                    log("info", f"control: {proto.CONTROL_NAMES.get(ctrl, ctrl)}")
                    if ctrl == proto.CTRL_PAUSE:
                        paused = True
                        all_pcm = np.zeros((0,), np.float32)
                    elif ctrl == proto.CTRL_START:
                        paused = False
                    elif ctrl == proto.CTRL_RESTART:
                        self.reset()
                        all_pcm = np.zeros((0,), np.float32)
                        skip_frames, paused = 1, False
                        await send(proto.msg(proto.MT_METADATA,
                                             json.dumps({"event": "restarted"}).encode()))
                elif kind == proto.MT_METADATA:
                    try:
                        meta = json.loads(data[1:].decode("utf-8"))
                    except (UnicodeDecodeError, json.JSONDecodeError):
                        meta = None
                    if isinstance(meta, dict) and meta.get("raw_pcm"):
                        raw_pcm = True
                        await send(proto.msg(proto.MT_METADATA, json.dumps(
                            {"raw_pcm": True, "sample_rate": rate,
                             "frame_size": self.frame_size}).encode()))
                    log("info", f"client metadata: {meta}")
                elif kind == proto.MT_ERROR:
                    log("error", f"client error: {data[1:].decode('utf-8', 'replace')}")
                    return
                elif kind == proto.MT_PING:
                    await send(proto.msg(proto.MT_PING))
                # other types (endTurn, unknown ones) are discarded
                continue
            if paused or pcm.size == 0:
                continue  # a paused session's opus is still decoded, in step
            all_pcm = np.concatenate([all_pcm, pcm])
            while all_pcm.shape[-1] >= self.frame_size:
                chunk, all_pcm = all_pcm[:self.frame_size], all_pcm[self.frame_size:]
                if skip_frames:
                    self.skip_frame(chunk)
                    skip_frames -= 1
                    continue
                out_pcm, token, prob = self._frame(chunk, warm=False)
                if self.steps_done >= self.max_steps:
                    log("info", f"max_steps {self.max_steps} reached")
                    return
                if out_pcm is None:
                    continue
                if raw_pcm:
                    await send(proto.msg(proto.MT_PCM,
                                         np.ascontiguousarray(out_pcm, np.float32).tobytes()))
                else:
                    opus = opus_writer.append_pcm(np.ascontiguousarray(out_pcm, np.float32))
                    if opus:
                        await send(proto.msg(proto.MT_AUDIO, opus))
                text = self._text_msg(token, prob)
                if text is not None:
                    await send(text)

    async def handle_chat(self, request):
        """aiohttp handler of `/api/chat`."""
        from aiohttp import WSMsgType, web

        ws = web.WebSocketResponse()
        await ws.prepare(request)
        log("info", "accepted connection")

        async def messages():
            async for message in ws:
                if message.type in (WSMsgType.ERROR, WSMsgType.CLOSED):
                    return
                if message.type == WSMsgType.BINARY and message.data:
                    yield message.data

        await self.run_session(dict(request.rel_url.query), messages(), ws.send_bytes,
                               lambda: ws.closed)
        await ws.close()
        return ws


def serve_sessions(state: ServerState, seeds, frames: int):
    """Serve one session per seed, each of `frames` frames of noise PCM
    drawn from that seed and sampled with a generator of that seed, without
    a transport.  Returns, per session, (tokens [generated frames, 1 +
    dep_q], pcm frames, ms per frame)."""
    results = []
    for seed in seeds:
        pcm = (0.1 * np.random.RandomState(seed).randn(frames, state.frame_size)
               ).astype(np.float32)
        state.session_seed = seed
        state.reset()
        audio, ms = [], []
        for f in range(frames):
            t0 = time.perf_counter()
            out_pcm, _ = state.step_frame(pcm[f])
            ms.append((time.perf_counter() - t0) * 1e3)
            if out_pcm is not None:
                audio.append(out_pcm)
        width = 1 + state.lm.config.dep_q
        tokens = np.array(state.session_tokens, dtype=np.int64).reshape(-1, width)
        results.append((tokens, audio, ms))
    return results


def make_app(state: ServerState, static: str | None = None):
    """The aiohttp application: `/api/chat`, and the web client's files
    from `static` at `/`."""
    from aiohttp import web

    app = web.Application()
    app.router.add_get("/api/chat", state.handle_chat)
    if static:
        async def index(_):
            return web.FileResponse(Path(static) / "index.html")

        app.router.add_get("/", index)
        app.router.add_static("/", path=static, follow_symlinks=True, name="static")
    return app


def load_state(checkpoint_dir, device="cuda", cfg_coef: float = 1.0,
               kv_cache: str | None = None, session_timeout: float = 360.0) -> ServerState:
    """A ServerState over the checkpoint in `checkpoint_dir`, its weights
    on `device`.  `cfg_coef` other than 1 wins over the checkpoint's
    lm_gen_config; `kv_cache` overrides the KV cache dtype."""
    from ..models.lm import LMModel
    from ..models.loaders import CheckpointInfo

    info = CheckpointInfo.from_dir(checkpoint_dir)
    log("info", "loading mimi")
    mimi, mimi_params = info.get_mimi(device=device)
    log("info", "loading moshi")
    lm, lm_params = info.get_moshi(device=device)
    if kv_cache:
        lm = LMModel(replace(lm.config, kv_cache_dtype=kv_cache))
    tokenizer = info.get_text_tokenizer()
    gen_cfg = dict(info.lm_gen_config)
    ckpt_cfg_coef = gen_cfg.pop("cfg_coef", 1.0)
    return ServerState(mimi, mimi_params, lm, lm_params, info=info, text_tokenizer=tokenizer,
                       cfg_coef=cfg_coef if cfg_coef != 1.0 else ckpt_cfg_coef,
                       device=device, session_timeout=session_timeout, **gen_cfg)


def main(argv=None):
    from aiohttp import web

    from ..utils.serving import serving_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", default=8998, type=int)
    ap.add_argument("--checkpoint-dir", required=True,
                    help="directory with config.json, the weights and the tokenizer")
    ap.add_argument("--cfg-coef", type=float, default=1.0)
    ap.add_argument("--static", default=None, help="the web client's directory")
    ap.add_argument("--session-timeout", type=float, default=360.0)
    ap.add_argument("--kv-cache", default=None, choices=["model", "int8", "int4"],
                    help="the temporal transformer's KV cache dtype")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = serving_device(args.device)
    state = load_state(args.checkpoint_dir, device, args.cfg_coef, args.kv_cache,
                       args.session_timeout)
    log("info", "warming up")
    state.warmup()
    # what the warm-up made lives as long as the server: keep the cycle
    # collector off it (a full pass costs 100s of ms in a frame)
    gc.freeze()
    log("info", f"serving at http://{args.host}:{args.port}")
    web.run_app(make_app(state, args.static), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
