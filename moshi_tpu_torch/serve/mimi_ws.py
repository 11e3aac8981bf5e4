"""The Mimi codec as a websocket service (counterpart of
moshi_tpu/serve/mimi_ws.py, the reference moshi-server's `Mimi` module and
`rustymimi`'s tokenizers): streaming encode and decode.

The tokenizer socket (`handle_mimi_socket`), one streaming state per
connection:
  -> b"\\x01" + float32 PCM     encode; whole frames are encoded, the rest kept
  <- b"\\x09" + int32 codes [K * n_frames]
  -> b"\\x09" + int32 codes [K * n_frames]    decode
  <- b"\\x01" + float32 PCM
A ragged payload is cut to whole 4-byte values; a codes payload that is
not a whole number of frames is dropped.

Broadcast rooms (`MimiRooms`, the reference's mimi.rs): one producer per
room sends codes (u32, frame-major) and text; the server decodes the codes
and sends the audio, ogg-opus (raw f32le at rates opus does not take), to
every listener, who gets a 9-byte handshake and the stream's header first.

Every step is one frame at batch 1, eager, on the device of the Mimi's
parameters and in their dtype; a socket's steps run on a worker thread, so
that they do not hold up the event loop.  `Tokenizer` and
`StreamTokenizer` (worker threads of their own) are the offline and
streaming codecs for a local program.
"""

import asyncio
import queue
import threading

import numpy as np
import torch

from ..utils.graphs import run_on_device


def _params_place(params):
    emb = params["quantizer"]["rvq_first"]["embedding"]
    return emb.device, emb.dtype


class MimiWsState:
    """The codec of the socket and the rooms: per-session streaming states
    stepped one frame at a time (one program whatever the client's chunks)."""

    def __init__(self, mimi, mimi_params):
        self.mimi, self.params = mimi, mimi_params
        self.device, self.dtype = _params_place(mimi_params)

    def new_session(self) -> dict:
        return {"enc": self.mimi.init_encode_state(1, self.dtype, self.device),
                "dec": self.mimi.init_decode_state(1, self.dtype, self.device),
                "buf": np.zeros((0,), np.float32)}

    def encode_pcm(self, sess: dict, pcm: np.ndarray) -> np.ndarray | None:
        """Codes [K, n] int32 of the whole frames buffered with `pcm`, or
        None when there is none yet."""
        fs = self.mimi.frame_size
        sess["buf"] = np.concatenate([sess["buf"], np.asarray(pcm, np.float32)])
        n = sess["buf"].shape[-1] // fs
        if n == 0:
            return None
        chunk, sess["buf"] = sess["buf"][:n * fs], sess["buf"][n * fs:]
        x = torch.from_numpy(chunk).to(self.device, self.dtype)
        outs = [self.mimi.encode_step(self.params, sess["enc"],
                                      x[i * fs:(i + 1) * fs][None, None])[0]
                for i in range(n)]
        return torch.cat(outs, dim=-1)[0].to(torch.int32).cpu().numpy()

    def decode_codes(self, sess: dict, codes: np.ndarray) -> np.ndarray:
        """Float32 PCM [n * frame_size] of codes [K, n]."""
        if codes.shape[-1] == 0:
            return np.zeros((0,), np.float32)
        c = torch.from_numpy(np.asarray(codes, np.int64)).to(self.device)
        outs = [self.mimi.decode_step(self.params, sess["dec"], c[None, :, i:i + 1])[0]
                for i in range(c.shape[-1])]
        return torch.cat(outs, dim=-1)[0, 0].float().cpu().numpy()


def _whole(payload: bytes, dtype) -> np.ndarray:
    """The payload cut to whole 4-byte values."""
    return np.frombuffer(payload[:len(payload) - len(payload) % 4], dtype)


async def handle_mimi_socket(request, state: MimiWsState):
    """aiohttp handler of the tokenizer socket."""
    from aiohttp import WSMsgType, web

    ws = web.WebSocketResponse()
    await ws.prepare(request)
    sess = state.new_session()
    K = state.mimi.num_codebooks
    async for message in ws:
        if message.type != WSMsgType.BINARY or not message.data:
            continue
        kind, payload = message.data[0], message.data[1:]
        if kind == 1:
            codes = await asyncio.to_thread(run_on_device, state.device, state.encode_pcm,
                                            sess, _whole(payload, np.float32))
            if codes is not None:
                await ws.send_bytes(b"\x09" + codes.astype(np.int32).tobytes())
        elif kind == 9:
            flat = _whole(payload, np.int32)
            if flat.size == 0 or flat.size % K:
                continue  # not a whole number of frames: dropped
            pcm = await asyncio.to_thread(run_on_device, state.device, state.decode_codes,
                                          sess, flat.reshape(K, -1))
            await ws.send_bytes(b"\x01" + pcm.astype(np.float32).tobytes())
    return ws


class Tokenizer:
    """The offline codec (`rustymimi.Tokenizer`): whole arrays through
    encode / decode, and encode_step / decode_step with streaming states
    made at the first call's batch size."""

    def __init__(self, mimi, mimi_params):
        self.mimi, self.params = mimi, mimi_params
        self.device, self.dtype = _params_place(mimi_params)
        self._enc_state = self._dec_state = None

    def _pcm(self, pcm) -> torch.Tensor:
        return torch.from_numpy(np.asarray(pcm, np.float32)).to(self.device, self.dtype)

    def _codes(self, codes) -> torch.Tensor:
        return torch.from_numpy(np.asarray(codes, np.int64)).to(self.device)

    def encode(self, pcm: np.ndarray) -> np.ndarray:
        """pcm [B, 1, T] -> codes [B, K, n]."""
        return self.mimi.encode(self.params, self._pcm(pcm)).cpu().numpy()

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes [B, K, n] -> pcm [B, 1, n * frame_size] float32."""
        return self.mimi.decode(self.params, self._codes(codes)).float().cpu().numpy()

    def encode_step(self, pcm: np.ndarray) -> np.ndarray:
        if self._enc_state is None:
            self._enc_state = self.mimi.init_encode_state(pcm.shape[0], self.dtype, self.device)
        return self.mimi.encode_step(self.params, self._enc_state, self._pcm(pcm))[0] \
            .cpu().numpy()

    def decode_step(self, codes: np.ndarray) -> np.ndarray:
        if self._dec_state is None:
            self._dec_state = self.mimi.init_decode_state(codes.shape[0], self.dtype,
                                                          self.device)
        return self.mimi.decode_step(self.params, self._dec_state, self._codes(codes))[0] \
            .float().cpu().numpy()

    def reset(self):
        self._enc_state = self._dec_state = None


class StreamTokenizer:
    """The streaming codec on worker threads of its own
    (`rustymimi.StreamTokenizer`): `encode(pcm)` and `decode(codes)` queue
    work for an encoder and a decoder thread, each with its streaming
    state at batch 1; `get_encoded()` / `get_decoded()` poll the results
    (None when there is none yet), and re-raise a worker's error.  PCM
    chunks are whole frames (1-D float32), codes [K, n] int32 a chunk;
    decoded PCM is 1-D float32."""

    def __init__(self, mimi, mimi_params):
        self.mimi, self.params = mimi, mimi_params
        self.codec = Tokenizer(mimi, mimi_params)
        self._enc_in, self._enc_out = queue.Queue(), queue.Queue()
        self._dec_in, self._dec_out = queue.Queue(), queue.Queue()
        for fn in (self._enc_loop, self._dec_loop):
            threading.Thread(target=fn, daemon=True).start()

    def _loop(self, q_in, q_out, init, step, out):
        state = init(1, self.codec.dtype, self.codec.device)
        while True:
            item = q_in.get()
            if item is None:
                return
            try:
                q_out.put(out(run_on_device(self.codec.device, step, self.params, state, item)))
            except Exception as e:  # re-raised by the next poll
                q_out.put(e)

    def _enc_loop(self):
        self._loop(self._enc_in, self._enc_out, self.mimi.init_encode_state,
                   self.mimi.encode_step, lambda r: r[0][0].cpu().numpy())

    def _dec_loop(self):
        self._loop(self._dec_in, self._dec_out, self.mimi.init_decode_state,
                   self.mimi.decode_step, lambda r: r[0][0, 0].float().cpu().numpy())

    def encode(self, pcm: np.ndarray):
        pcm = np.ascontiguousarray(pcm, np.float32)
        if pcm.size == 0 or pcm.size % self.mimi.frame_size:
            raise ValueError(f"pcm length {pcm.size} is not a positive multiple of "
                             f"frame_size {self.mimi.frame_size}")
        self._enc_in.put(self.codec._pcm(pcm)[None, None])

    def decode(self, codes: np.ndarray):
        self._dec_in.put(self.codec._codes(codes)[None])

    @staticmethod
    def _poll(q):
        try:
            out = q.get_nowait()
        except queue.Empty:
            return None
        if isinstance(out, Exception):
            raise out
        return out

    def get_encoded(self) -> np.ndarray | None:
        return self._poll(self._enc_out)

    def get_decoded(self) -> np.ndarray | None:
        return self._poll(self._dec_out)

    def close(self):
        self._enc_in.put(None)
        self._dec_in.put(None)


# ---------------------------------------------------------------- broadcast
class MimiRoom:
    """One broadcast room: one producer's decoded audio fanned out to any
    number of listeners, encoded by `writer` (by default
    tts_ws.make_audio_encoder's for the Mimi's rate)."""

    # a stalled listener's backlog is cut at this many messages (the oldest
    # dropped), so the stream stays live
    MAX_QUEUED = 512

    def __init__(self, state: MimiWsState, writer=None):
        from .tts_ws import make_audio_encoder

        self.state = state
        self.sess = state.new_session()
        self.writer = writer or make_audio_encoder(state.mimi.config.sample_rate)
        # the ogg header pages (BOS and tags) for listeners who join late
        self.header = self.writer.append_pcm(np.zeros((0,), np.float32)) or b""
        self.listeners: set = set()
        self.producer_active = False
        self.pcm_pending = np.zeros((0,), np.float32)

    def broadcast(self, data: bytes):
        for q in list(self.listeners):
            if q.qsize() >= self.MAX_QUEUED:
                q.get_nowait()
            q.put_nowait(data)


class MimiRooms:
    """The rooms of a module: `allowed` names them up front (others are
    refused), `default_room` serves clients that name none."""

    def __init__(self, state: MimiWsState, allowed=None, default_room: str | None = None):
        self.state = state
        self.rooms: dict[str, MimiRoom] = {}
        self.allowed = set(allowed) if allowed is not None else None
        self.default_room = default_room

    def room(self, room_id: str) -> MimiRoom:
        if self.allowed is not None and room_id not in self.allowed:
            raise KeyError(room_id)
        if room_id not in self.rooms:
            self.rooms[room_id] = MimiRoom(self.state)
        return self.rooms[room_id]


def _room_of(request, rooms: MimiRooms):
    """The room named by the URL (native `/{room}/` routes), the `room_id`
    header or query parameter (reference clients), or the default; None for
    an unknown or missing room."""
    rid = (request.match_info.get("room") or request.headers.get("room_id")
           or request.query.get("room_id") or rooms.default_room)
    if rid is None:
        return None
    try:
        return rooms.room(rid)
    except KeyError:
        return None


async def handle_room_send(request, rooms: MimiRooms):
    """The producer's socket: text (MT 2) is forwarded as it is; codes (MT
    9, u32, frames of K codebooks) are decoded and broadcast as b"\\x01"
    audio, a frame at a time."""
    from aiohttp import WSMsgType, web

    room = _room_of(request, rooms)
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    if room is None:
        await ws.close(code=1008, message=b"unknown room")
        return ws
    if room.producer_active:
        await ws.close(code=1008, message=b"already a producer")
        return ws
    room.producer_active = True
    state = rooms.state
    K, fs = state.mimi.num_codebooks, state.mimi.frame_size
    try:
        async for message in ws:
            if message.type != WSMsgType.BINARY or not message.data:
                continue
            kind, payload = message.data[0], message.data[1:]
            if kind == 2:
                room.broadcast(bytes(message.data))
            elif kind == 9:
                flat = _whole(payload, np.uint32).astype(np.int32)
                if flat.size == 0 or flat.size % K:
                    continue
                pcm = await asyncio.to_thread(run_on_device, state.device, state.decode_codes,
                                              room.sess, flat.reshape(-1, K).T)
                room.pcm_pending = np.concatenate([room.pcm_pending, pcm])
                while room.pcm_pending.shape[-1] >= fs:
                    chunk, room.pcm_pending = room.pcm_pending[:fs], room.pcm_pending[fs:]
                    data = room.writer.append_pcm(np.ascontiguousarray(chunk, np.float32))
                    if data:
                        room.broadcast(b"\x01" + data)
    finally:
        room.producer_active = False
    return ws


async def handle_room_recv(request, rooms: MimiRooms):
    """A listener's socket: the 9-byte handshake, the room's header, then
    the live broadcast."""
    from aiohttp import web

    room = _room_of(request, rooms)
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    if room is None:
        await ws.close(code=1008, message=b"unknown room")
        return ws
    q: asyncio.Queue = asyncio.Queue()
    room.listeners.add(q)
    try:
        await ws.send_bytes(b"\x00" * 9)
        if room.header:
            await ws.send_bytes(b"\x01" + room.header)
        while True:
            await ws.send_bytes(await q.get())
    except (ConnectionResetError, asyncio.CancelledError):
        pass
    finally:
        room.listeners.discard(q)
        await ws.close()
    return ws
