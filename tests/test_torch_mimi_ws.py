"""The port's Mimi service (serve/mimi_ws.py) held against the JAX
package's on the same converted weights, on the CPU in f32: the tokenizer
socket (ragged PCM payloads, codes back, a malformed codes payload dropped,
PCM back), broadcast rooms (two listeners, text forwarded, the ogg header
for a late listener, an unknown room refused), `Tokenizer` and
`StreamTokenizer`.  Codes equal, PCM within PCM_TOL."""

import asyncio
import time

import jax
import numpy as np
import pytest
from aiohttp import WSMsgType, web
from aiohttp.test_utils import TestClient, TestServer

from moshi_tpu.models.loaders import mimi_config_from_dict as jmimi_config
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.serve import mimi_ws as jmw
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.serve import mimi_ws as tmw
from moshi_tpu_torch.utils.params import from_jax
from test_mimi import tiny_mimi_config
from test_torch_batched_transport import MOSHI_MIMI
from test_torch_port import max_abs, port_mimi_config

PCM_TOL = 1e-5
RECV_TIMEOUT = 60


def mimi_pair(config):
    """(JAX Mimi, params), (port Mimi, params) of one seeded JAX init."""
    jmimi = JMimi(config)
    params = jax.device_get(jmimi.init_params(jax.random.PRNGKey(1)))
    tcfg = port_mimi_config(config)
    return (jmimi, params), (TMimi(tcfg), from_jax(params, mimi_config=tcfg))


@pytest.fixture(scope="module")
def tiny():
    return mimi_pair(tiny_mimi_config())


def pcm_of(n: int, seed: int) -> np.ndarray:
    return (0.3 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def app_of(routes) -> web.Application:
    app = web.Application()
    for route, handler in routes:
        app.router.add_get(route, handler)
    return app


async def served(app, fn):
    async with TestClient(TestServer(app)) as client:
        return await fn(client)


async def tokenizer_client(client, pcm: np.ndarray, K: int):
    """PCM in chunks of ragged sample counts (the last with a stray byte,
    dropped), then the codes back to decode, after a malformed codes
    payload.  Returns (codes [K, n], decoded PCM)."""
    ws = await client.ws_connect("/api/mimi")
    data = pcm.tobytes()
    cuts = [0, 4 * 7, 4 * 150, 4 * 151, 4 * 400, len(data)]
    for a, b in zip(cuts, cuts[1:]):
        await ws.send_bytes(b"\x01" + data[a:b] + (b"\x05" if b == len(data) else b""))
    n = len(pcm) // 96
    codes = []
    while sum(c.shape[-1] for c in codes) < n:
        m = await ws.receive_bytes(timeout=RECV_TIMEOUT)
        assert m[:1] == b"\x09"
        codes.append(np.frombuffer(m[1:], np.int32).reshape(K, -1))
    codes = np.concatenate(codes, axis=-1)
    await ws.send_bytes(b"\x09" + codes[:, :1].tobytes()[:-4])   # not whole frames
    await ws.send_bytes(b"\x09" + codes.tobytes())
    m = await ws.receive_bytes(timeout=RECV_TIMEOUT)
    assert m[:1] == b"\x01"
    await ws.close()
    return codes, np.frombuffer(m[1:], np.float32)


def test_tokenizer_socket_matches_jax(tiny):
    """Two clients at once, PCM in ragged chunks: the codes are JAX's socket's
    and encode_step's from a fresh state; the codes decoded come back as
    JAX's PCM and as decode_step's."""
    (jm, jp), (tm, tp) = tiny
    K = tm.num_codebooks
    pcms = [pcm_of(6 * 96 + 40, s) for s in (1, 2)]

    def run(state, handler):
        async def fn(client):
            return await asyncio.gather(*(tokenizer_client(client, p, K) for p in pcms))
        return asyncio.run(served(app_of([("/api/mimi", lambda r: handler(r, state))]), fn))

    got = run(tmw.MimiWsState(tm, tp), tmw.handle_mimi_socket)
    want = run(jmw.MimiWsState(jm, jp), jmw.handle_mimi_socket)
    tok = tmw.Tokenizer(tm, tp)
    for (gc, gp), (wc, wp), pcm in zip(got, want, pcms):
        assert gc.shape == (K, 6)
        np.testing.assert_array_equal(gc, wc)
        tok.reset()
        steps = np.concatenate([tok.encode_step(pcm[i * 96:(i + 1) * 96][None, None])[0]
                                for i in range(6)], axis=-1)
        np.testing.assert_array_equal(gc, steps)
        assert gp.shape == (6 * 96,) and max_abs(gp, wp) <= PCM_TOL
        decoded = np.concatenate([tok.decode_step(gc[None, :, i:i + 1])[0, 0]
                                  for i in range(6)])
        assert max_abs(gp, decoded) == 0.0


def test_rooms_match_jax(tiny):
    """A room with one producer and two listeners: both listeners get the
    handshake, the text forwarded and the decoded audio, the same bytes,
    equal to JAX's room within PCM_TOL; a second producer and an unknown
    room are refused (1008)."""
    (jm, jp), (tm, tp) = tiny
    K = tm.num_codebooks
    codes = np.random.RandomState(3).randint(0, 32, (4, K)).astype(np.uint32)

    def run(mod, mimi, params):
        rooms = mod.MimiRooms(mod.MimiWsState(mimi, params), allowed=["r"])
        app = app_of([("/m/{room}/send", lambda r: mod.handle_room_send(r, rooms)),
                      ("/m/{room}/recv", lambda r: mod.handle_room_recv(r, rooms))])

        async def fn(client):
            listeners = [await client.ws_connect("/m/r/recv") for _ in range(2)]
            got = [[await ws.receive_bytes(timeout=RECV_TIMEOUT)] for ws in listeners]
            producer = await client.ws_connect("/m/r/send")
            second = await client.ws_connect("/m/r/send")
            refused = await second.receive(timeout=RECV_TIMEOUT)
            unknown = await client.ws_connect("/m/nope/recv")
            gone = await unknown.receive(timeout=RECV_TIMEOUT)
            await producer.send_bytes(b"\x02hello")
            await producer.send_bytes(b"\x09" + codes[:1].tobytes())
            await producer.send_bytes(b"\x09" + codes[1:].tobytes() + b"\x01")
            for ws, out in zip(listeners, got):
                for _ in range(1 + 4):
                    out.append(await ws.receive_bytes(timeout=RECV_TIMEOUT))
            for ws in listeners + [producer]:
                await ws.close()
            return got, (refused.type, second.close_code), (gone.type, unknown.close_code)

        return asyncio.run(served(app, fn))

    got, refused, gone = run(tmw, tm, tp)
    want, *_ = run(jmw, jm, jp)
    assert got[0] == got[1]
    assert refused == gone == (WSMsgType.CLOSE, 1008)
    assert got[0][0] == b"\x00" * 9 and got[0][1] == b"\x02hello"
    for g, w in zip(got[0][2:], want[0][2:]):
        assert g[:1] == w[:1] == b"\x01"
        assert max_abs(np.frombuffer(g[1:], np.float32), np.frombuffer(w[1:], np.float32)) \
            <= PCM_TOL


def test_room_opus_header_for_late_listener():
    """At an opus rate the room sends ogg-opus: a listener that joins after
    the producer began gets the stream's header pages first."""
    (_, _), (tm, tp) = mimi_pair(jmimi_config(MOSHI_MIMI, 8))
    rooms = tmw.MimiRooms(tmw.MimiWsState(tm, tp), default_room="d")
    app = app_of([("/send", lambda r: tmw.handle_room_send(r, rooms)),
                  ("/recv", lambda r: tmw.handle_room_recv(r, rooms))])
    codes = np.random.RandomState(4).randint(0, 32, (3, tm.num_codebooks)).astype(np.uint32)

    async def fn(client):
        producer = await client.ws_connect("/send")
        await producer.send_bytes(b"\x09" + codes.tobytes())
        await asyncio.sleep(0.5)
        late = await client.ws_connect("/recv")
        hello = await late.receive_bytes(timeout=RECV_TIMEOUT)
        header = await late.receive_bytes(timeout=RECV_TIMEOUT)
        await producer.send_bytes(b"\x09" + codes.tobytes())
        audio = await late.receive_bytes(timeout=RECV_TIMEOUT)
        await producer.close()
        await late.close()
        return hello, header, audio

    hello, header, audio = asyncio.run(served(app, fn))
    assert hello == b"\x00" * 9 and header[:5] == b"\x01OggS" and b"OpusHead" in header
    assert audio[:5] == b"\x01OggS"


def test_tokenizer_matches_jax(tiny):
    """Tokenizer: offline encode / decode and the streaming steps, as JAX's."""
    (jm, jp), (tm, tp) = tiny
    t, j = tmw.Tokenizer(tm, tp), jmw.Tokenizer(jm, jp)
    pcm = np.stack([pcm_of(5 * 96, s) for s in (3, 4)])[:, None]
    codes = t.encode(pcm)
    np.testing.assert_array_equal(codes, j.encode(pcm))
    assert max_abs(t.decode(codes), j.decode(codes)) <= PCM_TOL
    for i in range(3):
        chunk = pcm[..., i * 96:(i + 1) * 96]
        c = t.encode_step(chunk)
        np.testing.assert_array_equal(c, j.encode_step(chunk))
        assert max_abs(t.decode_step(c), j.decode_step(c)) <= PCM_TOL
    t.reset()
    np.testing.assert_array_equal(t.encode_step(pcm[..., :96]), codes[..., :1])


def test_stream_tokenizer_matches_jax(tiny):
    """StreamTokenizer: frames queued to its encoder thread come back as
    JAX's codes, codes to its decoder thread as JAX's PCM; a chunk that is
    not whole frames raises; a worker's error comes back at the next poll."""
    (jm, jp), (tm, tp) = tiny
    pcm = pcm_of(4 * 96, 8)

    def run(mod, mimi, params):
        st = mod.StreamTokenizer(mimi, params)
        st.encode(pcm[:96])
        st.encode(pcm[96:])
        codes = [poll(st.get_encoded) for _ in range(2)]
        for c in codes:
            st.decode(c)
        out = codes, [poll(st.get_decoded) for _ in range(2)]
        with pytest.raises(ValueError):
            st.encode(pcm[:50])
        st.decode(np.zeros((mimi.num_codebooks,), np.int32))  # not [K, n]
        with pytest.raises(Exception):
            poll(st.get_decoded)
        st.close()
        return out

    def poll(fn):
        t0 = time.time()
        while time.time() - t0 < RECV_TIMEOUT:
            r = fn()
            if r is not None:
                return r
            time.sleep(0.01)
        raise AssertionError("no result")

    got, want = run(tmw, tm, tp), run(jmw, jm, jp)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert [c.shape[-1] for c in got[0]] == [1, 3]
    for g, w in zip(got[1], want[1]):
        assert g.shape == w.shape and max_abs(g, w) <= PCM_TOL
