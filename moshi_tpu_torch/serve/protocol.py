"""Binary websocket protocol constants (rust/protocol.md:1-31,
moshi-server/src/protocol.rs:7-53); a copy of moshi_tpu/serve/protocol.py.

Each binary ws message starts with one message-type byte `MT`; the payload
format depends on MT.  Messages with unknown types must be discarded.
"""

MT_HANDSHAKE = 0    # payload: protocol version u32 + model version u32 (LE)
MT_AUDIO = 1        # payload: ogg-opus frames (24 kHz mono)
MT_TEXT = 2         # payload: utf-8 string
MT_CONTROL = 3      # payload: one control byte (unused in full-duplex mode)
MT_METADATA = 4     # payload: utf-8 json
MT_ERROR = 5        # payload: utf-8 error description
MT_PING = 6         # no payload
MT_COLOREDTEXT = 7  # server->client only
MT_IMAGE = 8        # moshi-server extension
MT_CODES = 9        # moshi-server extension (raw mimi codes)
MT_PCM = 10         # moshi_tpu extension: raw f32le 24 kHz mono frames, both
                    # directions, negotiated via metadata {"raw_pcm": true}
                    # (unknown types are discarded by reference peers)

PROTOCOL_VERSION = 0  # rust/protocol.md:12 "always 0 for now"
DEFAULT_MODEL_VERSION = 1


def handshake(model_version: int = DEFAULT_MODEL_VERSION) -> bytes:
    """Strict MT-0 handshake: protocol version u32 + model version u32, LE
    (rust/protocol.md:11-13).  The Python reference server sends a bare
    b"\\x00" (moshi/moshi/server.py:166); strict rust clients expect the
    8-byte payload, and clients here accept both forms."""
    import struct
    return bytes([MT_HANDSHAKE]) + struct.pack(
        "<II", PROTOCOL_VERSION, model_version)


CTRL_START = 0
CTRL_END_TURN = 1
CTRL_PAUSE = 2
CTRL_RESTART = 3

CONTROL_NAMES = {CTRL_START: "start", CTRL_END_TURN: "endTurn",
                 CTRL_PAUSE: "pause", CTRL_RESTART: "restart"}


def msg(mt: int, payload: bytes = b"") -> bytes:
    return bytes([mt]) + payload
