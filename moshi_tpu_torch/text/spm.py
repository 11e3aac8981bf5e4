"""Self-contained SentencePiece (unigram) tokenizer: a copy of
moshi_tpu/text/spm.py (the port imports no module of moshi_tpu).

The reference uses the `sentencepiece` C++ library
(`moshi/moshi/models/loaders.py:315-316`; server text path at
`moshi/moshi/server.py:86-92` needs only `id_to_piece`; the TTS engine needs
word-level `encode`, `moshi/moshi/models/tts.py:262-276`).  To depend on no
such wheel, this module reads the standard `*.model` protobuf directly
(minimal wire-format parser, no protoc needed) and implements unigram
Viterbi segmentation for encoding.

Covers the subset Moshi needs: `encode(str) -> ids`, `decode(ids)`,
`id_to_piece(id)`, with SentencePiece's dummy-prefix and whitespace-escape
(U+2581) conventions and byte-fallback pieces.
"""

import struct
from pathlib import Path

WS = "▁"  # ▁


def _parse_protobuf(data: bytes):
    """Yield (field_number, wire_type, value) triples at one message level."""
    i, n = 0, len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(data, i)
        elif wt == 1:
            v = data[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(data, i)
            v = data[i:i + ln]
            i += ln
        elif wt == 5:
            v = data[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _read_varint(data: bytes, i: int):
    shift, out = 0, 0
    while True:
        b = data[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


class SentencePieceTokenizer:
    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE, UNUSED = 1, 2, 3, 4, 6, 5

    def __init__(self, model_path: str | Path):
        blob = Path(model_path).read_bytes()
        self.pieces: list[str] = []
        self.scores: list[float] = []
        self.types: list[int] = []
        for field, wt, value in _parse_protobuf(blob):
            if field == 1 and wt == 2:  # SentencePiece message
                piece, score, ptype = "", 0.0, self.NORMAL
                for f2, w2, v2 in _parse_protobuf(value):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2 if isinstance(v2, int) else v2[0]
                self.pieces.append(piece)
                self.scores.append(score)
                self.types.append(ptype)
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id = next((i for i, t in enumerate(self.types)
                            if t == self.UNKNOWN), 0)
        self.byte_ids = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t == self.BYTE and p.startswith("<0x"):
                self.byte_ids[int(p[3:5], 16)] = i
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)

    def __len__(self):
        return len(self.pieces)

    def vocab_size(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx]

    # ------------------------------------------------------------------ encode
    def encode(self, text: str, add_dummy_prefix: bool = True) -> list[int]:
        """Unigram Viterbi segmentation (best-score path over piece lattice)."""
        s = text.replace(" ", WS)
        if add_dummy_prefix and not s.startswith(WS):
            s = WS + s
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores, default=0.0) - 10.0
        for i in range(n):
            if best[i] == NEG:
                continue
            matched = False
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                pid = self.piece_to_id.get(s[i:j])
                if pid is None or self.types[pid] in (self.CONTROL, self.UNUSED):
                    continue
                sc = best[i] + self.scores[pid]
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, pid)
                if j == i + 1:
                    matched = True
            if not matched:
                # single-char fallback: unk (byte pieces resolved in backtrack)
                sc = best[i] + unk_penalty
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, -1)
        ids: list[int] = []
        j = n
        while j > 0:
            assert back[j] is not None, (s, j)
            i, pid = back[j]
            if pid == -1:
                ch = s[i:j]
                bs = ch.encode("utf-8")
                if all(b in self.byte_ids for b in bs):
                    ids.extend(self.byte_ids[b] for b in reversed(bs))
                else:
                    ids.append(self.unk_id)
            else:
                ids.append(pid)
            j = i
        ids.reverse()
        return ids

    # ------------------------------------------------------------------ decode
    def decode(self, ids) -> str:
        out: list[str] = []
        byte_buf: list[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            if self.types[i] == self.BYTE:
                byte_buf.append(int(self.pieces[i][3:5], 16))
                continue
            flush()
            if self.types[i] in (self.CONTROL, self.UNKNOWN):
                continue
            out.append(self.pieces[i])
        flush()
        text = "".join(out).replace(WS, " ")
        return text[1:] if text.startswith(" ") else text


def spm_model_bytes(vocab: int) -> bytes:
    """A minimal unigram SentencePiece model of `vocab` pieces (the JAX
    package's scripts/make_tiny_checkpoint.py `spm_model_bytes`): <unk>,
    <s> and </s>, then one whole-word piece `▁w{i}` for every other id, so
    that any text token of a model made from a seed decodes to a word."""
    def piece(p: str, score: float, ptype: int = 1) -> bytes:
        pb = p.encode("utf-8")
        body = b"\x0a" + bytes([len(pb)]) + pb + b"\x15" + struct.pack("<f", score)
        if ptype != 1:
            body += b"\x18" + bytes([ptype])
        return b"\x0a" + bytes([len(body)]) + body

    pieces = [piece("<unk>", 0.0, 2), piece("<s>", 0.0, 3), piece("</s>", 0.0, 3)]
    pieces += [piece(f"{WS}w{i}", -float(i)) for i in range(3, vocab)]
    return b"".join(pieces)
