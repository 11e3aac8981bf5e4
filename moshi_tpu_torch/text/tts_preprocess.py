"""TTS text normalization + segmentation for the streaming TTS service (the
port's copy of moshi_tpu/text/tts_preprocess.py, which it may not import).

Behavioral reference: `rust/moshi-server/src/tts_preprocess.rs:1-133` —
- `normalize` (line 11-13): unicode apostrophe -> ascii, en-dash removed,
  colon -> space, parentheses removed;
- `parse_segments` (15-41): split on SSML `<break time="Ns"/>` markers,
  keeping text segments and break durations;
- `Tokenizer.preprocess` (66-99): per-word tokenization with a one-time BOS
  insertion, break segments turned into runs of pad tokens
  (npad = max(int(min(secs, 10) * 12.5), 1)).
"""

import re
from dataclasses import dataclass

_BREAK_RE = re.compile(r'<break\s+time="([0-9.]+)s"\s*/>')

FRAME_RATE = 12.5
MAX_BREAK_S = 10.0


def normalize(text: str) -> str:
    """Character-level normalization (tts_preprocess.rs:11-13)."""
    return (text.replace("’", "'").replace("–", "")
            .replace(":", " ").replace("(", "").replace(")", ""))


@dataclass(frozen=True)
class BreakTime:
    seconds: float


def parse_segments(text: str) -> list:
    """Split on <break time="Ns"/> markers (tts_preprocess.rs:15-41).
    Returns str and BreakTime items; leading/trailing whitespace-only text
    segments are dropped like the reference (interior segments keep their
    spacing, the trailing one is trimmed)."""
    segments: list = []
    last = 0
    for m in _BREAK_RE.finditer(text):
        if m.start() > last:
            seg = text[last:m.start()]
            if seg.strip():
                segments.append(seg)
        try:
            segments.append(BreakTime(float(m.group(1))))
        except ValueError:
            pass
        last = m.end()
    if last < len(text):
        seg = text[last:].strip()
        if seg:
            segments.append(seg)
    return segments


@dataclass
class WordWithTokens:
    word: str
    tokens: list


class TtsPreprocessor:
    """Word-level preprocessing for streaming TTS (tts_preprocess.rs
    `Tokenizer`): one WordWithTokens per whitespace-separated word, BOS
    prepended to the first word of the session, breaks as pad-token runs."""

    def __init__(self, tokenizer, text_bos_token: int | None = None,
                 pad_token: int = 3, frame_rate: float = FRAME_RATE):
        self.tokenizer = tokenizer
        self.text_bos_token = text_bos_token
        self.pad_token = pad_token
        self.frame_rate = frame_rate
        self.inserted_bos = False

    def preprocess(self, query: str) -> list[WordWithTokens]:
        out: list[WordWithTokens] = []
        for segment in parse_segments(query):
            if isinstance(segment, BreakTime):
                secs = segment.seconds
                if secs > 0.0:
                    npad = max(int(min(secs, MAX_BREAK_S) * self.frame_rate), 1)
                    out.append(WordWithTokens(
                        word=f'<break time="{secs:.2f}s">',
                        tokens=[self.pad_token] * npad))
                continue
            for word in normalize(segment).split():
                tokens = list(self.tokenizer.encode(word))
                if not self.inserted_bos and self.text_bos_token is not None:
                    self.inserted_bos = True
                    tokens.insert(0, self.text_bos_token)
                out.append(WordWithTokens(word=word, tokens=tokens))
        return out
