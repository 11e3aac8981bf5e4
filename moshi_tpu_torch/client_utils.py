"""Terminal output helpers for the CLI client (the port's copy of
moshi_tpu/client_utils.py, which imports no JAX: the same text, byte for
byte).

Behavioral reference: `moshi/moshi/client_utils.py:127-216` — a boxed,
word-wrapping token printer with a red `[LAG]` indicator when the server's
audio stream falls behind real time, plus a `RawPrinter` fallback for dumb
terminals/pipes.
"""

import sys


def colorize(text: str, color: str) -> str:
    return f"\033[{color}m{text}\033[0m"


def make_log(level: str, msg: str) -> str:
    colors = {"info": "1;34", "warning": "1;33", "error": "1;31"}
    return colorize(f"[{level.capitalize()}]", colors.get(level, "0")) + " " + msg


class RawPrinter:
    """Plain streaming output (pipes, logs)."""

    def __init__(self, stream=sys.stdout, err_stream=sys.stderr):
        self.stream = stream
        self.err_stream = err_stream

    def print_header(self):
        pass

    def print_token(self, token: str):
        self.stream.write(token)
        self.stream.flush()

    def print_lag(self):
        self.stream.write(" [LAG]")
        self.stream.flush()

    def log(self, level: str, msg: str):
        print(make_log(level, msg), file=self.err_stream, flush=True)

    def close(self):
        self.stream.write("\n")
        self.stream.flush()


class Printer:
    """Boxed word-wrapping printer with a colored [LAG] marker.

    Tokens arrive as sentencepiece pieces (may start with a space); lines
    wrap at `max_cols` inside `| ... |` borders.  `print_lag()` inserts a red
    `[LAG]` marker once per lag episode.
    """

    def __init__(self, max_cols: int = 80, stream=sys.stdout,
                 err_stream=sys.stderr):
        self.max_cols = max_cols
        self.stream = stream
        self.err_stream = err_stream
        self._col = 0
        self._open = False
        self._lag_shown = False

    def print_header(self):
        self.stream.write(" " + "-" * self.max_cols + "\n")
        self._start_line()

    def _start_line(self):
        self.stream.write("| ")
        self._col = 0
        self._open = True

    def _end_line(self):
        pad = " " * max(0, self.max_cols - self._col)
        self.stream.write(pad + " |\n")
        self._open = False

    def _write(self, text: str, color: str | None = None):
        self.stream.write(colorize(text, color) if color else text)
        self._col += len(text)

    def print_token(self, token: str, color: str | None = None):
        if not self._open:
            self._start_line()
        remaining = self.max_cols - self._col
        if len(token) <= remaining:
            self._write(token, color)
        elif token.startswith(" "):
            # wrap whole words to the next line
            self._end_line()
            self._start_line()
            self._write(token.lstrip(), color)
        else:
            # token continues the current word: hard-split at the border
            self._write(token[:remaining], color)
            self._end_line()
            self._start_line()
            self._write(token[remaining:], color)
        self.stream.flush()

    def print_lag(self):
        if not self._lag_shown:
            self.print_token(" [LAG]", "31")
            self._lag_shown = True

    def clear_lag(self):
        self._lag_shown = False

    def log(self, level: str, msg: str):
        if self._open:
            self._end_line()
        print(make_log(level, msg), file=self.err_stream, flush=True)

    def close(self):
        if self._open:
            self._end_line()
        self.stream.write(" " + "-" * self.max_cols + "\n")
        self.stream.flush()


def make_printer(stream=sys.stdout):
    """Printer when attached to a tty, RawPrinter otherwise
    (reference client.py behavior)."""
    if hasattr(stream, "isatty") and stream.isatty():
        return Printer(stream=stream)
    return RawPrinter(stream=stream)
