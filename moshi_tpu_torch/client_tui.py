"""Terminal UI client: the moshi-cli TUI experience for file-based streaming
(counterpart of moshi_tpu/client_tui.py, over the port's opus codec,
native.py).

Behavioral reference: `rust/moshi-cli/src/multistream.rs:221-420` (ratatui):
a bordered full-screen app with
- a blinking state header (RUNNING/EXITING) + input-level bar,
- "received" stats (msgs / audio msgs / text msgs / play len / play buf)
  and "sent" stats (audio msgs / recd len) panels,
- a word-wrapped live transcript pane,
- a log pane,
- `Q` quit / `R` restart keys.

This environment has no audio hardware, so like `client.py` the audio
source is a wav file streamed at real-time pace and the reply is recorded;
everything else (protocol, pacing, lag detection) matches the live client.
Rendering is python-stdlib curses; the frame layout is computed by the
pure `render_lines` (unit-tested without a terminal).

Usage: python -m moshi_tpu_torch.client_tui ws://host:8998/api/chat in.wav [out.wav]
"""

import argparse
import asyncio
import time
from collections import deque

import numpy as np

from . import audio

SAMPLE_RATE = 24_000
FRAME = 1920


class TuiState:
    """Everything the renderer needs; mutated by the client loop."""

    def __init__(self):
        self.state = "RUNNING"          # RUNNING | EXITING
        self.ticker = 0
        self.recv_messages = 0
        self.recv_audio_messages = 0
        self.recv_text_messages = 0
        self.sent_audio_messages = 0
        self.play_samples = 0           # decoded reply samples
        self.sent_samples = 0
        self.input_db10 = 0.0           # mic level bar (0..10)
        self.lag = False
        self.subs: list[str] = []       # transcript pieces
        self.logs: deque = deque(maxlen=200)

    # ------------------------------------------------------------ mutators
    def on_audio(self, pcm: np.ndarray):
        self.recv_messages += 1
        self.recv_audio_messages += 1
        self.play_samples += pcm.size

    def on_text(self, piece: str):
        self.recv_messages += 1
        self.recv_text_messages += 1
        self.subs.append(piece)

    def on_sent(self, pcm: np.ndarray):
        self.sent_audio_messages += 1
        self.sent_samples += pcm.size
        # dB of the chunk drives the level bar (audio_io.rs db10())
        rms = float(np.sqrt(np.mean(pcm ** 2)) + 1e-9)
        db = 20.0 * np.log10(rms)       # <= 0 for [-1, 1] pcm
        self.input_db10 = float(np.clip(10.0 + db / 6.0, 0.0, 10.0))

    def log(self, level: str, msg: str):
        self.logs.append(f"[{level}] {msg}")


def _wrap(pieces: list[str], width: int, max_lines: int) -> list[str]:
    """Word-wrap the transcript tail into at most `max_lines` lines."""
    text = "".join(pieces)
    words = text.split(" ")
    lines, cur = [], ""
    for w in words:
        while len(w) > width:            # pathological long word
            lines.append(cur)
            cur, w = "", w[width:]
        if cur and len(cur) + 1 + len(w) > width:
            lines.append(cur)
            cur = w
        else:
            cur = (cur + " " + w) if cur else w
    if cur:
        lines.append(cur)
    return lines[-max_lines:] if lines else [""]


def render_lines(st: TuiState, width: int, height: int):
    """Compute the frame as [(y, x, text, style)] with style in
    {"border", "state_ok", "state_warn", "bar", "text", "log", "lag"} —
    pure, so the layout is testable without a terminal."""
    out = []
    W = max(40, width)
    title = " moshi_tpu "
    keys = " Quit <Q>  Restart <R> "
    top = "+" + title.center(W - 2, "-") + "+"
    bot = "+" + keys.center(W - 2, "-") + "+"
    out.append((0, 0, top, "border"))

    # ---- header: state + level bar | received | sent (8 rows like ref)
    state_w = W - 2 - 60 if W - 2 >= 100 else max(20, (W - 2) - 2 * ((W - 2) // 3))
    col_w = (W - 2 - state_w) // 2
    blink = (st.ticker // 4) % 2 == 0
    state_style = ("state_warn" if st.state != "RUNNING"
                   else ("state_ok" if blink else "text"))
    hdr_rows = 7
    bar_n = int(round(st.input_db10))
    level = "mic " + "#" * bar_n + "." * (10 - bar_n)
    recv = [
        "received".center(col_w)[:col_w],
        f" msgs: {st.recv_messages}",
        f" audio msgs: {st.recv_audio_messages}",
        f" text msgs: {st.recv_text_messages}",
        f" play len: {st.play_samples} ({st.play_samples / SAMPLE_RATE:.1f}s)",
        f" lag: {'YES' if st.lag else 'no'}",
    ]
    sent = [
        "sent".center(col_w)[:col_w],
        f" audio msgs: {st.sent_audio_messages}",
        f" sent len: {st.sent_samples} ({st.sent_samples / SAMPLE_RATE:.1f}s)",
    ]
    for r in range(hdr_rows):
        y = 1 + r
        if r == hdr_rows // 2 - 1:
            out.append((y, 1, st.state.center(state_w)[:state_w], state_style))
        elif r == hdr_rows - 1:
            out.append((y, 1, level.ljust(state_w)[:state_w], "bar"))
        if r < len(recv):
            out.append((y, 1 + state_w, recv[r].ljust(col_w)[:col_w],
                        "lag" if (r == 5 and st.lag) else "text"))
        if r < len(sent):
            out.append((y, 1 + state_w + col_w, sent[r].ljust(col_w)[:col_w],
                        "text"))

    # ---- transcript (70%) and logs (30%) of the remaining rows
    body_top = 1 + hdr_rows
    body_rows = max(2, height - body_top - 1)
    subs_rows = max(1, (body_rows * 7) // 10)
    log_rows = body_rows - subs_rows
    for i, line in enumerate(_wrap(st.subs, W - 4, subs_rows)):
        out.append((body_top + i, 2, line[:W - 4], "text"))
    logs = list(st.logs)[-log_rows:]
    for i, line in enumerate(logs):
        out.append((body_top + subs_rows + i, 2, line[:W - 4], "log"))
    out.append((body_top + body_rows, 0, bot, "border"))
    return out


async def run_tui(stdscr, url: str, infile: str, outfile: str | None,
                  rt_factor: float = 1.0):
    import curses

    import aiohttp

    from .native import load

    moshi_native = load()

    curses.curs_set(0)
    stdscr.nodelay(True)
    curses.start_color()
    curses.use_default_colors()
    curses.init_pair(1, curses.COLOR_GREEN, -1)
    curses.init_pair(2, curses.COLOR_RED, -1)
    curses.init_pair(3, curses.COLOR_CYAN, -1)
    curses.init_pair(4, curses.COLOR_YELLOW, -1)
    styles = {"border": curses.A_BOLD,
              "state_ok": curses.color_pair(1) | curses.A_BOLD,
              "state_warn": curses.color_pair(2) | curses.A_BOLD,
              "bar": curses.color_pair(2),
              "text": curses.A_NORMAL,
              "log": curses.color_pair(3),
              "lag": curses.color_pair(2) | curses.A_BOLD}

    st = TuiState()
    pcm, _ = audio.read_wav(infile, sample_rate=SAMPLE_RATE)
    pcm = pcm[0]
    out_pcm: list[np.ndarray] = []
    restart = {"want": False}

    def draw():
        stdscr.erase()
        h, w = stdscr.getmaxyx()
        for y, x, text, style in render_lines(st, w, h):
            if 0 <= y < h:
                try:
                    stdscr.addstr(y, x, text[:max(0, w - x - 1)],
                                  styles.get(style, 0))
                except curses.error:
                    pass
        stdscr.refresh()

    async def ui_loop(ws):
        while st.state == "RUNNING":
            st.ticker += 1
            ch = stdscr.getch()
            if ch in (ord("q"), ord("Q")):
                st.state = "EXITING"
                await ws.close()
            elif ch in (ord("r"), ord("R")):
                restart["want"] = True
                st.state = "EXITING"
                st.log("info", "restarting...")
                await ws.close()
            draw()
            await asyncio.sleep(0.1)
        draw()

    async with aiohttp.ClientSession() as session:
        async with session.ws_connect(url) as ws:
            handshake = await ws.receive_bytes()
            assert handshake[:1] == b"\x00", handshake
            st.log("info", f"connected to {url}")
            writer = moshi_native.OpusStreamWriter(SAMPLE_RATE)
            reader = moshi_native.OpusStreamReader(SAMPLE_RATE)
            received = 0
            recv_start = None

            async def sender():
                t0 = time.monotonic()
                for i in range(0, len(pcm) - FRAME, FRAME):
                    if st.state != "RUNNING":
                        return
                    target = t0 + (i / SAMPLE_RATE) / rt_factor
                    delay = target - time.monotonic()
                    if delay > 0:
                        await asyncio.sleep(delay)
                    chunk = np.ascontiguousarray(pcm[i:i + FRAME], np.float32)
                    data = writer.append_pcm(chunk)
                    st.on_sent(chunk)
                    if data:
                        await ws.send_bytes(b"\x01" + data)
                await asyncio.sleep(2.0)
                st.state = "EXITING"
                await ws.close()

            send_task = asyncio.create_task(sender())
            ui_task = asyncio.create_task(ui_loop(ws))
            async for msg in ws:
                if msg.type != aiohttp.WSMsgType.BINARY or not msg.data:
                    continue
                kind = msg.data[0]
                if kind == 1:
                    decoded = np.frombuffer(
                        reader.append_bytes(msg.data[1:]), np.float32)
                    if decoded.size:
                        out_pcm.append(decoded)
                        st.on_audio(decoded)
                        if recv_start is None:
                            recv_start = time.monotonic()
                        received += decoded.size
                        behind = ((time.monotonic() - recv_start) * rt_factor
                                  - received / SAMPLE_RATE)
                        st.lag = behind > 2 * FRAME / SAMPLE_RATE
                elif kind == 2:
                    st.on_text(msg.data[1:].decode("utf-8", "replace"))
                elif kind == 5:
                    st.log("error", msg.data[1:].decode("utf-8", "replace"))
            st.state = "EXITING"
            send_task.cancel()
            await ui_task
    if outfile and out_pcm:
        audio.write_wav(outfile, np.concatenate(out_pcm), SAMPLE_RATE)
        st.log("info", f"wrote {outfile}")
    return restart["want"], "".join(st.subs)


def main():
    import curses

    parser = argparse.ArgumentParser("client_tui")
    parser.add_argument("url")
    parser.add_argument("infile")
    parser.add_argument("outfile", nargs="?")
    parser.add_argument("--rt-factor", type=float, default=1.0)
    args = parser.parse_args()

    def runner(stdscr):
        while True:
            again, text = asyncio.run(run_tui(
                stdscr, args.url, args.infile, args.outfile, args.rt_factor))
            if not again:
                return text

    text = curses.wrapper(runner)
    print(text)


if __name__ == "__main__":
    main()
