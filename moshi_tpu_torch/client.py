"""Headless websocket client: streams a wav file to a moshi_tpu_torch,
moshi_tpu (or reference) server at real-time pace and records the reply
(counterpart of moshi_tpu/client.py, over the port's opus codec,
native.py).

Reference capability: `moshi/moshi/client.py` (mic/speaker CLI client) and the
Rust `moshi-cli`.  This environment has no audio hardware, so the client
reads/writes wav files; the wire protocol is identical (`rust/protocol.md`):
`\\x00` handshake, `\\x01` ogg-opus audio, `\\x02` text.

Usage: python -m moshi_tpu_torch.client ws://localhost:8998/api/chat in.wav out.wav
"""

import argparse
import asyncio
import time

import numpy as np

from . import audio


async def run(url: str, infile: str, outfile: str | None, rt_factor: float = 1.0):
    import aiohttp
    from .native import load

    moshi_native = load()

    sample_rate = 24_000
    frame = 1920
    pcm, _ = audio.read_wav(infile, sample_rate=sample_rate)
    pcm = pcm[0]

    from .client_utils import make_printer

    writer = moshi_native.OpusStreamWriter(sample_rate)
    reader = moshi_native.OpusStreamReader(sample_rate)
    out_pcm: list[np.ndarray] = []
    text_parts: list[str] = []
    printer = make_printer()
    received_samples = 0
    recv_start = None

    async with aiohttp.ClientSession() as session:
        async with session.ws_connect(url) as ws:
            handshake = await ws.receive_bytes()
            assert handshake[:1] == b"\x00", handshake
            printer.log("info", f"connected to {url}")
            printer.print_header()

            async def sender():
                t0 = time.monotonic()
                for i in range(0, len(pcm) - frame, frame):
                    target = t0 + (i / sample_rate) / rt_factor
                    delay = target - time.monotonic()
                    if delay > 0:
                        await asyncio.sleep(delay)
                    data = writer.append_pcm(
                        np.ascontiguousarray(pcm[i:i + frame], np.float32))
                    if data:
                        await ws.send_bytes(b"\x01" + data)
                await asyncio.sleep(2.0)
                await ws.close()

            send_task = asyncio.create_task(sender())
            async for msg in ws:
                if msg.type != aiohttp.WSMsgType.BINARY or not msg.data:
                    continue
                kind = msg.data[0]
                if kind == 1:
                    decoded = np.frombuffer(reader.append_bytes(msg.data[1:]),
                                            np.float32)
                    if decoded.size:
                        out_pcm.append(decoded)
                        # lag detection (client_utils.py:204-206): the
                        # server's audio clock falls behind wall time
                        if recv_start is None:
                            recv_start = time.monotonic()
                        received_samples += decoded.size
                        behind = ((time.monotonic() - recv_start) * rt_factor
                                  - received_samples / sample_rate)
                        if behind > 2 * frame / sample_rate:
                            printer.print_lag()
                        elif hasattr(printer, "clear_lag"):
                            printer.clear_lag()
                elif kind == 2:
                    text = msg.data[1:].decode("utf-8", errors="replace")
                    text_parts.append(text)
                    printer.print_token(text)
                elif kind == 5:
                    printer.log("error", msg.data[1:].decode("utf-8", "replace"))
            await send_task
    printer.close()
    if outfile and out_pcm:
        audio.write_wav(outfile, np.concatenate(out_pcm), sample_rate)
        print(f"wrote {outfile}")
    return "".join(text_parts)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("url")
    parser.add_argument("infile")
    parser.add_argument("outfile", nargs="?")
    parser.add_argument("--rt-factor", type=float, default=1.0,
                        help=">1 streams faster than real time")
    args = parser.parse_args()
    asyncio.run(run(args.url, args.infile, args.outfile, args.rt_factor))


if __name__ == "__main__":
    main()
