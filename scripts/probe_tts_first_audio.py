"""Where the batched TTS sessions' time to first audio goes, on the card:
chip_smoke.py's [tts] weights as its [tts_serve] checkpoint, the worker's
batched_tts module, and chip_smoke's 15 batched sessions twice through the
module's run_loop, each frame's wall-clock start and end recorded: frame
times, the gaps between frames, PCM frames and first audio per session.

    python3 scripts/probe_tts_first_audio.py   (one CUDA card)
"""
import asyncio
import sys
import time
import tomllib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import moshi_tpu_torch  # noqa: E402,F401
from moshi_tpu_torch.ops import build  # noqa: E402
from moshi_tpu_torch.serve.worker import build_app  # noqa: E402

dev = torch.device("cuda", 0)
card = cs.card_line()
build.build_all()
try:
    models = cs.build_tts(dev)
    cs.write_tts_checkpoint(dev, card, models, cs.TTS_DIR)
    del models
    cs.free_memory()
    app = build_app(tomllib.loads(cs.tts_serve_toml()), device=dev)
    state = app["modules"]["batched"]["state"]
    marks = []
    step = state.step_batch

    def timed(active, sessions=None):
        t0 = time.perf_counter()
        r = step(active, sessions)
        marks.append((t0, time.perf_counter(), len(active)))
        return r
    state.step_batch = timed

    async def run():
        task = asyncio.create_task(state.run_loop())
        t0 = time.perf_counter()
        out = await cs.batched_tts_sessions(state)
        task.cancel()
        return out, t0
    for rep in range(2):
        marks.clear()
        out, t0 = asyncio.run(run())
        starts = np.array([m[0] for m in marks]) - t0
        ends = np.array([m[1] for m in marks]) - t0
        gaps = starts[1:] - ends[:-1]
        print(f"rep {rep}: {len(marks)} frames, first start {starts[0] * 1e3:.1f} ms, last end "
              f"{ends[-1] * 1e3:.1f} ms; frame ms p50 {np.median(ends - starts) * 1e3:.2f}; "
              f"gaps ms p50 {np.median(gaps) * 1e3:.2f} max {gaps.max() * 1e3:.2f} sum "
              f"{gaps.sum() * 1e3:.1f}; active {[m[2] for m in marks[:6]]}", flush=True)
        print("  frames ms (first 8):", [round((e - s) * 1e3, 1) for s, e in
                                         zip(starts[:8], ends[:8])])
        print("  gaps ms (first 8):", [round(g * 1e3, 1) for g in gaps[:8]])
        print("  pcm frames per session:", {i: len(p) for i, p in out["pcm"].items()})
        print("  tokens per session:", {i: len(t) for i, t in out["tokens"].items()})
        print("  ttfa ms:", {i: round(v, 1) for i, v in out["ttfa_ms"].items()}, flush=True)
finally:
    import shutil
    shutil.rmtree(cs.TTS_DIR, ignore_errors=True)
