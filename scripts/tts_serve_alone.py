"""chip_smoke.py's [tts_serve] phase alone, on one CUDA card: the kernels
built, [tts]'s seeded models, their checkpoint (written and held leaf for
leaf), then run_tts_serve (without [tts]'s greedy p50 beside it), the
checkpoint deleted at the end.  ~3 minutes with the build.

    python3 scripts/tts_serve_alone.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

import moshi_tpu_torch  # noqa: E402,F401
from moshi_tpu_torch.ops import build  # noqa: E402

t0 = time.perf_counter()
dev = torch.device("cuda", 0)
card = cs.card_line()
build.build_all()
for name in build.SIGNATURES:
    build.load(name)
print("built", time.perf_counter() - t0, flush=True)
try:
    models = cs.build_tts(dev)
    ck = cs.write_tts_checkpoint(dev, card, models, cs.TTS_DIR)
    del models
    cs.free_memory()
    out = cs.run_tts_serve(dev, card, {"checkpoint": ck, "greedy": {"p50_ms": float("nan")}})
finally:
    import shutil
    shutil.rmtree(cs.TTS_DIR, ignore_errors=True)
print({k: v for k, v in out.items() if k != "launches"})
print("seconds", time.perf_counter() - t0)
