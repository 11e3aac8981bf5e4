"""Time the weight-only GEMV kernels of two checkouts on one NVIDIA GPU, in
turns: the other tree, this one, this one, the other.

    python3 scripts/compare_gemv_trees.py DIR [q4|int8|tts|offline|frames]

DIR is a checkout of another commit (e.g. unpacked from `git archive` into
build/, which .gitignore lists).  Each turn runs a check of chip_smoke.py
in its own process from its tree, so each tree builds and loads its own
kernels, and prints its lines under the tree's name, with the card's name
and power limit:
- q4 (the default) and int8: chip_smoke.check_gemvs for the family, the
  per-shape lines at B = 16 and the per-frame lines at B = 1, 2, 4, 8, 16;
- tts: chip_smoke.check_tts_gemvs, the int8 GEMVs at the TTS frame's
  shapes (B = 16), the per-shape lines of the heads and the per-frame lines;
- offline: chip_smoke.check_offline_q4, the q4 kernel above a decoding
  batch, its per-shape lines and the per-forward lines (129 launches) at
  M = 32, 64 and 256;
- frames: the B = 1 frame (chip_smoke.run_slice: graphed p50, the profiler's
  busy ms and device ops a frame) and the TTS frame (chip_smoke.run_tts),
  each on the seeded full-width models.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CODE = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
        "import moshi_tpu_torch; dev = torch.device('cuda', 0); "
        "g = torch.Generator(device=dev).manual_seed(cs.SEED); "
        "print(cs.card_line()); {call}")
CALLS = {"q4": "cs.check_gemvs(dev, g, ('q4',))", "int8": "cs.check_gemvs(dev, g, ('int8',))",
         "tts": "cs.check_tts_gemvs(dev, g)", "offline": "cs.check_offline_q4(dev, g)",
         "frames": ("m = cs.build_models(dev); cs.run_slice(dev, cs.card_line(), *m); "
                    "del m; cs.free_memory(); cs.run_tts(dev, cs.card_line())")}
# the lines kept of each family's output (besides the card's)
KEEP = {"q4": ("per frame", "B=16 bf16: kernel", "B=1 bf16: kernel"),
        "int8": ("per frame", "B=16 bf16: kernel"),
        "tts": ("tts per frame", "tts int8_gemv"),
        "offline": ("offline forward", "bf16 (", "crossover"),
        "frames": ("[slice] graphed", "[slice] profiler", "[tts] profiler", "[tts] sampled",
                   "[tts] graphed")}


def main() -> None:
    other = Path(sys.argv[1]).resolve()
    family = sys.argv[2] if len(sys.argv) > 2 else "q4"
    for tree in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, "-c", CODE.format(call=CALLS[family])], cwd=tree,
                             capture_output=True, text=True)
        lines = out.stdout.splitlines()
        keep = lines[:1] + [line for line in lines if any(k in line for k in KEEP[family])]
        print(f"== {tree} (exit {out.returncode})", *keep, sep="\n", flush=True)
        if out.returncode:
            sys.exit(out.stderr[-4000:])


if __name__ == "__main__":
    main()
