"""Pick the factors of chip_smoke.py's ASR Word check on one NVIDIA GPU.

    python3 scripts/pick_asr_pad_factors.py 10,15,20,25 40,50,60,70

The seeded asr_300m_202501 of chip_smoke.py's [asr] phase never ends a
word unless the text head's columns of the end-pad (0) and pad (3) ids are
scaled (chip_smoke.ASR_PAD_LOGIT_SCALE), and its greedy stream turns on
near-ties, so any change of rounding on the path can move it.  For every
pair of factors (the first argument lists the end-pad's, the second the
pad's) this builds the model as chip_smoke.build_asr does and runs
chip_smoke.asr_greedy (B = 256, eager, the isolation script with its
resume) twice, with the
decode_attention_int8 kernel and with its plain version, and prints how
many Word / EndWord messages slot 0's session holds in each: a pair for
the check gives slot 0 words under both, ideally with neighbours that do
too.
"""

import argparse
import itertools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from moshi_tpu_torch.modules import transformer  # noqa: E402
from moshi_tpu_torch.ops import build  # noqa: E402
from moshi_tpu_torch.ops.decode_attention import (decode_attention_int8,  # noqa: E402
                                                  decode_attention_int8_plain)


def slot0_words(dev) -> dict:
    """Slot 0's Word / EndWord messages with the kernel and the plain
    attention, for chip_smoke.ASR_PAD_LOGIT_SCALE as it stands."""
    models = cs.build_asr(dev)
    words = {}
    try:
        for name, fn in (("kernel", decode_attention_int8),
                         ("plain", decode_attention_int8_plain)):
            transformer.decode_attention_int8 = fn
            # eager: the graphed frames give the same bits
            state, sessions, *_ = cs.asr_greedy(dev, models, graphed=False)
            words[name] = sum(m["type"] in ("Word", "EndWord") for m in sessions[0][0][1])
            del state, sessions
            cs.free_memory()
    finally:
        transformer.decode_attention_int8 = decode_attention_int8
    return words


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("end_pad", help="comma-separated factors of column 0")
    ap.add_argument("pad", help="comma-separated factors of column 3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pick_asr_pad_factors.py: torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    build.build_all()
    factors = [[float(f) for f in a.split(",")] for a in (args.end_pad, args.pad)]
    for f0, f3 in itertools.product(*factors):
        cs.ASR_PAD_LOGIT_SCALE = {0: f0, 3: f3}
        words = slot0_words(dev)
        print(f"factors {f0:g} {f3:g}: slot 0 Word / EndWord messages, kernel "
              f"{words['kernel']}, plain {words['plain']}", flush=True)


if __name__ == "__main__":
    main()
