"""Time design variants of the int8_wgmma kernel on one NVIDIA GPU.

    python3 scripts/time_int8_wgmma_variants.py [NAME ...]

Each variant is moshi_tpu_torch/csrc/int8_wgmma.cu with textual edits
(VARIANTS): a design choice changed (the converting warps, the ring's
stages, the wgmma wait, a tensor-map prefetch), another split plan for the
committed source ("plan_*"), or, for a diagnostic ("drop_*"), one piece of
a stage's work taken out, so that the time it saves shows what that piece
costs on the kernel's critical path (a diagnostic computes a wrong result
and is not checked).  The others are checked against the plain version at
1024 x 3072, M = 200.  Every variant is timed with chip_smoke.time_ms
(CUDA-graph replay, operands cold in L2) over the Moshi-7B depformer's 208
linears (chip_smoke.INT8_SHAPES) at each of ROWS and over the TTS frame's
688 int8_wgmma linears at 32 rows (chip_smoke.TTS_INT8_SHAPES, the widths
of 64), in the listed order and again in reverse.  Sources and libraries
go to build/int8w_variants/ (gitignored); ptxas registers, spills and
wgmma notes and the card's name and power limit are printed.  With NAMEs,
only those variants (and the committed kernel) are timed.

The "probe" variant records clock64() at each barrier of block (0, 0, 0)
in one unsplit launch at 4096 x 4096, M = 512 (64 stages), and prints the
mean cycles of each interval of a stage over stages 8..55: the copies'
landing as converting warp 0 sees it, that warp's units, the consumers'
waits, their wgmma batch, and the stage period.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from moshi_tpu_torch.ops import build, q4matmul, qmatmul  # noqa: E402
from moshi_tpu_torch.utils.quantize import quantize_tensor  # noqa: E402

OUT = ROOT / "build" / "int8w_variants"
SRC = build.CSRC / "int8_wgmma.cu"
ROWS = (32, 64, 512)

PRODUCERS = "constexpr int kProducerGroups = 2;"
STAGES = "constexpr int kStages = 4;"
CONVERT = "      convert_unit(st + kQOffset, st + kBOffset, g - first, lane);\n"
WGMMA = "        wgmma_m64n128k16(acc, da + 2 * i, db + 2 * i, 1);\n"
X_COPY = [("    tma_load_2d(st, &maps.x, k0, row0, full);\n", ""),
          ("    mbar_expect(full, kXBytes + kQBytes);", "    mbar_expect(full, kQBytes);")]

# the probe: clock64() stamps of block (0, 0, 0) at each barrier of a
# stage (< 64), read back through int8_wgmma_probe
PROBE_EDITS = [
    ('#include "wgmma_common.cuh"\n',
     '#include "wgmma_common.cuh"\n'
     '__device__ unsigned long long g_probe[6 * 64];\n'
     '#define PROBE(k, s) if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 '
     '&& (s) < 64) g_probe[(k) * 64 + (s)] = clock64();\n'),
    ("    mbar_expect(full, kXBytes + kQBytes);\n",
     "    PROBE(0, i)\n    mbar_expect(full, kXBytes + kQBytes);\n"),
    ("    mbar_wait(b.ring.bar(b.ring.full, s), b.ring.parity(s));\n",
     "    mbar_wait(b.ring.bar(b.ring.full, s), b.ring.parity(s));\n"
     "    if (threadIdx.x == 32) PROBE(1, s)\n"),
    ("    mbar_arrive(b.ring.bar(b.ring.ready, s));\n",
     "    mbar_arrive(b.ring.bar(b.ring.ready, s));\n    if (threadIdx.x == 32) PROBE(2, s)\n"),
    ("    mbar_wait(ring.bar(ring.full, s), ring.parity(s));\n"
     "    mbar_wait(ring.bar(ring.ready, s), ring.parity(s));\n",
     "    mbar_wait(ring.bar(ring.full, s), ring.parity(s));\n"
     "    if (threadIdx.x == kProducers) PROBE(3, s)\n"
     "    mbar_wait(ring.bar(ring.ready, s), ring.parity(s));\n"
     "    if (threadIdx.x == kProducers) PROBE(4, s)\n"),
    ("      wgmma_wait<1>();\n",
     "      wgmma_wait<1>();\n      if (threadIdx.x == kProducers) PROBE(5, s)\n"),
    ("}  // namespace\n",
     "}  // namespace\n\nextern \"C\" int int8_wgmma_probe(unsigned long long* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe)));\n}\n"),
]
# the probe's intervals (cycles, the mean over stages 8..55): (name, from, to)
# where a mark is (kind, stage offset)
INTERVALS = [("copies issued -> landed (converting warp 0)", (0, 0), (1, 0)),
             ("converting warp 0: its units of the stage", (1, 0), (2, 0)),
             ("warp 0 converted -> consumer sees ready", (2, 0), (4, 0)),
             ("consumer: full -> ready seen", (3, 0), (4, 0)),
             ("consumer: ready -> the previous batch done", (4, 0), (5, 0)),
             ("stage period (consumer ready to ready)", (4, 0), (4, 1)),
             ("stage period (copier issue to issue)", (0, 0), (0, 1)),
             ("consumer ready -> the slot's next copies issued", (4, 0), (0, 4))]

PREFETCH = [("  if (threadIdx.x == 0) {\n    for (int i = 0; i < kStages; ++i) {\n",
             "  if (threadIdx.x == 0) {\n"
             "    asm volatile(\"prefetch.tensormap [%0];\" ::\"l\"(reinterpret_cast<uint64_t>("
             "&maps.x)) : \"memory\");\n"
             "    asm volatile(\"prefetch.tensormap [%0];\" ::\"l\"(reinterpret_cast<uint64_t>("
             "&maps.q)) : \"memory\");\n"
             "    for (int i = 0; i < kStages; ++i) {\n")]


def plan_with(fill=None, min_split_rows=None, unsplit=False):
    """int8_wgmma_plan with q4matmul.wgmma_splits' wave fill or the least
    split rows changed, or no din split."""
    def plan(din, dout, sms, rows):
        if unsplit:
            return -(-din // qmatmul.WGMMA_STAGE_ROWS) * qmatmul.WGMMA_STAGE_ROWS, 1
        old = q4matmul.WGMMA_WAVE_FILL
        q4matmul.WGMMA_WAVE_FILL = fill or old
        try:
            stage = qmatmul.WGMMA_STAGE_ROWS
            per, splits = q4matmul.wgmma_splits(din, dout, rows, sms, stage,
                                                min_split_rows or stage, 1.0)
        finally:
            q4matmul.WGMMA_WAVE_FILL = old
        return per * stage, splits
    return plan


# name -> ([(old, new), ...], is a diagnostic[, the split plan])
VARIANTS = {
    "committed": ([], False),
    "producers_1": ([(PRODUCERS, "constexpr int kProducerGroups = 1;")], False),
    "stages_3": ([(STAGES, "constexpr int kStages = 3;")], False),
    "stages_5": ([(STAGES, "constexpr int kStages = 5;")], False),
    "wait_0": ([("      wgmma_wait<1>();\n", "      wgmma_wait<0>();\n")], False),
    "prefetch": (PREFETCH, False),
    "plan_fill_half": ([], False, plan_with(fill=0.5)),
    "plan_min_2_stages": ([], False, plan_with(min_split_rows=128)),
    "plan_min_4_stages": ([], False, plan_with(min_split_rows=256)),
    "plan_unsplit": ([], False, plan_with(unsplit=True)),
    "probe": (PROBE_EDITS, True),
    "drop_convert": ([(CONVERT, "      ;\n")], True),
    "drop_wgmma": ([(WGMMA, "        ;\n")], True),
    "drop_x_copy": (X_COPY, True),
}


def source(name: str) -> str:
    text = SRC.read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise SystemExit(f"{name}: edit not found: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(names) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        if len(VARIANTS[name]) > 2:
            continue  # a plan of the committed source
        src = OUT / f"{name}.cu"
        src.write_text(source(name))
        lib = OUT / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC),
               "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs, spills = cs.ptxas_summary(log)
        notes = sorted(set(re.findall(r"\((C75\d\d)\)", log)))
        print(f"[build] {name}: max {regs} registers, {spills} bytes of spill stores, "
              f"ptxas notes {notes}", flush=True)
        lib = ctypes.CDLL(str(path))
        if name == "probe":
            lib.int8_wgmma_probe.argtypes = [ctypes.c_void_p]
        lib.int8_wgmma.argtypes = build.SIGNATURES["int8_wgmma"]
        lib.int8_wgmma.restype = ctypes.c_int
        libs[name] = lib
    return libs


def wrapper(lib, plan=qmatmul.int8_wgmma_plan):
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def fn(x, q, scale):
        M, din = x.shape
        dout = q.shape[1]
        split_rows, splits = plan(din, dout, sms, M)
        out = torch.empty((M, dout), dtype=torch.bfloat16, device=x.device)
        partial = (torch.empty((splits, M, dout), dtype=torch.float32, device=x.device)
                   if splits > 1 else out)
        err = lib.int8_wgmma(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                             partial.data_ptr(), M, din, dout, split_rows, splits,
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"int8_wgmma variant: CUDA error {err}")
        return out
    return fn


def main() -> None:
    names = ["committed"] + [n for n in (sys.argv[1:] or VARIANTS) if n != "committed"]
    print(cs.card_line(), flush=True)
    libs = build_variants(names)
    fns = {name: wrapper(libs.get(name, libs["committed"]), *VARIANTS[name][2:])
           for name in names}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    if "probe" in names:
        # one unsplit launch at 4096 x 4096, M = 512: 64 stages a block
        qp = quantize_tensor(torch.randn(4096, 4096, device=dev, generator=g) / 64)
        xp = torch.randn(512, 4096, device=dev, generator=g).to(torch.bfloat16)
        fns["probe"](xp, qp.q, qp.scale)
        torch.cuda.synchronize()
        marks = (ctypes.c_ulonglong * (6 * 64))()
        if libs["probe"].int8_wgmma_probe(ctypes.addressof(marks)):
            raise SystemExit("probe: reading the marks failed")
        for what, (k0, d0), (k1, d1) in INTERVALS:
            d = [marks[k1 * 64 + st + d1] - marks[k0 * 64 + st + d0] for st in range(8, 56)]
            print(f"[probe] {what}: mean {sum(d) / len(d):.0f} cycles, min {min(d)}, "
                  f"max {max(d)}", flush=True)
        names.remove("probe")
    qt = quantize_tensor(torch.randn(1024, 3072, device=dev, generator=g) / 32)
    x = torch.randn(200, 1024, device=dev, generator=g).to(torch.bfloat16)
    ref = qmatmul.int8_gemv_plain(x, qt.q, qt.scale)
    for name in names:
        if not VARIANTS[name][1]:
            err = cs.rel_err(fns[name](x, qt.q, qt.scale), ref)
            print(f"[check] {name}: max rel err {err:.3e} (bound "
                  f"{cs.BOUNDS[torch.bfloat16]:.0e})", flush=True)
            if err > cs.BOUNDS[torch.bfloat16]:
                raise SystemExit(f"{name} disagrees with the plain version")

    tts = {s: n for s, n in cs.TTS_INT8_SHAPES.items() if s[1] % 64 == 0}
    sets = [(f"depformer x {sum(cs.INT8_SHAPES.values())}", cs.INT8_SHAPES, ROWS),
            (f"tts x {sum(tts.values())}", tts, (32,))]
    cases = {}
    for what, shapes, rows in sets:
        for (din, dout), n in shapes.items():
            w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
            copies = [quantize_tensor(w)]
            nbytes = copies[0].q.numel() + 4 * copies[0].scale.numel()
            copies += [quantize_tensor(w) for _ in range(cs.copies_for_cold_l2(nbytes) - 1)]
            for M in rows:
                x = torch.randn(M, din, device=dev, generator=g).to(torch.bfloat16)
                cases.setdefault(f"{what} M={M}", []).append(
                    (n, [(x, c.q, c.scale) for c in copies]))
    totals = {name: {key: [] for key in cases} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            for key, shapes in cases.items():
                totals[name][key].append(sum(n * cs.time_ms(fns[name], ops)
                                             for n, ops in shapes))
    for name in names:
        line = ", ".join(f"{key} {' / '.join(f'{t:.3f}' for t in totals[name][key])} ms"
                         for key in cases)
        print(f"[variants] {name}: {line}", flush=True)


if __name__ == "__main__":
    main()
