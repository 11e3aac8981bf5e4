"""Time design variants of the q4_wgmma kernel on one NVIDIA GPU.

    python3 scripts/time_q4_wgmma_variants.py [NAME ...]

Each variant is moshi_tpu_torch/csrc/q4_wgmma.cu with textual edits
(VARIANTS): a design choice changed, or, for a diagnostic ("drop_*"), one
piece of a stage's work taken out, so that the time it saves shows what
that piece costs on the kernel's critical path (a diagnostic computes a
wrong result and is not checked).  The others are checked against the
plain version at 4096 x 4096, M = 256.  Every variant is timed with
chip_smoke.time_ms (CUDA-graph replay, operands cold in L2) over one
Moshi-7B offline forward's 129 launches (chip_smoke.Q4_SHAPES) at M = 256
and M = 64, with the committed split plans, in the listed order and again
in reverse.  Sources and libraries go to build/q4w_variants/ (gitignored);
ptxas registers, spills and wgmma notes and the card's name and power
limit are printed.  With NAMEs, only those variants (and the committed
kernel) are timed.

The "probe" variant records clock64() at each barrier of block (0, 0, 0)
in one unsplit launch at 4096 x 22528, M = 256 (64 stages), and prints
the mean cycles of each interval of a stage over stages 8..55: the copies'
issue, their landing as the unpack sees it, the unpack, the consumers'
waits and work, and the stage period.
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
from moshi_tpu_torch.ops import build, q4matmul  # noqa: E402
from moshi_tpu_torch.utils.quantize import quantize_tensor4  # noqa: E402

OUT = ROOT / "build" / "q4w_variants"
SRC = build.CSRC / "q4_wgmma.cu"
ROWS = (256, 64)

UNPACK = "    for (int unit = u >> 5; unit < 8; unit += kUnpackWarps)\n"
LAUNCH = "        : group_size == 32 ? launch<2>(maps, a, grid, s)"
SCALE = "          scale_group(acc, g0, scales(b.ring, s) + j * kCols, l.tig);\n"
WGMMA = ("            wgmma_m64n128k16(g0, da + 2 * (j * kSpg + i), db + 2 * (j * kSpg + i), "
         "i);\n")
X_COPY = [("    tma_load_2d(st, &maps.x, k0, row0, full);\n", ""),
          ("    mbar_expect(full, kXBytes + kQBytes + kSBytes);",
           "    mbar_expect(full, kQBytes + kSBytes);")]
STAGES = "constexpr int kStages = 4;"

# the probe: clock64() stamps of block (0, 0, 0) at each barrier of a
# stage (< 64), read back through q4_wgmma_probe
PROBE_HEAD = ('#include "wgmma_common.cuh"\n',
              '#include "wgmma_common.cuh"\n'
              '__device__ unsigned long long g_probe[7 * 64];\n'
              '#define PROBE(k, s) if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 '
              '&& (s) < 64) g_probe[(k) * 64 + (s)] = clock64();\n')
PROBE_EDITS = [
    PROBE_HEAD,
    ("    mbar_expect(full, kXBytes + kQBytes + kSBytes);\n",
     "    PROBE(0, i)\n    mbar_expect(full, kXBytes + kQBytes + kSBytes);\n"),
    ("    tma_load_2d(st + kSOffset, &maps.scale, c0, sp.g0 + i * kSteps / (a.gs / 16), full);\n",
     "    tma_load_2d(st + kSOffset, &maps.scale, c0, sp.g0 + i * kSteps / (a.gs / 16), full);\n"
     "    PROBE(1, i)\n"),
    ("    unsigned char* st = b.ring.stage(i);\n",
     "    if (threadIdx.x == 32) PROBE(2, i)\n    unsigned char* st = b.ring.stage(i);\n"),
    ("    mbar_arrive(b.ring.bar(b.ring.ready, i));\n",
     "    mbar_arrive(b.ring.bar(b.ring.ready, i));\n    if (threadIdx.x == 32) PROBE(3, i)\n"),
    ("  mbar_wait(ring.bar(ring.full, s), ring.parity(s));\n"
     "  mbar_wait(ring.bar(ring.ready, s), ring.parity(s));\n",
     "  mbar_wait(ring.bar(ring.full, s), ring.parity(s));\n"
     "  if (threadIdx.x == kProducers) PROBE(4, s)\n"
     "  mbar_wait(ring.bar(ring.ready, s), ring.parity(s));\n"
     "  if (threadIdx.x == kProducers) PROBE(5, s)\n"),
    ("    if (lane == 0) mbar_arrive(ring.bar(ring.empty, s));\n",
     "    if (lane == 0) mbar_arrive(ring.bar(ring.empty, s));\n"
     "    if (threadIdx.x == kProducers) PROBE(6, s)\n"),
    ("}  // namespace\n",
     "}  // namespace\n\nextern \"C\" int q4_wgmma_probe(unsigned long long* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe)));\n}\n"),
]
# the probe's intervals (cycles, the mean over stages 8..55): (name, from, to)
# where a mark is (kind, stage offset)
INTERVALS = [("copier: issuing the copies", (0, 0), (1, 0)),
             ("copies issued -> landed (unpacker)", (1, 0), (2, 0)),
             ("unpack", (2, 0), (3, 0)),
             ("unpacked -> consumer sees full", (3, 0), (4, 0)),
             ("consumer: full -> ready seen", (4, 0), (5, 0)),
             ("consumer: ready -> stage released", (5, 0), (6, 0)),
             ("stage period (consumer ready to ready)", (5, 0), (5, 1)),
             ("stage period (copier issue to issue)", (1, 0), (1, 1)),
             ("consumer warp 0 released -> the slot's next copies", (6, 0), (0, 4))]

# name -> ([(old, new), ...], is a diagnostic)
VARIANTS = {
    "committed": ([], False),
    "stages_5": ([(STAGES, "constexpr int kStages = 5;")], False),
    "segmented": ([(LAUNCH, "        : group_size == -1 ? launch<2>(maps, a, grid, s)")], False),
    "probe": (PROBE_EDITS, True),
    "drop_unpack": ([(UNPACK, "    for (int unit = u >> 5; unit < 0; unit += kUnpackWarps)\n")],
                    True),
    "drop_scale": ([(SCALE, "          acc[0] += g0[0];\n")], True),
    "drop_wgmma": ([(WGMMA, "            ;\n")], True),
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
            lib.q4_wgmma_probe.argtypes = [ctypes.c_void_p]
        lib.q4_wgmma.argtypes = build.SIGNATURES["q4_wgmma"]
        lib.q4_wgmma.restype = ctypes.c_int
        libs[name] = lib
    return libs


def wrapper(lib):
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def fn(x, q, scale):
        M, din = x.shape
        dout = q.shape[1]
        gs = din // scale.shape[0]
        gps, splits = q4matmul.wgmma_plan_splits(din, dout, gs, sms, M)
        out = torch.empty((M, dout), dtype=torch.bfloat16, device=x.device)
        partial = (torch.empty((splits, M, dout), dtype=torch.float32, device=x.device)
                   if splits > 1 else out)
        err = lib.q4_wgmma(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           partial.data_ptr(), M, din, dout, gs, gps, splits,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"q4_wgmma variant: CUDA error {err}")
        return out
    return fn


def main() -> None:
    names = ["committed"] + [n for n in (sys.argv[1:] or VARIANTS) if n != "committed"]
    print(cs.card_line(), flush=True)
    libs = build_variants(names)
    fns = {name: wrapper(lib) for name, lib in libs.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    if "probe" in names:
        # one unsplit launch at 4096 x 22528, M = 256: 64 stages a block
        qp = quantize_tensor4(torch.randn(4096, 22528, device=dev, generator=g) / 64)
        xp = torch.randn(256, 4096, device=dev, generator=g).to(torch.bfloat16)
        fns["probe"](xp, qp.q, qp.scale)
        torch.cuda.synchronize()
        marks = (ctypes.c_ulonglong * (7 * 64))()
        if libs["probe"].q4_wgmma_probe(ctypes.addressof(marks)):
            raise SystemExit("probe: reading the marks failed")
        for what, (k0, d0), (k1, d1) in INTERVALS:
            d = [marks[k1 * 64 + st + d1] - marks[k0 * 64 + st + d0] for st in range(8, 56)]
            print(f"[probe] {what}: mean {sum(d) / len(d):.0f} cycles, min {min(d)}, "
                  f"max {max(d)}", flush=True)
        names.remove("probe")
    qt = quantize_tensor4(torch.randn(4096, 4096, device=dev, generator=g) / 64)
    x = torch.randn(256, 4096, device=dev, generator=g).to(torch.bfloat16)
    ref = q4matmul.q4_gemv_plain(x, qt.q, qt.scale)
    for name in names:
        if not VARIANTS[name][1]:
            err = cs.rel_err(fns[name](x, qt.q, qt.scale), ref)
            print(f"[check] {name}: max rel err {err:.3e} (bound "
                  f"{cs.BOUNDS[torch.bfloat16]:.0e})", flush=True)
            if err > cs.BOUNDS[torch.bfloat16]:
                raise SystemExit(f"{name} disagrees with the plain version")

    cases = []
    for (din, dout), n in cs.Q4_SHAPES.items():
        w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
        copies = [quantize_tensor4(w)]
        nbytes = copies[0].q.numel() + 4 * copies[0].scale.numel()
        copies += [quantize_tensor4(w) for _ in range(cs.copies_for_cold_l2(nbytes) - 1)]
        xs = {M: torch.randn(M, din, device=dev, generator=g).to(torch.bfloat16) for M in ROWS}
        cases.append((n, copies, xs))
    totals = {name: {M: [] for M in ROWS} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            for M in ROWS:
                ms = sum(n * cs.time_ms(fns[name], [(xs[M], c.q, c.scale) for c in copies])
                         for n, copies, xs in cases)
                totals[name][M].append(ms)
    for name in names:
        line = ", ".join(f"M={M} {' / '.join(f'{t:.3f}' for t in totals[name][M])} ms"
                         for M in ROWS)
        print(f"[variants] {name}: 129 launches {line}", flush=True)


if __name__ == "__main__":
    main()
