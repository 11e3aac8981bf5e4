"""Time design variants of the CUDA-core GEMV kernels (csrc/q4_gemv.cu,
csrc/int8_gemv.cu, csrc/gemv_common.cuh) on one NVIDIA GPU.

    python3 scripts/time_gemv_variants.py [NAME ...]

Each variant is a copy of the three sources with textual edits (VARIANTS):
a design choice changed, or, for a diagnostic ("drop_*"), one piece of the
work taken out, so that the time it saves shows what that piece costs (a
diagnostic computes a wrong result and is not checked; the others are
checked against the plain versions).  Each is timed with
chip_smoke.time_ms (CUDA-graph replay, weights cold in L2) over the B = 1
frame's 129 q4 launches (chip_smoke.Q4_SHAPES, bf16) and the TTS frame's 17
int8 head launches (B = 16, bf16), each shape under the plan
`gemv_plan` picks and under PLANS' candidates, keeping the fastest, in the
listed order and again in reverse.  Sources and libraries go to
build/gemv_variants/ (gitignored); ptxas registers and spills and the
card's name and power limit are printed.  With NAMEs, only those variants
(and the committed kernels) are timed.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from moshi_tpu_torch.ops import build, q4matmul, qmatmul  # noqa: E402
from moshi_tpu_torch.utils.quantize import quantize_tensor, quantize_tensor4  # noqa: E402

OUT = ROOT / "build" / "gemv_variants"
FILES = ("q4_gemv.cu", "int8_gemv.cu", "gemv_common.cuh")
# plans tried beside the picked one, by (kernel, din, dout): (cols, warps, cluster)
PLANS = {("q4", 4096, 12288): [(16, 8, 8), (16, 4, 8), (16, 8, 4)],
         ("q4", 4096, 4096): [(16, 8, 8), (8, 8, 8), (16, 4, 8)],
         ("q4", 4096, 22528): [(16, 8, 4), (16, 4, 5), (16, 8, 2)],
         ("q4", 11264, 4096): [(16, 8, 8), (8, 8, 8), (8, 8, 6)],
         ("q4", 4096, 32000): [(16, 8, 4), (16, 8, 2), (16, 4, 4)],
         ("int8", 2048, 32001): [(4, 4, 1), (4, 8, 2), (4, 4, 2)],
         ("int8", 1024, 2049): [(4, 8, 6), (4, 4, 8), (4, 8, 8)]}

Q4_LOAD = ("      if (j < n) gemv::cp_async<C>(st + j * 32 * C, qc + static_cast<size_t>(p + j) * "
           "dout);\n")
Q4_SCALE = "    const float4 v = __ldg(reinterpret_cast<const float4*>(sc + g * dout) + k);\n"
Q4_MATH = ("        for (int c = 0; c < C; ++c) gacc[b][c] = fmaf(xv.y, hi[c], fmaf(xv.x, lo[c], "
           "gacc[b][c]));\n")
I8_MATH = ("        float s = acc[b][c];\n        s = fmaf(xv.x, wf[0][c], s);\n"
           "        s = fmaf(xv.y, wf[1][c], s);\n        s = fmaf(xv.z, wf[2][c], s);\n"
           "        acc[b][c] = fmaf(xv.w, wf[3][c], s);\n")
I8_LOADS = [("        if (4 * lane < tail + m) gemv::cp_async<4>(dst + 4 * lane, a0 + 4 * lane);\n",
             ""),
            ("        if (lane == 0 && m != 0 && 128 < tail + m) gemv::cp_async<4>(dst + 128, a0 + 128);\n",
             ""),
            ("        if (C * lane < tail) gemv::cp_async<C>(dst + C * lane, rp + C * lane);\n", "")]
EXCHANGE = "    *(cluster.map_shared_rank(slots, owner) + rank * q + i - owner * q) = s;\n"

# the probe: per block (the first 4096), thread 0's %globaltimer at entry and
# exit and clock64() at entry, after x's first staging, after the block's
# warps are done (the barrier in reduce_store), after the cluster exchange
# and at exit; read back through gemv_probe
PROBE_HEAD = ("#include <cuda_runtime.h>\n",
              "#include <cuda_runtime.h>\n"
              "__device__ unsigned long long g_probe[4096 * 8];\n"
              "__device__ __forceinline__ unsigned long long gtime() {\n"
              "  unsigned long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));"
              " return t; }\n"
              "#define PROBE(k, v) if (threadIdx.x == 0 && blockIdx.x * gridDim.y + blockIdx.y < "
              "4096) g_probe[(blockIdx.x * gridDim.y + blockIdx.y) * 8 + (k)] = (v);\n"
              "extern \"C\" int gemv_probe(unsigned long long* host) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe)));\n"
              "}\n")
ENTRY = "  gemv::cluster_arrive_relaxed();  // this block has started; waited on before the first remote store\n"
PROBE_EDITS = [("gemv_common.cuh",) + PROBE_HEAD,
               ("gemv_common.cuh", "  __syncthreads();\n  cluster_wait();  // every block of the cluster has started\n",
                "  __syncthreads();\n  PROBE(3, clock64())\n  cluster_wait();  // every block of the cluster has started\n"),
               ("gemv_common.cuh", "  cluster_wait();  // every rank's sums are in their owners' slots\n",
                "  cluster_wait();  // every rank's sums are in their owners' slots\n  PROBE(4, clock64())\n")]
for f, stage in (("q4_gemv.cu", "    xst.store(static_cast<const T*>(a.x), xs, ld, a.din, s0, s1);\n"),
                 ("int8_gemv.cu", "    xst.store(static_cast<const T*>(a.x), xs, ld, a.din, s0, s1);\n")):
    PROBE_EDITS += [(f, ENTRY, ENTRY + "  PROBE(0, gtime())\n  PROBE(1, clock64())\n"),
                    (f, stage, stage + "    if (s0 == blk0) { PROBE(2, clock64()) }\n"),
                    (f, "static_cast<T*>(a.out), a.dout, tile0);\n}\n",
                     "static_cast<T*>(a.out), a.dout, tile0);\n  PROBE(5, clock64())\n  PROBE(6, gtime())\n}\n")]

# name -> ([(file, old, new), ...], is a diagnostic)
VARIANTS = {
    "committed": ([], False),
    "ring_16k": ([("gemv_common.cuh", "constexpr int kRingBytes = 8 * 1024;",
                   "constexpr int kRingBytes = 16 * 1024;")], False),
    "drop_stage": ([("gemv_common.cuh",
                     "        v[u][b] = rr < rows ? to_f32(x[static_cast<size_t>(b) * din + r0 + rr]) : 0.f;\n",
                     "        v[u][b] = rr < rows ? 1.f : 0.f;\n")], True),
    "drop_math": ([("q4_gemv.cu", Q4_MATH,
                    "        gacc[b][0] += __uint_as_float(w.w[0] ^ w.w[C / 4 - 1]) * xv.x;\n"),
                   ("int8_gemv.cu", I8_MATH,
                    "        if (c == 0) acc[b][0] += wf[0][0] + wf[1][0] + wf[2][0] + wf[3][0];\n")],
                  True),
    "drop_loads": ([("q4_gemv.cu", Q4_LOAD, "      ;\n"),
                    ("q4_gemv.cu", Q4_SCALE, "    const float4 v = make_float4(g, k, 1.f, 2.f);\n")]
                   + [("int8_gemv.cu",) + e for e in I8_LOADS], True),
    "drop_exchange": ([("gemv_common.cuh", EXCHANGE, "    slots[i % q] = s;\n")], True),
    "drop_scales": ([("q4_gemv.cu", Q4_SCALE, "    const float4 v = make_float4(g, k, 1.f, 2.f);\n")],
                    True),
    "probe": (PROBE_EDITS, True),
}


def sources(name: str) -> dict:
    texts = {f: (build.CSRC / f).read_text() for f in FILES}
    for f, old, new in VARIANTS[name][0]:
        if old not in texts[f]:
            raise SystemExit(f"{name}: edit not found in {f}: {old!r}")
        texts[f] = texts[f].replace(old, new, 1)
    return texts


def build_variants(names) -> dict:
    jobs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in sources(name).items():
            (d / f).write_text(text)
        for kernel in ("q4_gemv", "int8_gemv"):
            lib = d / f"{kernel}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(d), "-o",
                   str(lib), str(d / f"{kernel}.cu")]
            jobs[(name, kernel)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, kernel), (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {kernel}:\n{log}")
        regs, spills = cs.ptxas_summary(log)
        print(f"[build] {name} {kernel}: max {regs} registers, {spills} bytes of spill stores",
              flush=True)
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, kernel)
        fn.argtypes = build.SIGNATURES[kernel]
        fn.restype = ctypes.c_int
        if name == "probe":
            lib.gemv_probe.argtypes = [ctypes.c_void_p]
            fn.probe = lib.gemv_probe
        libs[(name, kernel)] = fn
    return libs


def probe(fn, kind, batch, din, dout, plan, copies, x) -> None:
    """One launch under `plan` (after a warm-up on another copy), then the
    blocks' stamps: the kernel's span and its blocks' entry spread
    (%globaltimer, ns) and the mean and max cycles of each stage a block
    goes through (clock64)."""
    run = caller(fn, kind, batch, din, dout, plan)
    run(x, copies[1].q, copies[1].scale)
    torch.cuda.synchronize()
    run(x, copies[0].q, copies[0].scale)
    torch.cuda.synchronize()
    marks = (ctypes.c_ulonglong * (4096 * 8))()
    if fn.probe(ctypes.addressof(marks)):
        raise SystemExit("probe: reading the marks failed")
    blocks = min(4096, -(-dout // (32 * plan.cols)) * plan.cluster)
    m = [[marks[b * 8 + k] for k in range(7)] for b in range(blocks)]
    t0 = min(r[0] for r in m)
    entry = sorted(r[0] - t0 for r in m)
    span = max(r[6] for r in m) - t0
    stages = {"stage x": (1, 2), "loop": (2, 3), "exchange": (3, 4), "epilogue": (4, 5),
              "block": (1, 5)}
    parts = ", ".join(f"{k} {sum(r[b] - r[a] for r in m) / blocks:.0f} (max "
                      f"{max(r[b] - r[a] for r in m)})" for k, (a, b) in stages.items())
    print(f"[probe] {kind} {din}x{dout} B={batch} plan {tuple(plan)[:3]} ({blocks} blocks): span "
          f"{span / 1e3:.2f} us, entry spread p50 {entry[len(entry) // 2] / 1e3:.2f} / max "
          f"{entry[-1] / 1e3:.2f} us, block exit p50 "
          f"{sorted(r[6] - t0 for r in m)[blocks // 2] / 1e3:.2f} us; cycles: {parts}",
          flush=True)


def caller(fn, kind, batch, din, dout, plan):
    def run(x, q, scale):
        out = torch.empty(batch, dout, dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), batch, din, dout)
        err = fn(*args, *((32,) if kind == "q4" else ()), *plan, 1, stream)
        if err:
            raise RuntimeError(f"{kind} variant, plan {tuple(plan)}: CUDA error {err}")
        return out
    return run


def full_plan(kind, batch, din, dout, cols, warps, cluster):
    grain = 32 if kind == "q4" else 1
    rows = -(-(-(-din // grain)) // cluster) * grain
    seg = min(rows, max(grain, q4matmul.GEMV_X_BYTES // (4 * batch) // grain * grain))
    return q4matmul.GemvPlan(cols, warps, -(-din // rows), rows, seg)


def main() -> None:
    names = ["committed"] + [n for n in (sys.argv[1:] or VARIANTS) if n != "committed"]
    print(cs.card_line(), flush=True)
    libs = build_variants(names)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    cases = []  # (kind, batch, din, dout, launches, copies, x, plans)
    for kind, shapes, batch in (("q4", cs.Q4_SHAPES, 1),
                                ("int8", {k: v for k, v in cs.TTS_INT8_SHAPES.items()
                                          if k[1] % 64}, cs.TTS_SLOTS)):
        quant = quantize_tensor4 if kind == "q4" else quantize_tensor
        for (din, dout), n in shapes.items():
            w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
            copies = [quant(w)]
            nbytes = copies[0].q.numel() + 4 * copies[0].scale.numel()
            copies += [quant(w) for _ in range(cs.copies_for_cold_l2(nbytes) - 1)]
            x = torch.randn(batch, din, device=dev, generator=g).to(torch.bfloat16)
            picked = (q4matmul.q4_gemv_plan(batch, din, copies[0].q, 32, True, dev) if kind == "q4"
                      else qmatmul.int8_gemv_plan(batch, din, copies[0].q, True, dev))
            plans = [picked] + [full_plan(kind, batch, din, dout, *p)
                                for p in PLANS.get((kind, din, dout), [])]
            cases.append((kind, batch, din, dout, n, copies, x, plans))
    if "probe" in names:
        for kind, batch, din, dout, n, copies, x, plans in cases:
            for plan in plans[:2]:
                probe(libs[("probe", f"{kind}_gemv")], kind, batch, din, dout, plan, copies, x)
        names.remove("probe")
    for name in names:
        if VARIANTS[name][1]:
            continue
        for kind, batch, din, dout, n, copies, x, plans in cases:
            c = copies[0]
            plain = q4matmul.q4_gemv_plain if kind == "q4" else qmatmul.int8_gemv_plain
            fn = caller(libs[(name, f"{kind}_gemv")], kind, batch, din, dout, plans[0])
            err = cs.rel_err(fn(x, c.q, c.scale), plain(x, c.q, c.scale))
            if err > cs.BOUNDS[torch.bfloat16]:
                raise SystemExit(f"{name} {kind} {din}x{dout}: rel err {err:.3e}")
    totals = {name: {"q4": [], "int8": []} for name in names}
    best_plans = {name: {} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            frame = {"q4": 0.0, "int8": 0.0}
            for kind, batch, din, dout, n, copies, x, plans in cases:
                fn = libs[(name, f"{kind}_gemv")]
                times = {}
                for p in plans:
                    try:  # a variant may not take a plan (its shared memory)
                        times[tuple(p[:3])] = cs.time_ms(caller(fn, kind, batch, din, dout, p),
                                                         [(x, c.q, c.scale) for c in copies])
                    except RuntimeError:
                        times[tuple(p[:3])] = float("inf")
                best = min(times, key=times.get)
                best_plans[name][(kind, din, dout)] = (best, times[best], times[tuple(plans[0][:3])])
                frame[kind] += n * times[best]
            for kind in frame:
                totals[name][kind].append(frame[kind])
    for name in names:
        print(f"[variant] {name}: q4 B = 1 frame (129 launches) "
              f"{' / '.join(f'{t:.3f}' for t in totals[name]['q4'])} ms, TTS heads (17 "
              f"launches) {' / '.join(f'{t:.3f}' for t in totals[name]['int8'])} ms; "
              + ", ".join(f"{k[0]} {k[1]}x{k[2]}: {p} {t:.4f} (picked {tp:.4f})"
                          for k, (p, t, tp) in best_plans[name].items()), flush=True)


if __name__ == "__main__":
    main()
