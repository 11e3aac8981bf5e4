"""Time the CUDA-core GEMV kernels (csrc/q4_gemv.cu, csrc/int8_gemv.cu)
under every launch plan at the main paths' shapes, on one NVIDIA GPU.

    python3 scripts/time_gemv_plans.py [q4|tts|all] [--top N]

For each shape (q4: Moshi-7B's five q4 linears at B = 1 in bf16, the B = 1
frame; tts: the TTS heads, 2048 x 32001 and 1024 x 2049 int8 at B = 16 in
bf16) it calls the kernel's C entry with each plan of a grid (a lane's
columns, warps a block, blocks a cluster; rows_per_block and seg_rows as
ops/q4matmul.py `gemv_plan` would cut them), checks the result against the
plain version, and times it as chip_smoke.py's [kernels] phase does (CUDA
graph replays, weights cold in L2).  It prints the card's name and power
limit, each shape's N fastest plans beside the plan `gemv_plan` picks, and
the frame's sum over its launches (chip_smoke.Q4_SHAPES /
TTS_INT8_SHAPES counts) with the picked and with the fastest plans.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from moshi_tpu_torch.ops import build, q4matmul, qmatmul  # noqa: E402
from moshi_tpu_torch.utils.quantize import quantize_tensor, quantize_tensor4  # noqa: E402

WARPS = (2, 4, 8)
CLUSTERS = range(1, 9)


def plans(din, dout, batch, grain, cols_options):
    most = q4matmul.Q4_MAX_ACC if grain > 1 else q4matmul.GEMV_MAX_ACC
    for cols in cols_options:
        if cols > q4matmul.gemv_max_cols(batch, most):
            continue
        for warps in WARPS:
            for cluster in CLUSTERS:
                rows = -(-(-(-din // grain)) // cluster) * grain
                if -(-din // rows) != cluster:
                    continue
                seg = min(rows, max(grain, q4matmul.GEMV_X_BYTES // (4 * batch) // grain * grain))
                ring = q4matmul.gemv_ring_bytes("q4" if grain > 1 else "int8", batch, cols)
                if q4matmul.gemv_smem_bytes(batch, cols, warps, cluster, seg, ring) > \
                        q4matmul.GEMV_SMEM_LIMIT:
                    continue
                yield q4matmul.GemvPlan(cols, warps, cluster, rows, seg)


def caller(kind, lib, batch, din, dout, plan, gs=32):
    def run(x, q, scale):
        out = torch.empty(batch, dout, dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "q4":
            err = lib.q4_gemv(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                              batch, din, dout, gs, *plan, 1, stream)
        else:
            err = lib.int8_gemv(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                batch, din, dout, *plan, 1, stream)
        build.check(lib, err, kind)
        return out
    return run


def sweep(kind, shapes, batch, dev, g, top):
    lib = build.load("q4_gemv" if kind == "q4" else "int8_gemv")
    quant = quantize_tensor4 if kind == "q4" else quantize_tensor
    plain = q4matmul.q4_gemv_plain if kind == "q4" else qmatmul.int8_gemv_plain
    grain = 32 if kind == "q4" else 1
    picked_sum, best_sum = 0.0, 0.0
    for (din, dout), n in shapes.items():
        w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
        qt = quant(w)
        nbytes = qt.q.numel() + 4 * qt.scale.numel()
        copies = [qt] + [quant(w) for _ in range(cs.copies_for_cold_l2(nbytes) - 1)]
        del w
        x = torch.randn(batch, din, device=dev, generator=g).to(torch.bfloat16)
        ops = [(x, c.q, c.scale) for c in copies]
        ref = plain(x, qt.q, qt.scale)
        picked = (q4matmul.q4_gemv_plan(batch, din, qt.q, 32, True, dev) if kind == "q4"
                  else qmatmul.int8_gemv_plan(batch, din, qt.q, True, dev))
        times = {}
        for plan in plans(din, dout, batch, grain, (16, 8, 4)):
            if kind == "q4" and (dout % plan.cols) or kind == "int8" and plan.cols != 4 \
                    and dout % plan.cols:
                continue
            fn = caller(kind, lib, batch, din, dout, plan)
            err = cs.rel_err(fn(x, qt.q, qt.scale), ref)
            if err > cs.BOUNDS[torch.bfloat16]:
                raise RuntimeError(f"{kind} {din}x{dout} plan {tuple(plan)}: rel err {err:.3e}")
            times[plan] = cs.time_ms(fn, ops)
        bound, _ = cs.bound(nbytes + 2 * batch * (din + dout), 2 * batch * din * dout)
        ranked = sorted(times, key=times.get)
        picked_ms = times.get(picked, float("nan"))
        picked_sum += n * picked_ms
        best_sum += n * times[ranked[0]]
        print(f"{kind} {din}x{dout} B={batch} ({n} a frame, bound {bound:.4f} ms): picked "
              f"{tuple(picked)} {picked_ms:.4f} ms; fastest " + ", ".join(
                  f"{tuple(p)[:3]} {times[p]:.4f}" for p in ranked[:top]), flush=True)
        del copies
        torch.cuda.empty_cache()
    print(f"{kind} per frame: picked plans {picked_sum:.3f} ms, fastest plans "
          f"{best_sum:.3f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("time_gemv_plans.py: torch sees no CUDA device")
    what = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("-") else "all"
    top = int(sys.argv[sys.argv.index("--top") + 1]) if "--top" in sys.argv else 5
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    if what in ("q4", "all"):
        sweep("q4", cs.Q4_SHAPES, 1, dev, g, top)
    if what in ("tts", "all"):
        heads = {k: v for k, v in cs.TTS_INT8_SHAPES.items() if k[1] % 64}
        sweep("int8", heads, cs.TTS_SLOTS, dev, g, top)


if __name__ == "__main__":
    main()
