"""Smoke run of the PyTorch/CUDA port (moshi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. device  - the card's name and `nvidia-smi` name/power limit; fails at
               once when torch sees no CUDA device;
  2. build   - nvcc builds every kernel from moshi_tpu_torch/csrc/ into
               build/kernels/ (skipped when a library of the same sources
               is already there);
  3. kernels - each kernel against its plain PyTorch version at the main
               path's shapes (B = 1 and 4, bf16 and f32), max relative
               error against its bound, and CUDA-event times of both;
  4. slice   - Moshi-7B shapes with q4 temporal weights and an int8
               depformer, bf16 KV cache, bf16 Mimi, all initialised from a
               seed on the card; ServerState.warmup(), then 3 sessions of 40
               frames of seeded PCM with sampling on (sessions 1 and 3 share
               a seed).  Checks PCM, token ranges, that sessions 1 and 3
               agree, and that the kernel launch counts are exactly what the
               config implies per LMGen.step; prints the p50 ms per frame.
Then a JSON line of the kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "moshi_tpu_torch" / "csrc").is_dir():
    sys.exit(f"chip_smoke.py: no moshi_tpu_torch package beside {__file__}")
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 1234
SESSIONS = (11, 12, 11)  # session seeds; the first and last are equal
FRAMES = 40
BATCHES = (1, 4)
# max |kernel - plain| / max |plain|
BOUNDS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# main-path shapes (din, dout) of Moshi-7B -> launches per LMGen.step.
# q4: temporal in_proj, out_proj, linear_in, linear_out (32 layers) and the
# text head.  int8: depformer in_proj, out_proj, linear_in, linear_out (6
# layers x 8 codebooks), the output heads (linears) and depformer_in.
Q4_SHAPES = {(4096, 12288): 32, (4096, 4096): 32, (4096, 22528): 32,
             (11264, 4096): 32, (4096, 32000): 1}
INT8_SHAPES = {(1024, 3072): 48, (1024, 1024): 48, (1024, 5632): 48,
               (2816, 1024): 48, (1024, 2048): 8, (4096, 1024): 8}
TPU_KERNELS = {
    # q4gemm and q4gemm_stacked
    "q4_gemv": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    "int8_gemv": "moshi_tpu/ops/qmatmul.py:48",  # qgemv
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    return ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def time_ms(fn, operands, iters: int = 20, reps: int = 3) -> float:
    """Device ms per call.  `iters` calls, cycling through `operands`
    (copies of the weights larger in total than the 50 MB L2, so each call
    reads its weights from device memory as the main path does), are
    captured in a CUDA graph; the graph's replays are timed with CUDA
    events, so the host's launch cost is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for ops in operands:
            fn(*ops)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*operands[i % len(operands)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def check_kernels(dev) -> list[dict]:
    from moshi_tpu_torch.ops.q4matmul import q4_gemv, q4_gemv_plain
    from moshi_tpu_torch.ops.qmatmul import int8_gemv, int8_gemv_plain
    from moshi_tpu_torch.utils.quantize import quantize_tensor, quantize_tensor4

    g = torch.Generator(device=dev).manual_seed(SEED)
    table = []
    for name, fn, plain, quant, shapes, src in (
            ("q4_gemv", q4_gemv, q4_gemv_plain, quantize_tensor4, Q4_SHAPES,
             "moshi_tpu_torch/csrc/q4_gemv.cu"),
            ("int8_gemv", int8_gemv, int8_gemv_plain, quantize_tensor, INT8_SHAPES,
             "moshi_tpu_torch/csrc/int8_gemv.cu")):
        max_abs, ms, plain_ms = 0.0, {}, {}
        for din, dout in shapes:
            w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
            qt = quant(w)
            for B in BATCHES:
                for dt in (torch.bfloat16, torch.float32):
                    x = torch.randn(B, din, device=dev, generator=g).to(dt)
                    y = fn(x, qt.q, qt.scale)
                    torch.cuda.synchronize()
                    ref = plain(x, qt.q, qt.scale)
                    err = rel_err(y, ref)
                    max_abs = max(max_abs, (y.float() - ref.float()).abs().max().item())
                    ok = err <= BOUNDS[dt] and bool(torch.isfinite(y).all())
                    phase("kernels", f"{name} {din}x{dout} B={B} {str(dt)[6:]}: "
                          f"max rel err {err:.3e} (bound {BOUNDS[dt]:.0e}) "
                          f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise RuntimeError(f"{name} disagrees with its plain version")
            # time at the main path's operands: B = 1, bf16
            bytes_w = qt.q.numel() + 4 * qt.scale.numel()
            copies = [quant(w) for _ in range(max(2, -(-256 * 2 ** 20 // bytes_w)))]
            x = torch.randn(1, din, device=dev, generator=g).to(torch.bfloat16)
            operands = [(x, c.q, c.scale) for c in copies]
            ms[(din, dout)] = time_ms(fn, operands)
            plain_ms[(din, dout)] = time_ms(plain, operands)
            phase("kernels", f"{name} {din}x{dout} B=1 bf16: kernel "
                  f"{ms[(din, dout)]:.4f} ms, plain {plain_ms[(din, dout)]:.4f} ms, "
                  f"{bytes_w / ms[(din, dout)] / 1e6:.1f} GB/s of packed weight")
            del copies, operands
        torch.cuda.synchronize()
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": TPU_KERNELS[name], "max_abs_err": max_abs,
                      "shapes": shapes, "ms": ms, "plain_ms": plain_ms})
    return table


def per_step_launches(cfg, params) -> dict:
    """Kernel launches one LMGen.step implies: each q4 temporal linear once
    per layer plus the text head; each int8 depformer linear once per layer
    and codebook, plus depformer_in and the output head per codebook."""
    from moshi_tpu_torch.utils.quantize import QTensor, QTensor4

    layers = params["transformer"]["layers"]
    temporal = [layers["attn"]["in_proj"], layers["attn"]["out_proj"],
                layers["mlp"]["linear_in"], layers["mlp"]["linear_out"]]
    dlayers = params["depformer"]["layers"]
    dep = [dlayers["attn"]["in_proj"], dlayers["attn"]["out_proj"],
           dlayers["mlp"]["linear_in"], dlayers["mlp"]["linear_out"]]
    kinds = ([isinstance(w, QTensor4) for w in temporal + [params["text_linear"]["weight"]]]
             + [isinstance(w, QTensor) for w in dep + [params["depformer_in"]["weight"],
                                                       params["linears"]["weight"]]])
    if not all(kinds):
        raise RuntimeError("the quantized tree is not q4 temporal / int8 depformer")
    per_step = {"q4_gemv": cfg.num_layers * len(temporal) + 1,
                "int8_gemv": cfg.depformer_num_layers * len(dep) * cfg.dep_q + 2 * cfg.dep_q}
    if per_step != {"q4_gemv": sum(Q4_SHAPES.values()),
                    "int8_gemv": sum(INT8_SHAPES.values())}:
        raise RuntimeError(f"launches per step {per_step} do not match the shape tables")
    return per_step


def run_slice(dev, card: str) -> tuple[dict, float]:
    from moshi_tpu_torch.models.lm import LMModel, lm_config_v0_1
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config
    from moshi_tpu_torch.ops.q4matmul import q4_gemv
    from moshi_tpu_torch.ops.qmatmul import int8_gemv
    from moshi_tpu_torch.serve.server import ServerState, serve_sessions
    from moshi_tpu_torch.utils.quantize import quantize_lm_params

    t0 = time.perf_counter()
    cfg = lm_config_v0_1()
    lm = LMModel(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED)
    lm_params = quantize_lm_params(lm.init_params(g, torch.bfloat16, dev), mode="int4")
    torch.cuda.empty_cache()
    mimi = MimiModel(mimi_v0_1_config(cfg.dep_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    expected = per_step_launches(cfg, lm_params)
    state = ServerState(mimi, mimi_params, lm, lm_params, device=dev)
    torch.cuda.synchronize()
    phase("slice", f"Moshi-7B q4 + Mimi bf16 built from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB on the card")
    state.warmup()
    torch.cuda.synchronize()

    q4_gemv.launches = int8_gemv.launches = 0
    results = serve_sessions(state, SESSIONS, FRAMES)
    torch.cuda.synchronize()
    launches = {"q4_gemv": q4_gemv.launches, "int8_gemv": int8_gemv.launches}

    steps = len(SESSIONS) * FRAMES
    for name, n in launches.items():
        if n != expected[name] * steps:
            raise RuntimeError(f"{name}: {n} launches, expected {expected[name]} x {steps}")
    for i, (tokens, audio, _) in enumerate(results):
        if len(tokens) != FRAMES - cfg.max_delay:
            raise RuntimeError(f"session {i}: {len(tokens)} frames generated")
        if not all(p.shape == (mimi.frame_size,) and np.isfinite(p).all() for p in audio):
            raise RuntimeError(f"session {i}: PCM frames of the wrong size or not finite")
        if not ((tokens[:, 0] >= 0).all() and (tokens[:, 0] < cfg.text_card).all()
                and (tokens[:, 1:] >= 0).all() and (tokens[:, 1:] < cfg.card).all()):
            raise RuntimeError(f"session {i}: token out of range")
    if not np.array_equal(results[0][0], results[2][0]):
        raise RuntimeError("sessions 1 and 3 share a seed but not their tokens")
    if np.array_equal(results[0][0], results[1][0]):
        raise RuntimeError("sessions 1 and 2 have different seeds but equal tokens")
    ms = np.concatenate([r[2] for r in results])
    p50 = float(np.percentile(ms, 50))
    phase("slice", f"{len(SESSIONS)} sessions x {FRAMES} frames: launches {launches} "
          f"= per step {expected} x {steps}; sessions 1 and 3 identical; "
          f"p50 {p50:.2f} ms/frame, p90 {np.percentile(ms, 90):.2f} ms/frame "
          f"({card})")
    return launches, p50


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device")
    import moshi_tpu_torch  # noqa: F401  (pins TF32 off)
    from moshi_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    card = card_line()
    phase("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    for name in build.SIGNATURES:
        build.load(name)
    phase("build", f"{', '.join(build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {build.build_seconds or 'libraries already built'}) -> {build.BUILD_DIR}")

    table = check_kernels(dev)
    torch.cuda.synchronize()

    launches, p50 = run_slice(dev, card)
    torch.cuda.synchronize()

    kernels = []
    for k in table:
        # ms / plain_ms: card time of one LMGen.step's launches of this
        # kernel (B = 1, bf16, weights cold in L2), from the per-shape times
        kernels.append({"name": k["name"], "route": k["route"], "source": k["source"],
                        "replaces": k["replaces"], "launches": launches[k["name"]],
                        "max_abs_err": k["max_abs_err"],
                        "ms": sum(n * k["ms"][sh] for sh, n in k["shapes"].items()),
                        "plain_ms": sum(n * k["plain_ms"][sh]
                                        for sh, n in k["shapes"].items()),
                        "ms_by_shape": {f"{a}x{b}": v for (a, b), v in k["ms"].items()},
                        "plain_ms_by_shape": {f"{a}x{b}": v
                                              for (a, b), v in k["plain_ms"].items()}})
    print(json.dumps({"kernels": kernels, "frame_p50_ms": p50}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
