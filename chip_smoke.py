"""Smoke run of the PyTorch/CUDA port (moshi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. device  - the card's name and `nvidia-smi` name/power limit; fails at
               once when torch sees no CUDA device;
  2. build   - nvcc builds every kernel from moshi_tpu_torch/csrc/ into
               build/kernels/, one nvcc per source, all at once (skipped
               when a library of the same sources is already there), and
               prints each library's registers and spills (-Xptxas -v);
  3. kernels - each kernel against its plain PyTorch version on the card at
               the main paths' shapes: the q4_gemv and int8_gemv kernels at
               B = 1, 4, 9, 16 in bf16 and f32, q4_mma at B = 2, 4, 9, 16
               and int8_mma at B = 1, 2, 4, 9, 16 in bf16,
               decode_attention_int4 at B = 16, H = 32, D = 128 and
               64 with a ragged mask, cache_write_int4 byte for byte,
               decode_attention_int8 at the ASR path's B = 256, H = 8, cap
               750 and Moshi's B = 16, H = 32, cap 3000, D = 128 and 64, a
               ragged mask and a slot with every position masked; then
               CUDA-graph-replay times (operands cold in L2) of each kernel,
               its plain version and one PyTorch library call for the same
               work, beside the least time the card could take (bound); the
               two q4 kernels and the two int8 kernels at B = 1, 2, 4, 8, 16
               (their crossovers); one launch's floor (int8_mma and
               torch.matmul at 16 x 64, beside a one-element add_);
  4. slice   - Moshi-7B shapes with q4 temporal weights and an int8
               depformer, bf16 KV cache, bf16 Mimi, all initialised from a
               seed on the card; ServerState.warmup(), then 3 sessions of 40
               frames of seeded PCM with sampling on (sessions 1 and 3 share
               a seed).  Checks PCM, token ranges, that sessions 1 and 3
               agree, and that the kernel launch counts are exactly what the
               config implies per LMGen.step (the q4 linears on the q4_gemv
               kernel at B = 1, the int8 ones on int8_mma); prints the p50
               ms per frame;
  5. batched - the same weights with the int4 KV cache, B = 16 slots of
               BatchedMoshiState: a greedy run of 40 frames whose slots
               must agree token for token (two slots with one PCM, a slot
               that joins 5 frames late, one frozen for frames 10-14, one
               reset at frame 20 that replays the PCM from the start), then
               a sampled run of 40 frames on all 16 slots (p50/p90 ms per
               batched frame), each with exact launch counts per frame of
               the kernels (the q4 linears on q4_mma and the int8 ones on
               int8_mma at B = 16); then a
               torch.profiler pass over a few frames for the card's busy
               time; then the greedy run once more with the int8 KV cache
               (32 decode_attention_int8 per frame);
  6. asr     - batched speech-to-text at the full width of asr_300m_202501
               (bf16 weights, int8 KV cache, bf16 Mimi with 32 codebooks, a
               `delay` condition), all from a seed, B = 256 slots of
               BatchedAsrState: warm-up, then the greedy isolation run of the
               batched phase over 40 frames (text tokens and Word / EndWord
               messages; the text head's pad columns are scaled up so that
               words end), with exactly 16 decode_attention_int8 and no GEMV
               launches per frame, p50 / p75 / p90 ms per batched frame; 10
               frames of every slot for the host ms of the word trackers;
               peak memory; a profiler pass.
Then a JSON line of the kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits non-zero and prints no result.
"""

import json
import re
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
SLOTS = 16               # B of the batched phase
ASR_SLOTS = 256          # B of the asr phase
ASR_DELAY = 6            # asr_delay_in_tokens: 0.5 s at 12.5 Hz
# the `delay` conditioner of the asr phase (no checkpoint on the card's
# machine: its width and value are this script's choice)
ASR_COND = {"dim": 1024, "scale_factor": 1.0, "max_period": 10_000.0, "delay": 0.5}
BATCHES = (1, 4, 9, 16)  # GEMV checks
MMA_BATCHES = (2, 4, 9, 16)  # q4_mma checks (bf16 x only)
INT8_MMA_BATCHES = (1, 2, 4, 9, 16)  # int8_mma checks (bf16 x only)
CROSSOVER_BATCHES = (1, 2, 4, 8, SLOTS)  # both kernels of each GEMV family timed
# asr: factors of the seeded text head's columns of the end-pad (0) and pad
# (3) ids.  The random model's hidden state varies little, so its greedy
# stream settles on a few tokens and never emits a pad; with these factors
# (found by trying factors on this seed) the pads win on some frames, words
# end, and slot 0's session holds Word and EndWord messages.
ASR_PAD_LOGIT_SCALE = {0: 25.0, 3: 50.0}
# max |kernel - plain| / max |plain|
BOUNDS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# decode_attention_int4 takes q / sqrt(D) in bf16 (as the TPU kernel does):
# relative error of acc / l and of m
ATTN_BOUND = 2e-2
# main-path shapes (din, dout) of Moshi-7B -> launches per LMGen.step.
# q4: temporal in_proj, out_proj, linear_in, linear_out (32 layers) and the
# text head.  int8: depformer in_proj, out_proj, linear_in, linear_out (6
# layers x 8 codebooks), the output heads (linears) and depformer_in.
Q4_SHAPES = {(4096, 12288): 32, (4096, 4096): 32, (4096, 22528): 32,
             (11264, 4096): 32, (4096, 32000): 1}
INT8_SHAPES = {(1024, 3072): 48, (1024, 1024): 48, (1024, 5632): 48,
               (2816, 1024): 48, (1024, 2048): 8, (4096, 1024): 8}
# the int4 KV cache of the batched phase: Moshi-7B, context 3000
KV = {"layers": 32, "heads": 32, "head_dim": 128, "cap": 3000}
# decode_attention_int8's main-path shapes, (B, heads, cap) at head dim 128:
# asr_300m_202501 at B = 256 (16 launches per frame), Moshi-7B at B = 16 (32)
INT8_KV = {"asr": (ASR_SLOTS, 8, 750), "moshi_b16": (SLOTS, 32, 3000)}
TPU_KERNELS = {
    # q4gemm and q4gemm_stacked: q4_gemv on the CUDA cores (B = 1, f32),
    # q4_mma on the tensor cores (bf16, B = MMA_MIN_BATCH..16)
    "q4_gemv": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    "q4_mma": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    # qgemv: int8_gemv on the CUDA cores (f32), int8_mma on the tensor cores
    # (bf16, B = 1..16)
    "int8_gemv": "moshi_tpu/ops/qmatmul.py:48",
    "int8_mma": "moshi_tpu/ops/qmatmul.py:48",
    "decode_attention_int4": "moshi_tpu/ops/int4_attention.py:165",
    "cache_write_int4": "moshi_tpu/ops/int4_attention.py:313",
    "decode_attention_int8": "moshi_tpu/ops/decode_attention.py:90",
}
SOURCES = {name: f"moshi_tpu_torch/csrc/{name}.cu" for name in TPU_KERNELS}
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    return ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least ms the card could take: bytes over HBM bandwidth or bf16 flops
    over the tensor-core peak, the larger, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, operands, iters: int = 20, reps: int = 3) -> float:
    """Device ms per call.  `iters` calls, cycling through `operands`
    (copies larger in total than the 50 MB L2, so each call reads its
    operands from device memory as the main path does), are captured in a
    CUDA graph; the graph's replays are timed with CUDA events, so the
    host's launch cost is not in the number."""
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
    del graph
    return start.elapsed_time(end) / (reps * iters)


def copies_for_cold_l2(nbytes: int) -> int:
    return max(2, -(-256 * 2 ** 20 // nbytes))


def ptxas_summary(log: str) -> tuple[int, int]:
    """Most registers of any kernel instance and total spill bytes, from
    nvcc -Xptxas -v output."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    return max(regs, default=0), spills


# ---------------------------------------------------------------- kernels
def _check_against_plain(name, fn, plain, qt, x) -> float:
    """Raise unless fn(x, q, scale) is within BOUNDS of the plain version;
    returns max |fn - plain|."""
    y = fn(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    ref = plain(x, qt.q, qt.scale)
    err = rel_err(y, ref)
    din, dout = x.shape[1], qt.q.shape[-1]
    ok = err <= BOUNDS[x.dtype] and bool(torch.isfinite(y).all())
    phase("kernels", f"{name} {din}x{dout} B={x.shape[0]} {str(x.dtype)[6:]}: max rel err "
          f"{err:.3e} (bound {BOUNDS[x.dtype]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version")
    return (y.float() - ref.float()).abs().max().item()


def check_gemvs(dev, g, families=("q4", "int8")) -> list[dict]:
    """The weight-only GEMV kernels against their plain versions at every
    main-path shape: the q4_gemv and int8_gemv kernels at BATCHES in bf16
    and f32, q4_mma at MMA_BATCHES and int8_mma at INT8_MMA_BATCHES in
    bf16.  Then, at the main paths' operands (bf16, weights cold in L2),
    each kernel's time beside its plain version's, torch.matmul's on the
    bf16 weights and the bound, summed over one frame's launches (Q4_SHAPES
    / INT8_SHAPES counts) at CROSSOVER_BATCHES, and each family's
    crossover.  Returns a row per kernel."""
    from moshi_tpu_torch.ops import q4matmul, qmatmul
    from moshi_tpu_torch.utils.quantize import (dequantize, dequantize4, quantize_tensor,
                                                quantize_tensor4)

    both = (torch.bfloat16, torch.float32)
    # family -> ({kernel: (wrapper, checked dtypes, checked batches)}, plain
    # version, quantizer, dequantizer, shapes, timed batches)
    table = {"q4": ({"q4_gemv": (q4matmul.q4_gemv_kernel, both, BATCHES),
                     "q4_mma": (q4matmul.q4_mma, (torch.bfloat16,), MMA_BATCHES)},
                    q4matmul.q4_gemv_plain, quantize_tensor4, dequantize4, Q4_SHAPES,
                    q4matmul.MMA_MIN_BATCH),
             "int8": ({"int8_gemv": (qmatmul.int8_gemv_kernel, both, BATCHES),
                       "int8_mma": (qmatmul.int8_mma, (torch.bfloat16,), INT8_MMA_BATCHES)},
                      qmatmul.int8_gemv_plain, quantize_tensor, dequantize, INT8_SHAPES,
                      qmatmul.MMA_MIN_BATCH)}
    rows = []
    for family in families:
        kernels, plain, quant, deq, shapes, min_batch = table[family]
        simt, mma = kernels
        timed = CROSSOVER_BATCHES
        max_abs = dict.fromkeys(kernels, 0.0)
        per_frame = {k: {B: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
                         for B in timed} for k in kernels}
        by_shape, bound_by = {k: {} for k in kernels}, set()
        for (din, dout), n in shapes.items():
            w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
            qt = quant(w)
            for name, (fn, dtypes, batches) in kernels.items():
                for B in batches:
                    for dt in dtypes:
                        x = torch.randn(B, din, device=dev, generator=g).to(dt)
                        max_abs[name] = max(max_abs[name],
                                            _check_against_plain(name, fn, plain, qt, x))
            bytes_w = qt.q.numel() + 4 * qt.scale.numel()
            copies = [quant(w) for _ in range(copies_for_cold_l2(bytes_w))]
            dense = [deq(qt.q, qt.scale, torch.bfloat16)
                     for _ in range(copies_for_cold_l2(2 * din * dout))]
            for B in timed:
                x = torch.randn(B, din, device=dev, generator=g).to(torch.bfloat16)
                ops = [(x, c.q, c.scale) for c in copies]
                shared = {"plain_ms": time_ms(plain, ops),
                          "library_ms": time_ms(torch.matmul, [(x, d) for d in dense])}
                shared["bound_ms"], by = bound(bytes_w + 2 * B * (din + dout), 2 * B * din * dout)
                bound_by.add(by)
                for name, (fn, _, _) in kernels.items():
                    t = {"ms": time_ms(fn, ops), **shared}
                    for k, v in t.items():
                        per_frame[name][B][k] += n * v
                    by_shape[name][f"{din}x{dout} B={B}"] = t
                    phase("kernels", f"{name} {din}x{dout} B={B} bf16: kernel {t['ms']:.4f} ms, "
                          f"plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
                          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; "
                          f"{bytes_w / t['ms'] / 1e6:.1f} GB/s of packed weight")
            if family == "int8":
                by_shape["int8_gemv"][f"{din}x{dout} int8pack"] = int8pack_ms(qt, din, dev, g)
            del copies, dense
        torch.cuda.synchronize()
        rows += [{"name": name, "max_abs_err": max_abs[name], "per_frame": per_frame[name],
                  "by_shape": by_shape[name],
                  "bound_by": "operations" if bound_by == {"operations"} else "bytes"}
                 for name in kernels]
        if family == "int8":
            rows[-1]["launch_floor_ms"] = launch_floor_ms(dev, g)
        faster = []
        for B in timed:
            t = {k: per_frame[k][B] for k in kernels}
            if t[mma]["ms"] < t[simt]["ms"]:
                faster.append(B)
            phase("kernels", f"{family} per frame ({sum(shapes.values())} launches) B={B}: "
                  f"{simt} kernel {t[simt]['ms']:.3f} ms, {mma} {t[mma]['ms']:.3f} ms, "
                  f"torch.matmul on bf16 {t[mma]['library_ms']:.3f} ms, bound "
                  f"{t[mma]['bound_ms']:.3f} ms")
        phase("kernels", f"{family} crossover: {mma} faster at B = {faster}; the route sends "
              f"bf16 B >= MMA_MIN_BATCH = {min_batch} to {mma}")
    return rows


def launch_floor_ms(dev, g) -> dict:
    """What one launch costs whatever its work: int8_mma and torch.matmul
    on bf16 at the smallest shape int8_mma takes (16 x 64: one block),
    operands hot in L2, at B = 1 and SLOTS, beside a one-element add_."""
    from moshi_tpu_torch.ops.qmatmul import int8_mma
    from moshi_tpu_torch.utils.quantize import dequantize, quantize_tensor

    qt = quantize_tensor(torch.randn(16, 64, device=dev, generator=g))
    dense = dequantize(qt.q, qt.scale, torch.bfloat16)
    one = torch.zeros(1, device=dev)
    t = {"add_": time_ms(lambda t_: t_.add_(1), [(one,)])}
    for B in (1, SLOTS):
        x = torch.randn(B, 16, device=dev, generator=g).to(torch.bfloat16)
        t[f"int8_mma B={B}"] = time_ms(int8_mma, [(x, qt.q, qt.scale)])
        t[f"torch.matmul B={B}"] = time_ms(torch.matmul, [(x, dense)])
    phase("kernels", "one launch's floor (16 x 64, operands hot in L2): "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in t.items()))
    return t


def int8pack_ms(qt, din, dev, g):
    """torch._weight_int8pack_mm at B = SLOTS, where this build of PyTorch
    runs it on CUDA (a yardstick for int8_gemv, never called by the port);
    None where it does not."""
    x = torch.randn(SLOTS, din, device=dev, generator=g).to(torch.bfloat16)
    w = qt.q.t().contiguous()
    s = qt.scale[0].to(torch.bfloat16)
    try:
        torch._weight_int8pack_mm(x, w, s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        phase("kernels", f"torch._weight_int8pack_mm on CUDA: not available ({str(e)[:80]})")
        return None
    return time_ms(torch._weight_int8pack_mm, [(x, w, s)])


def random_int4_cache(g, L, B, Hkv, D, cap_pad, dev):
    """Packed caches with every nibble in [-7, 7], positive bf16 scales."""
    def packed():
        vals = torch.randint(-7, 8, (L, B, Hkv * D // 2, cap_pad, 2), device=dev,
                             generator=g, dtype=torch.int8)
        return (vals[..., 1] << 4) | (vals[..., 0] & 15)

    def scales():
        return (0.01 + 0.2 * torch.rand(L, B, Hkv, cap_pad, device=dev, generator=g)
                ).to(torch.bfloat16)
    return packed(), packed(), scales(), scales()


def check_attention(dev, g) -> dict:
    """decode_attention_int4 against its plain version at B = SLOTS, H = 32,
    D = 128 and 64, cap 3000, a ragged mask, layer 5 of 8; times at the
    main path's D = 128, per launch and per batched frame."""
    from moshi_tpu_torch.ops.int4_attention import (_dequant_layer,
                                                    decode_attention_int4_stats as k4,
                                                    decode_attention_int4_stats_plain as k4p)
    import torch.nn.functional as F

    B, H, cap, L, layer = SLOTS, KV["heads"], KV["cap"], 8, 5
    cap_pad = -(-cap // 128) * 128
    max_abs, row = 0.0, {}
    for D in (128, 64):
        caches = random_int4_cache(g, L, B, H, D, cap_pad, dev)
        q = torch.randn(B, H, 1, D, device=dev, generator=g).to(torch.bfloat16)
        valid = torch.randint(1, cap + 1, (B,), device=dev, generator=g)
        mask = ((torch.rand(B, cap, device=dev, generator=g) < 0.9)
                & (torch.arange(cap, device=dev)[None] < valid[:, None]))
        mask[:, 0] = True
        acc, m, lse = k4(q, layer, *caches, mask)
        torch.cuda.synchronize()
        racc, rm, rl = k4p(q, layer, *caches, mask)
        err = max(rel_err(acc / lse, racc / rl), rel_err(m, rm))
        max_abs = max(max_abs, (acc / lse - racc / rl).abs().max().item())
        ok = err <= ATTN_BOUND and bool(torch.isfinite(acc / lse).all())
        phase("kernels", f"decode_attention_int4 B={B} H={H} D={D} cap={cap} layer={layer}: "
              f"max rel err of acc/l and m {err:.3e} (bound {ATTN_BOUND:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("decode_attention_int4 disagrees with its plain version")
        if D != KV["head_dim"]:
            continue
        ops = [(q, li, *caches, mask) for li in range(L)]
        t = {"ms": time_ms(k4, ops), "plain_ms": time_ms(k4p, ops, iters=4)}

        def dense(li):
            return [_dequant_layer(c[li], s[li], cap).transpose(-1, -2)
                    .to(torch.bfloat16).contiguous() for c, s in ((caches[0], caches[2]),
                                                                  (caches[1], caches[3]))]
        lib_ops = [(q, *dense(li), mask[:, None, None, :]) for li in range(2)]
        t["library_ms"] = time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=m_), lib_ops)
        nbytes = (2 * B * H * D // 2 * cap + 2 * 2 * B * H * cap + B * cap + 2 * B * H * D
                  + 4 * B * H * (D + 2))
        t["bound_ms"], row["bound_by"] = bound(nbytes, 4 * B * H * cap * D)
        phase("kernels", f"decode_attention_int4 B={B} H={H} D={D} cap={cap}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"on the dequantized bf16 layer {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB); "
              f"{nbytes / t['ms'] / 1e6:.1f} GB/s")
        row["per_launch"] = t
        del ops, lib_ops
    row["max_abs_err"] = max_abs
    return row


def check_cache_write(dev, g) -> dict:
    """cache_write_int4 against its plain version byte for byte at the
    batched path's shapes (every slot written, a frozen one too); times."""
    from moshi_tpu_torch.ops.int4_attention import (cache_write_int4 as k5,
                                                    cache_write_int4_plain as k5p)

    L, B, H, D, cap = KV["layers"], SLOTS, KV["heads"], KV["head_dim"], KV["cap"]
    cap_pad = -(-cap // 128) * 128
    caches = random_int4_cache(g, L, B, H, D, cap_pad, dev)
    cols = [torch.randint(-128, 128, (L, B, H * D // 2), device=dev, generator=g,
                          dtype=torch.int8) for _ in range(2)]
    scols = [torch.randn(L, B, H, device=dev, generator=g).to(torch.bfloat16)
             for _ in range(2)]
    pos = torch.randint(0, cap, (B,), device=dev, generator=g)
    ref = k5p(pos, *cols, *scols, *(c.clone() for c in caches))
    got = k5(pos, *cols, *scols, *caches)
    torch.cuda.synchronize()
    ok = all(torch.equal(a, b) for a, b in zip(got, ref))
    phase("kernels", f"cache_write_int4 L={L} B={B} H={H} D={D} cap_pad={cap_pad}: "
          f"{'byte-equal to the plain version' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("cache_write_int4 disagrees with its plain version")
    del ref
    ops = [(pos, *cols, *scols, *caches)]
    li = torch.arange(L, device=dev)[:, None, None]
    bi = torch.arange(B, device=dev)[None, :, None]
    pi = pos[None, :, None]

    def index_put(pos_, kc, vc, ksc, vsc, k_all, v_all, ks_all, vs_all):
        for col, cache in ((kc, k_all), (vc, v_all), (ksc, ks_all), (vsc, vs_all)):
            ri = torch.arange(col.shape[-1], device=dev)[None, None, :]
            cache.index_put_((li, bi, ri, pi), col)
    t = {"ms": time_ms(k5, ops), "plain_ms": time_ms(k5p, ops),
         "library_ms": time_ms(index_put, ops)}
    nbytes = 2 * (2 * L * B * H * D // 2 + 2 * 2 * L * B * H) + 8 * B
    t["bound_ms"], bound_by = bound(nbytes, 0)
    phase("kernels", f"cache_write_int4: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms,"
          f" index_put_ on each of the 4 caches {t['library_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB read + written)")
    return {"per_launch": t, "bound_by": bound_by, "max_abs_err": 0.0}


def random_int8_cache(g, L, B, cap, Hkv, D, dev):
    """int8 ring caches [L, B, cap, Hkv, D] and positive bf16 row scales."""
    def vals():
        return torch.randint(-127, 128, (L, B, cap, Hkv, D), device=dev, generator=g,
                             dtype=torch.int8)

    def scales():
        return (0.001 + 0.02 * torch.rand(L, B, cap, Hkv, 1, device=dev, generator=g)
                ).to(torch.bfloat16)
    return vals(), vals(), scales(), scales()


def check_attention_int8(dev, g) -> dict:
    """decode_attention_int8 against its plain version at both main-path
    shapes (INT8_KV), D = 128 and 64, layer 3 of 4, a ragged mask and slot 0
    with every position masked (which must give 0); times per launch at
    D = 128 beside scaled_dot_product_attention on the dequantized bf16
    layer and the bound."""
    from moshi_tpu_torch.ops.decode_attention import (decode_attention_int8 as k6,
                                                      decode_attention_int8_plain as k6p)
    import torch.nn.functional as F

    L, layer = 4, 3
    max_abs, per_launch, bound_by = 0.0, {}, None
    for path, (B, H, cap) in INT8_KV.items():
        for D in (128, 64):
            caches = random_int8_cache(g, L, B, cap, H, D, dev)
            q = torch.randn(B, H, D, device=dev, generator=g).to(torch.bfloat16)
            valid = torch.randint(1, cap + 1, (B,), device=dev, generator=g)
            mask = ((torch.rand(B, cap, device=dev, generator=g) < 0.9)
                    & (torch.arange(cap, device=dev)[None] < valid[:, None]))
            mask[:, 0] = True
            mask[0] = False
            out = k6(q, layer, *caches, mask)
            torch.cuda.synchronize()
            ref = k6p(q, layer, *caches, mask)
            err = rel_err(out[1:], ref[1:])
            max_abs = max(max_abs, (out.float() - ref.float()).abs().max().item())
            ok = (err <= ATTN_BOUND and bool(torch.isfinite(out).all())
                  and bool((out[0] == 0).all()))
            phase("kernels", f"decode_attention_int8 B={B} H={H} D={D} cap={cap} "
                  f"layer={layer}: max rel err {err:.3e} (bound {ATTN_BOUND:.0e}), fully "
                  f"masked slot {'0' if (out[0] == 0).all() else 'NOT 0'} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("decode_attention_int8 disagrees with its plain version")
            if D != 128:
                continue
            ops = [(q, li, *caches, mask) for li in range(L)]
            t = {"ms": time_ms(k6, ops), "plain_ms": time_ms(k6p, ops, iters=4)}

            def dense(li):
                return [(c[li].float() * s[li].float()).to(torch.bfloat16).transpose(1, 2)
                        .contiguous() for c, s in ((caches[0], caches[2]),
                                                   (caches[1], caches[3]))]
            lib_ops = [(q[:, :, None], *dense(li), mask[:, None, None, :]) for li in range(2)]
            t["library_ms"] = time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=m_), lib_ops)
            nbytes = 2 * B * cap * H * D + 2 * 2 * B * cap * H + B * cap + 2 * 2 * B * H * D
            t["bound_ms"], bound_by = bound(nbytes, 4 * B * H * cap * D)
            phase("kernels", f"decode_attention_int8 {path} B={B} H={H} D={D} cap={cap}: "
                  f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"scaled_dot_product_attention on the dequantized bf16 layer "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB); {nbytes / t['ms'] / 1e6:.1f} GB/s")
            per_launch[path] = t
            del ops, lib_ops
        del caches
        torch.cuda.empty_cache()
    return {"per_launch": per_launch["asr"], "per_launch_by_shape": per_launch,
            "bound_by": bound_by, "max_abs_err": max_abs}


# ------------------------------------------------------------------ slice
def per_step_launches(cfg, params, batch: int) -> dict:
    """Kernel launches one LMGen.step of `batch` slots implies: each q4
    temporal linear once per layer plus the text head, each on the kernel
    that q4matmul.use_mma picks for bf16 x of `batch` rows; each int8
    depformer linear once per layer and codebook, plus depformer_in and the
    output head per codebook, each on the kernel that qmatmul.use_mma
    picks; with the int4 KV cache, one
    decode_attention_int4 per layer and one cache_write_int4; with the int8
    KV cache, one decode_attention_int8 per layer."""
    from moshi_tpu_torch.ops import q4matmul, qmatmul
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
    per_step = dict.fromkeys(("q4_gemv", "q4_mma", "int8_gemv", "int8_mma"), 0)
    for w, n in [(w, cfg.num_layers) for w in temporal] + [(params["text_linear"]["weight"], 1)]:
        dout = w.q.shape[-1]
        gs = 2 * w.q.shape[-2] // w.scale.shape[-3]
        per_step["q4_mma" if q4matmul.use_mma(batch, torch.bfloat16, gs, dout)
                 else "q4_gemv"] += n
    for w, n in ([(w, cfg.depformer_num_layers * cfg.dep_q) for w in dep]
                 + [(params["depformer_in"]["weight"], cfg.dep_q),
                    (params["linears"]["weight"], cfg.dep_q)]):
        din, dout = w.q.shape[-2:]
        per_step["int8_mma" if qmatmul.use_mma(batch, torch.bfloat16, din, dout)
                 else "int8_gemv"] += n
    if (per_step["q4_gemv"] + per_step["q4_mma"] != sum(Q4_SHAPES.values())
            or per_step["int8_gemv"] + per_step["int8_mma"] != sum(INT8_SHAPES.values())):
        raise RuntimeError(f"launches per step {per_step} do not match the shape tables")
    int4 = cfg.kv_cache_dtype == "int4"
    per_step["decode_attention_int4"] = cfg.num_layers if int4 else 0
    per_step["cache_write_int4"] = 1 if int4 else 0
    per_step["decode_attention_int8"] = cfg.num_layers if cfg.kv_cache_dtype == "int8" else 0
    return per_step


def counters() -> dict:
    """The launch-counted wrappers, by kernel name."""
    from moshi_tpu_torch.ops.decode_attention import decode_attention_int8
    from moshi_tpu_torch.ops.int4_attention import cache_write_int4, decode_attention_int4_stats
    from moshi_tpu_torch.ops.q4matmul import q4_gemv, q4_mma
    from moshi_tpu_torch.ops.qmatmul import int8_gemv, int8_mma
    return {"q4_gemv": q4_gemv, "q4_mma": q4_mma, "int8_gemv": int8_gemv,
            "int8_mma": int8_mma,
            "decode_attention_int4": decode_attention_int4_stats,
            "cache_write_int4": cache_write_int4,
            "decode_attention_int8": decode_attention_int8}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters().items()}


def check_counts(launches: dict, expected: dict, steps: int, what: str) -> None:
    for name, n in launches.items():
        if n != expected[name] * steps:
            raise RuntimeError(f"{what}: {name} launched {n} times, expected "
                               f"{expected[name]} x {steps}")


def check_tokens(tokens, cfg, what: str) -> None:
    if not ((tokens[:, 0] >= 0).all() and (tokens[:, 0] < cfg.text_card).all()
            and (tokens[:, 1:] >= 0).all() and (tokens[:, 1:] < cfg.card).all()):
        raise RuntimeError(f"{what}: token out of range")


def check_pcm(audio, frame_size, what: str) -> None:
    if not all(p.shape == (frame_size,) and np.isfinite(p).all() for p in audio):
        raise RuntimeError(f"{what}: PCM frames of the wrong size or not finite")


def build_models(dev):
    from moshi_tpu_torch.models.lm import LMModel, lm_config_v0_1
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config
    from moshi_tpu_torch.utils.quantize import quantize_lm_params

    t0 = time.perf_counter()
    cfg = lm_config_v0_1()
    lm = LMModel(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED)
    lm_params = quantize_lm_params(lm.init_params(g, torch.bfloat16, dev), mode="int4")
    torch.cuda.empty_cache()
    mimi = MimiModel(mimi_v0_1_config(cfg.dep_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    torch.cuda.synchronize()
    phase("slice", f"Moshi-7B q4 + Mimi bf16 built from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB on the card")
    return lm, lm_params, mimi, mimi_params


def run_slice(dev, card: str, lm, lm_params, mimi, mimi_params) -> tuple[dict, float]:
    from moshi_tpu_torch.serve.server import ServerState, serve_sessions

    cfg = lm.config
    expected = per_step_launches(cfg, lm_params, 1)
    if expected["q4_mma"]:
        raise RuntimeError(f"the B = 1 frame would run q4_mma: {expected}")
    state = ServerState(mimi, mimi_params, lm, lm_params, device=dev)
    state.warmup()
    torch.cuda.synchronize()

    zero_counts()
    results = serve_sessions(state, SESSIONS, FRAMES)
    launches = read_counts()

    steps = len(SESSIONS) * FRAMES
    check_counts(launches, expected, steps, "slice")
    for i, (tokens, audio, _) in enumerate(results):
        if len(tokens) != FRAMES - cfg.max_delay:
            raise RuntimeError(f"session {i}: {len(tokens)} frames generated")
        check_pcm(audio, mimi.frame_size, f"session {i}")
        check_tokens(tokens, cfg, f"session {i}")
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


# ---------------------------------------------------------------- batched
def isolation_script(frame_size: int, slots: int = SLOTS):
    """The greedy run's schedule and PCM: (schedule, frames, the slots whose
    session must equal slot 0's)."""
    # unit-RMS noise: the random-weight Mimi maps quiet noise to one code
    # whatever the PCM, and then every slot's stream would be the same
    rs = np.random.RandomState(SEED)
    ref = rs.randn(FRAMES + 1, frame_size).astype(np.float32)
    frames = {s: rs.randn(FRAMES + 1, frame_size).astype(np.float32) for s in range(slots)}
    frames[1] = frames[2] = frames[3] = ref
    frames[0] = ref
    frames[4] = np.concatenate([frames[4][:20], ref])
    schedule = [dict.fromkeys(range(slots), "join")]
    del schedule[0][2]
    for tick in range(1, FRAMES + 1):
        t = dict.fromkeys(range(slots), "send")
        if tick < 5:
            del t[2]               # slot 2 joins 5 frames late
        elif tick == 5:
            t[2] = "join"
        if 10 <= tick <= 14:
            del t[3]               # slot 3 frozen on frames 10-14
        if tick == 20:
            t[4] = "join"          # slot 4: reset, then slot 0's PCM again
        schedule.append(t)
    # slot -> (its session index, frames it executes in that session)
    same_as_0 = {1: (0, FRAMES), 2: (0, FRAMES - 5), 3: (0, FRAMES - 5), 4: (1, FRAMES - 20)}
    return schedule, frames, same_as_0


def profile_frames(run_frame, n: int) -> dict:
    """torch.profiler over n frames, run_frame(i) running frame i and
    reading its result back: the card's busy ms per frame (sum of its
    kernels' times), the host ms per frame under the profiler, and kernel ms
    per frame by name for the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run_frame(i)
        wall = (time.perf_counter() - t0) * 1e3 / n
    busy, by_kernel, device_ops, kernels = 0.0, {}, {}, 0
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue  # host ops; their kernels are counted as device events
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        busy += us
        kernels += evt.count
        device_ops[evt.key[:80]] = us / 1e3 / n
        for name in TPU_KERNELS:
            if name in evt.key and "reduce" not in evt.key:
                by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3 / n
    top = dict(sorted(device_ops.items(), key=lambda kv: -kv[1])[:8])
    return {"host_ms_per_frame": wall, "busy_ms_per_frame": busy / 1e3 / n,
            "kernel_ms_per_frame": by_kernel, "device_ops_per_frame": kernels / n,
            "top_device_ms_per_frame": top}


def greedy_isolation(dev, lm, lm_params, mimi, mimi_params, what: str) -> dict:
    """The greedy run of BatchedMoshiState at B = SLOTS over the isolation
    script: token checks, exact launch counts per frame.  Returns the
    launches."""
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState, serve_batched

    cfg = lm.config
    expected = per_step_launches(cfg, lm_params, SLOTS)
    state = BatchedMoshiState(mimi, mimi_params, lm, lm_params, SLOTS, device=dev,
                              use_sampling=False)
    kshape = tuple(state.gen_state["transformer"]["k"].shape)
    phase("batched", f"{what}: B = {SLOTS}, {cfg.kv_cache_dtype} KV cache {kshape} int8 x 2 "
          f"+ bf16 scales; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card")
    state.warmup()
    schedule, frames, same_as_0 = isolation_script(mimi.frame_size)
    zero_counts()
    sessions, ms = serve_batched(state, schedule, frames)
    launches = read_counts()
    check_counts(launches, expected, len(ms), f"batched {what} run")
    ref = sessions[0][0][0]
    if len(ms) != FRAMES or len(ref) != FRAMES - cfg.max_delay:
        raise RuntimeError(f"{what}: {len(ms)} frames, slot 0 generated {len(ref)}")
    for s in range(SLOTS):
        for tokens, audio in sessions[s]:
            check_tokens(tokens, cfg, f"{what} slot {s}")
            check_pcm(audio, mimi.frame_size, f"{what} slot {s}")
    for s, (session, executed) in same_as_0.items():
        got = sessions[s][session][0]
        if len(got) != executed - cfg.max_delay or not np.array_equal(got, ref[:len(got)]):
            raise RuntimeError(f"{what}: slot {s} session {session} does not repeat "
                               f"slot 0's tokens")
    distinct = sum(not np.array_equal(sessions[s][0][0], ref) for s in range(5, SLOTS))
    if distinct == 0:
        raise RuntimeError(f"{what}: no slot with its own PCM differs from slot 0")
    phase("batched", f"{what}, {len(ms)} frames: slots 1 (same PCM), 2 (joined 5 frames "
          f"late), 3 (frozen on frames 10-14) and 4 (reset at frame 20) repeat slot 0's "
          f"tokens; {distinct} of {SLOTS - 5} other slots differ; launches "
          f"{launches} = per frame {expected} x {len(ms)}")
    del state, sessions
    torch.cuda.empty_cache()
    return launches


def run_batched(dev, card: str, lm_params, mimi, mimi_params) -> dict:
    """The batched path at B = SLOTS with the int4 KV cache, then its greedy
    run with the int8 KV cache."""
    from dataclasses import replace

    from moshi_tpu_torch.models.lm import LMModel, lm_config_v0_1
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState, serve_batched

    cfg = replace(lm_config_v0_1(), kv_cache_dtype="int4")
    lm = LMModel(cfg)
    expected = per_step_launches(cfg, lm_params, SLOTS)
    if expected["q4_gemv"] or expected["int8_gemv"]:
        raise RuntimeError(f"the B = {SLOTS} frame would run a CUDA-core GEMV kernel: {expected}")

    # 1. greedy isolation run
    greedy_launches = greedy_isolation(dev, lm, lm_params, mimi, mimi_params, "greedy")

    # 2. sampled run, every slot active
    state = BatchedMoshiState(mimi, mimi_params, lm, lm_params, SLOTS, device=dev,
                              rng_seed=SEED, use_sampling=True)
    state.warmup()
    rs = np.random.RandomState(SEED + 2)
    frames = {s: (0.1 * rs.randn(FRAMES + 1, mimi.frame_size)).astype(np.float32)
              for s in range(SLOTS)}
    schedule = ([dict.fromkeys(range(SLOTS), "join")]
                + [dict.fromkeys(range(SLOTS), "send")] * FRAMES)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    sessions, ms = serve_batched(state, schedule, frames)
    sampled_launches = read_counts()
    check_counts(sampled_launches, expected, len(ms), "batched sampled run")
    for s in range(SLOTS):
        tokens, audio = sessions[s][0]
        if len(tokens) != FRAMES - cfg.max_delay:
            raise RuntimeError(f"sampled slot {s}: {len(tokens)} frames generated")
        check_tokens(tokens, cfg, f"sampled slot {s}")
        check_pcm(audio, mimi.frame_size, f"sampled slot {s}")
    p50, p75, p90 = (float(np.percentile(ms, p)) for p in (50, 75, 90))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    phase("batched", f"sampled, {len(ms)} frames x {SLOTS} slots: p50 {p50:.2f} ms, p75 "
          f"{p75:.2f} ms, p90 {p90:.2f} ms per batched frame; {p50 / SLOTS:.2f} ms per "
          f"user-frame at p50; "
          f"peak {peak:.2f} GiB; launches {sampled_launches} = per frame {expected} x "
          f"{len(ms)} ({card})")
    pcm = (0.1 * np.random.RandomState(SEED + 1).randn(5, SLOTS, 1, mimi.frame_size)
           ).astype(np.float32)

    def run_frame(i):
        out, audio = state.frame(pcm[i], np.ones(SLOTS, bool))
        out.cpu(), audio.cpu()
    prof = profile_frames(run_frame, len(pcm))
    # the profiler slows the host, so the idle share is taken against the
    # frame time measured without it
    prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / p50
    phase("batched", f"profiler over 5 sampled frames: card busy "
          f"{prof['busy_ms_per_frame']:.2f} ms/frame, idle share {prof['idle_share']:.3f} "
          f"of the p50 frame (host {prof['host_ms_per_frame']:.2f} ms/frame under the "
          f"profiler); kernels ms/frame {json.dumps(prof['kernel_ms_per_frame'])}; "
          f"{prof['device_ops_per_frame']:.0f} device ops/frame, the most costly "
          f"{json.dumps(prof['top_device_ms_per_frame'])}")
    del state
    torch.cuda.empty_cache()

    # 3. the greedy run with the int8 KV cache (the worker's kv_cache = "int8")
    lm8 = LMModel(replace(cfg, kv_cache_dtype="int8"))
    int8_launches = greedy_isolation(dev, lm8, lm_params, mimi, mimi_params, "int8 greedy")
    return {"launches": {"greedy": greedy_launches, "sampled": sampled_launches,
                         "int8_greedy": int8_launches},
            "per_frame": {"int4": expected,
                          "int8": per_step_launches(lm8.config, lm_params, SLOTS)},
            "p50_ms": p50, "p75_ms": p75, "p90_ms": p90, "frames": len(ms), "peak_gib": peak,
            "profile": prof}


# -------------------------------------------------------------------- asr
def build_asr(dev):
    """asr_300m_202501 at full width with the int8 KV cache and bf16
    weights (the text head's pad columns scaled by ASR_PAD_LOGIT_SCALE), the
    bf16 Mimi v0.1 with 32 codebooks and the `delay` condition, all from a
    seed; the StreamingASR engine at B = ASR_SLOTS."""
    from dataclasses import replace

    from moshi_tpu_torch.conditioners import ConditionProvider, ContinuousAttributeConditioner
    from moshi_tpu_torch.models.asr import StreamingASR, asr_sum_condition
    from moshi_tpu_torch.models.lm import LMModel, lm_config_asr_300m_202501
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config

    t0 = time.perf_counter()
    cfg = replace(lm_config_asr_300m_202501(), kv_cache_dtype="int8")
    lm = LMModel(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    lm_params = lm.init_params(g, torch.bfloat16, dev)
    for token, factor in ASR_PAD_LOGIT_SCALE.items():
        lm_params["text_linear"]["weight"][:, token] *= factor
    mimi = MimiModel(mimi_v0_1_config(cfg.n_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    provider = ConditionProvider({"delay": ContinuousAttributeConditioner(
        output_dim=cfg.dim, dim=ASR_COND["dim"], scale_factor=ASR_COND["scale_factor"],
        max_period=ASR_COND["max_period"])})
    cond = asr_sum_condition(provider, provider.init_params(g, torch.float32, dev), cfg.dim,
                             conditioning_delay=ASR_COND["delay"])
    asr = StreamingASR(mimi, lm, ASR_SLOTS, asr_delay_in_tokens=ASR_DELAY, temperature=0.0,
                       mimi_dtype=torch.bfloat16, sum_condition=cond, device=dev)
    torch.cuda.synchronize()
    phase("asr", f"asr_300m_202501 bf16 (dim {cfg.dim}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads x {cfg.transformer_config.head_dim}, n_q {cfg.n_q}, ctx "
          f"{cfg.context}) + Mimi bf16 with {mimi.num_codebooks} codebooks built from seed "
          f"{SEED + 3} in {time.perf_counter() - t0:.1f} s")
    return asr, lm_params, mimi_params


def run_asr(dev, card: str) -> dict:
    """The batched STT path at B = ASR_SLOTS over the isolation script."""
    from moshi_tpu_torch.serve.batched_asr import BatchedAsrState, serve_asr

    asr, lm_params, mimi_params = build_asr(dev)
    cfg, B, fs = asr.lm.config, ASR_SLOTS, asr.mimi.frame_size
    state = BatchedAsrState(asr, mimi_params, lm_params)
    kv = state.state["transformer"]
    phase("asr", f"B = {B}, int8 KV cache {tuple(kv['k'].shape)} x 2 + bf16 scales "
          f"{tuple(kv['k_scale'].shape)}; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          f"on the card")
    # warm-up: three zero frames on every slot, then every session closed
    for s in range(B):
        state.acquire_slot(s)
        state.feed_pcm(s, np.zeros(3 * fs, np.float32))
    for _ in range(3):
        state.tick()
    for s in range(B):
        state.release_slot(s)
    torch.cuda.synchronize()

    # greedy isolation run: the batched phase's script, one frame per tick
    schedule, frames, same_as_0 = isolation_script(fs, B)
    expected = {name: 0 for name in TPU_KERNELS}
    expected["decode_attention_int8"] = cfg.num_layers
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    sessions, ms = serve_asr(state, schedule[:FRAMES], frames)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_counts(launches, expected, len(ms), "asr greedy run")
    ref = sessions[0][0][0]
    if len(ms) != FRAMES or len(ref) != FRAMES:
        raise RuntimeError(f"asr: {len(ms)} frames, slot 0 has {len(ref)} tokens")
    said = {"Word": 0, "EndWord": 0}
    for s in range(B):
        for tokens, msgs in sessions[s]:
            if not ((tokens >= 0).all() and (tokens < cfg.text_card).all()):
                raise RuntimeError(f"asr slot {s}: text token out of range")
            for m in msgs:
                said[m["type"]] = said.get(m["type"], 0) + 1
    if not (said["Word"] and said["EndWord"]):
        raise RuntimeError(f"asr: no Word or no EndWord message came out: {said}")

    def words(msgs):
        return [m for m in msgs if m["type"] in ("Word", "EndWord")]
    ref_words = words(sessions[0][0][1])
    if not ref_words:
        raise RuntimeError("asr: slot 0 said no word, so its copies have nothing to repeat")
    for s, (session, executed) in same_as_0.items():
        got = sessions[s][session][0]
        if len(got) != executed or not np.array_equal(got, ref[:len(got)]):
            raise RuntimeError(f"asr: slot {s} session {session} does not repeat slot 0's "
                               f"text tokens")
        # a slot that executed fewer frames said what slot 0 said in them
        got_words = words(sessions[s][session][1])
        if got_words != ref_words[:len(got_words)] or (s == 1 and got_words != ref_words):
            raise RuntimeError(f"asr: slot {s} session {session} does not repeat slot 0's "
                               f"Word / EndWord messages")
    distinct = sum(not np.array_equal(sessions[s][0][0], ref) for s in range(5, B))
    if distinct == 0:
        raise RuntimeError("asr: no slot with its own PCM differs from slot 0")
    p50, p75, p90 = (float(np.percentile(ms, p)) for p in (50, 75, 90))
    phase("asr", f"greedy, {len(ms)} frames x {B} slots: slots 1 (same PCM), 2 (joined 5 "
          f"frames late), 3 (frozen on frames 10-14) and 4 (reset at frame 20) repeat slot "
          f"0's text tokens and its {len(ref_words)} Word / EndWord messages; {distinct} of "
          f"{B - 5} other slots differ; messages by type {said}; launches {launches} = per "
          f"frame {expected} x {len(ms)}")
    phase("asr", f"p50 {p50:.2f} ms, p75 {p75:.2f} ms, p90 {p90:.2f} ms per batched frame; "
          f"{p50 / B:.3f} ms per user-frame at p50; peak {peak:.2f} GiB ({card})")

    # every slot sends every frame: the word trackers' host ms, then the profiler
    rs = np.random.RandomState(SEED + 4)
    pcm = rs.randn(15, B, fs).astype(np.float32)
    host, full = [], []

    def run_frame(i):
        for s in range(B):
            state.feed_pcm(s, pcm[i, s])
        state.tick()
    for i in range(10):
        run_frame(i)
        host.append(asr.host_ms)
        full.append(state.frame_ms)
    full_p50 = float(np.percentile(full, 50))
    prof = profile_frames(lambda i: run_frame(10 + i), 5)
    # against the p50 of the same kind of frame (every slot sending), taken
    # without the profiler
    prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / full_p50
    phase("asr", f"all {B} slots, 10 frames: p50 {full_p50:.2f} ms per "
          f"batched frame, of it {np.percentile(host, 50):.2f} ms of host Python in the "
          f"per-slot input and word-tracker loops; profiler over 5 frames: card busy "
          f"{prof['busy_ms_per_frame']:.2f} ms/frame, idle share {prof['idle_share']:.3f} of "
          f"the p50 frame (host {prof['host_ms_per_frame']:.2f} ms/frame under the "
          f"profiler); kernels ms/frame {json.dumps(prof['kernel_ms_per_frame'])}; "
          f"{prof['device_ops_per_frame']:.0f} device ops/frame, the most costly "
          f"{json.dumps(prof['top_device_ms_per_frame'])}")
    del state, asr, lm_params, mimi_params
    torch.cuda.empty_cache()
    return {"launches": launches, "per_frame": expected, "p50_ms": p50, "p75_ms": p75,
            "p90_ms": p90, "frames": len(ms), "peak_gib": peak,
            "all_slots_p50_ms": full_p50,
            "host_ms_p50": float(np.percentile(host, 50)), "profile": prof}


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
    logs = build.build_all(extra_flags=("-Xptxas", "-v"))
    for name in build.SIGNATURES:
        build.load(name)
    phase("build", f"{', '.join(build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc in parallel: {build.build_seconds or 'libraries already built'}) -> "
          f"{build.BUILD_DIR}")
    for name, log in logs.items():
        regs, spills = ptxas_summary(log)
        phase("build", f"{name}: max {regs} registers, {spills} bytes of spill stores")
        if name in ("q4_mma", "int8_mma") and spills:
            raise RuntimeError(f"{name} spills registers")

    g = torch.Generator(device=dev).manual_seed(SEED)
    gemvs = check_gemvs(dev, g)
    attn = check_attention(dev, g)
    write = check_cache_write(dev, g)
    attn8 = check_attention_int8(dev, g)
    torch.cuda.empty_cache()

    lm, lm_params, mimi, mimi_params = build_models(dev)
    slice_launches, p50 = run_slice(dev, card, lm, lm_params, mimi, mimi_params)
    torch.cuda.empty_cache()
    batched = run_batched(dev, card, lm_params, mimi, mimi_params)
    del lm, lm_params, mimi, mimi_params
    torch.cuda.empty_cache()
    asr = run_asr(dev, card)

    by_path = {"slice_b1": slice_launches,
               **{f"batched_{p}": v for p, v in batched["launches"].items()},
               "asr": asr["launches"]}
    per_frame_by_path = {"batched": batched["per_frame"]["int4"],
                         "batched_int8": batched["per_frame"]["int8"], "asr": asr["per_frame"]}
    kernels = []
    # ms / plain_ms / library_ms / bound_ms: card time of one frame's
    # launches of the kernel (bf16, operands cold in L2) on the path it
    # runs, from the per-shape (GEMVs) or per-launch times: the B = 1 frame
    # for the q4_gemv kernel, a B = 16 batched frame for q4_mma, int8_gemv,
    # decode_attention_int4 and cache_write_int4, a B = 256 ASR frame for
    # decode_attention_int8; "per_frame_by_batch" has the GEMVs' frames at
    # each batch timed (the int8_gemv kernel runs no launch of either path:
    # its row is its B = 16 frame, beside int8_mma's)
    for k in gemvs:
        main_b = 1 if k["name"] == "q4_gemv" else SLOTS
        kernels.append({**k["per_frame"][main_b], "per_frame_by_batch": k["per_frame"],
                        **{key: v for key, v in k.items() if key != "per_frame"}})
    for name, k, path in (("decode_attention_int4", attn, "batched"),
                          ("cache_write_int4", write, "batched"),
                          ("decode_attention_int8", attn8, "asr")):
        n = per_frame_by_path[path][name]
        kernels.append({"name": name, **{key: v * n for key, v in k["per_launch"].items()},
                        **k})
    for k in kernels:
        name = k["name"]
        k.update({"route": "cuda", "source": SOURCES[name], "replaces": TPU_KERNELS[name],
                  "launches": sum(v[name] for v in by_path.values()),
                  "launches_by_path": {p: v[name] for p, v in by_path.items()},
                  "launches_per_frame": {p: v[name] for p, v in per_frame_by_path.items()}})
    print(json.dumps({"kernels": kernels, "frame_p50_ms": p50,
                      "batched": {key: batched[key] for key in ("p50_ms", "p75_ms", "p90_ms",
                                                                "frames", "peak_gib",
                                                                "profile")},
                      "asr": {key: v for key, v in asr.items()
                              if key not in ("launches", "per_frame")}}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
