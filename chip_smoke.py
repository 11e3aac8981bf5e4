"""Smoke run of the PyTorch/CUDA port (moshi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. device  - the card's name and `nvidia-smi` name/power limit; fails at
               once when torch sees no CUDA device;
  2. build   - nvcc builds every kernel from moshi_tpu_torch/csrc/ into
               build/kernels/, one nvcc per source, all at once (skipped
               when a library of the same sources is already there), and
               prints each library's registers and spills (-Xptxas -v; a
               spill fails the run);
  3. kernels - each kernel against its plain PyTorch version on the card at
               the main paths' shapes: the q4_gemv and int8_gemv kernels at
               B = 1, 4, 9, 16 in bf16 and f32 (their timed lines name the
               launch plan: columns a lane, warps, cluster, rows a block),
               q4_mma at B = 2, 4, 9, 16
               and int8_mma at B = 1, 2, 4, 9, 16 in bf16,
               decode_attention_int4 at B = 16, H = 32, D = 128 and
               64 with its plan (warps, blocks per SM), a ragged mask and
               one with a slot of positions 0..99 only and a fully masked
               slot, timed at both head dims; decode_attention_int4_write
               (the same launch also writing the layer's new column, which
               replaces cache_write_int4) at L = 32, B = 16, D = 128 and
               64 over two frames of the ring (lanes 0, 63, 64, cap - 1, a
               frozen slot, a fully masked one), every cache byte against
               the plain write, deterministic, timed beside the attention
               alone,
               decode_attention_int8 at the ASR path's B = 256, H = 8, cap
               750 and Moshi's B = 16, H = 32, cap 3000, D = 128 and 64, a
               ragged mask and a slot with every position masked (at
               Moshi's shape also a mask of positions 0..99 only), with
               its plan (splits, cluster, warps, blocks per SM); then
               CUDA-graph-replay times (operands cold in L2) of each kernel,
               its plain version and one PyTorch library call for the same
               work, beside the least time the card could take (bound); the
               two q4 kernels and the two int8 kernels at B = 1, 2, 4, 8, 16
               (their crossovers); one launch's floor (int8_mma and
               torch.matmul at 16 x 64, beside a one-element add_); at the
               tts path's shapes (B = 16): every int8 linear of the frame on
               the kernel its route takes (int8_mma, or int8_gemv for the
               heads of 32001 and 2049 columns), the fused
               decode_attention_int4 launch at L = 48, H = 32, D = 64, cap
               1000 with its plan, and decode_attention_int8 at H = 32,
               cap 1000, D = 64, each checked and timed as above; q4_wgmma
               above a decoding batch, at M = 32, 64 and 256 rows at the
               five q4 shapes (checked, timed beside the plain version,
               torch.matmul on the bf16 weight and the bound, with TFLOP/s,
               summed over one offline forward's 129 launches; M = 16 too,
               beside q4_mma, for the crossover only), and the f32 route
               (the q4_gemv kernel in 16-row chunks) at M = 40;
  4. slice   - Moshi-7B shapes with q4 temporal weights and an int8
               depformer, bf16 KV cache, bf16 Mimi, all initialised from a
               seed on the card; the graphed ServerState: warm-up, then 3
               sessions of 40 frames of seeded PCM with sampling on
               (sessions 1 and 3 share a seed), each frame replays of the
               three graphs (encode, LMGen.step, decode) captured at its
               first frame.  Checks PCM, token ranges, that sessions 1 and 3
               agree and 1 and 2 do not, that the captured step's kernel
               launches are exactly what the config implies per
               LMGen.step (the q4 linears on the q4_gemv kernel at B = 1,
               the int8 ones on int8_mma) and the replay counts; prints
               p50/p90 ms per frame, a profiler pass over 5 graphed frames
               (card busy ms, idle share, device ops per frame), then one
               session of the eager path (p50/p90, a launch count per
               frame, whether its sampled tokens equal the graphed ones);
  5. batched - the same weights with the int4 KV cache, B = 16 slots of
               BatchedMoshiState, each frame one replay of the graph
               captured at its first frame: a greedy run of 40 frames whose
               slots must agree token for token (two slots with one PCM, a
               slot that joins 5 frames late, one frozen for frames 10-14,
               one reset at frame 20 that replays the PCM from the start),
               run graphed and eagerly, whose tokens, PCM and every state
               byte must be equal; then a sampled run of 40 graphed frames
               on all 16 slots (p50/p75/p90 ms per batched frame, peak
               memory) and 10 eager ones; launch counts of the kernels (the
               q4 linears on q4_mma and the int8 ones on int8_mma at
               B = 16, 32 decode_attention_int4 launches, each writing its
               layer's column) exact per captured frame and per eager
               frame; a torch.profiler pass over 5 graphed frames for the
               card's busy time; then the greedy runs once more with the
               int8 KV cache (32 decode_attention_int8 per frame), 5 frames
               of every slot graphed and eager, and a profiler pass over 5
               graphed ones;
  6. offline - the offline halves on the same weights: Mimi v0.1's encode
               and decode in f32 (the bf16 weights cast up) and in bf16,
               over B = 4 x 50 frames of seeded PCM and one input 1000
               samples longer, against encode_step / decode_step from a
               fresh state (the share of equal codes, the decoded PCM's
               relative error, each held to OFFLINE_BOUNDS; ms and seconds
               of audio per second); then Moshi-7B's LMModel.forward over
               seeded codes [2, 17, 128]: exactly 129 q4_wgmma launches
               of 256 rows and no other GEMV, finite logits and masks equal
               to the plain ones, forward_text's text logits against 128
               forward_text_step over the bf16 ring KV (relative error,
               greedy argmax agreement), p50 of 5 calls, scored frames per
               second and a profiler pass (card busy ms, q4_wgmma's
               share);
  7. asr     - batched speech-to-text at the full width of asr_300m_202501
               (bf16 weights, int8 KV cache, bf16 Mimi with 32 codebooks, a
               `delay` condition), all from a seed, B = 256 slots of
               BatchedAsrState, each frame replays of StreamingASR's two
               graphs (Mimi encode, the temporal step) captured at its
               first frame after the warm-up: the greedy isolation run of
               the batched phase over 40 frames (text tokens and Word /
               EndWord messages; the text head's pad columns are scaled up
               so that words end) with a session resume in it (a session
               leaves at frame 15, a new tenant takes its slot, it resumes
               on another slot and must repeat an unbroken slot's tokens,
               messages and device rows), run graphed and eagerly, whose
               tokens, messages and every state byte must be equal; exactly
               16 decode_attention_int8 and no GEMV launches per captured
               step (and per eager frame), the replay counts; p50 / p75 /
               p90 ms per batched frame; 10 frames of every slot on both
               engines (frame times, the word trackers' host ms, peak
               memory, a profiler pass); then the greedy run eagerly with
               decode_attention_int8_plain in the kernel's place, in which
               slot 0 must say words too; then graphed engines at B = 256,
               512 and 1024, 20 frames of every slot each (p50 / p90, peak
               memory), naming the largest B whose p90 stays under 80 ms;
  8. tts     - batched text-to-speech at the full width of tts_v0_1 (48
               layers of dim 2048, 32 heads x 64, a 16-step depformer;
               int8 weights, int4 KV at context 1000, bf16 Mimi with 16
               codebooks, a seeded speaker_wavs condition over voices of
               125 x 512 fused by cross-attention and a `cfg` LUT condition
               summed in, the JAX benchmark's tokenizer stub and state
               machine): TTSModel.get_prefix on 2 s of seeded PCM, whose
               audio rows must equal that Mimi's offline encode; then B =
               16 slots of BatchedTTSState, each frame
               replays of its two graphs (scatter -> temporal step -> text
               sampling; depformer -> commit -> Mimi decode) with the DSM
               machines on the host between them: a greedy isolation run
               of 44 frames (a voiceless slot alone first, two slots with
               one script and voice, one joining 5 ticks late, one starved
               of words for 5 ticks, one reset to them, one changing its
               voice) whose copies must repeat slot 0's frames and Text
               events, graphed and eager held equal in frames, events, PCM
               and every state byte, with exact launches per captured
               graph (int8_mma, int8_gemv, 48 fused decode_attention_int4,
               no q4) and the replay counts; a sampled run of every slot
               (40 graphed frames, 10 eager: p50/p75/p90, ms per stream,
               the machines' host ms, peak memory, a profiler pass); then
               the greedy run with the int8 KV cache (48
               decode_attention_int8 per frame) and 5 frames of every
               slot.
Then a JSON line of the kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits non-zero and prints no result.
"""

import gc
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
EAGER_FRAMES = 10        # the eager comparison run of [batched]'s sampled run
SLOTS = 16               # B of the batched phase
ASR_SLOTS = 256          # B of the asr phase
ASR_SWEEP = (256, 512, 1024)  # B of the asr phase's batch sweep
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
# the pads win on some frames, words end, and slot 0's session holds Word
# and EndWord messages.  The stream turns on near-ties, so it moves with
# any rounding on the path (the attention's, the int8 KV quantization's):
# of 36 pairs tried, only these gave slot 0 words with the kernel of
# csrc/decode_attention_int8.cu and with its plain version alike once the
# quantization divided on the card as on the CPU (PERF.md), and run_asr
# checks the plain one's.
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
# q4_wgmma above a decoding batch (the offline forward's M = B * T rows):
# checked and timed at these row counts at every Q4_SHAPES shape, whose
# counts are also the launches of one offline forward, and at
# CROSSOVER_ROWS beside q4_mma (the route keeps q4_mma there); the f32
# route (the q4_gemv kernel, one launch per 16 rows) checked at
# F32_ROUTE_ROWS
OFFLINE_ROWS = (32, 64, 256)
CROSSOVER_ROWS = 16
F32_ROUTE_ROWS = 40
# the offline phase: Mimi v0.1 over B = 4 x 50 frames (4 s) of seeded PCM
# plus one input 1000 samples longer (encode pads it to a whole frame), and
# Moshi-7B's teacher-forced forward over seeded codes [2, 17, 128] (256 rows
# for each q4 linear)
OFFLINE_MIMI = {"batch": 4, "frames": 50, "extra": 1000}
OFFLINE_LM = {"batch": 2, "frames": 128}
# offline against streaming (PERF.md §6, stated before the first run): the
# share of equal codes (at least) and max |offline - streaming| / max
# |streaming| of the decoded PCM (at most), by Mimi's dtype; and
# ||offline - streaming|| / ||streaming|| of the LM's bf16 text logits (the
# norm over all 8.2M logits; the max-based error is printed beside it)
OFFLINE_BOUNDS = {"f32": {"share": 0.999, "pcm": 1e-4},
                  "bf16": {"share": 0.5, "pcm": 1e-1}, "lm_text_logits": 2e-2}
TTS_PREFIX_SECONDS = 2   # the PCM of [tts]'s get_prefix call
# the int4 KV cache of the batched phase: Moshi-7B, context 3000
KV = {"layers": 32, "heads": 32, "head_dim": 128, "cap": 3000}
# the tts phase: tts_v0_1 with int8 weights, int4 KV at context 1000, B = 16
TTS_SLOTS = 16
TTS_FRAMES = 44          # the greedy isolation run
TTS_CONTEXT = 1000
TTS_DELAY_STEPS = 25     # the JAX benchmark's machine (moshi_tpu/benchmark.py:352-359)
TTS_TEMP = 0.6
# speaker embeddings: frames x width (no voice file on the card's machine:
# the script's choice), at most TTS_MAX_SPEAKERS of them in a condition
TTS_VOICE = (125, 512)
TTS_MAX_SPEAKERS = 5
# the `cfg` LUT condition of a CFG-distilled checkpoint (the script's choice)
TTS_CFG = {"n_bins": 7, "dim": 16,
           "possible_values": ["1.0", "1.5", "2.0", "2.5", "3.0", "3.5", "4.0"]}
# the TTS frame's int8 linears (din, dout) at B = 16 -> launches per frame:
# 48 temporal layers x (in_proj, out_proj, linear1, linear2, cross q_proj,
# cross out_proj) and the 32001-column text head; 16 depformer steps x 6
# layers x 4 linears, depformer_in and the 2049-entry audio heads per step
TTS_INT8_SHAPES = {(2048, 6144): 48, (2048, 2048): 3 * 48, (2048, 8192): 48,
                   (8192, 2048): 48, (2048, 32001): 1,
                   (1024, 3072): 96, (1024, 1024): 96, (1024, 5632): 96, (2816, 1024): 96,
                   (2048, 1024): 16, (1024, 2049): 16}
# K4 (fused with the write) and K6 at the TTS shapes: L, B, H, D, cap
TTS_KV = {"layers": 48, "batch": TTS_SLOTS, "heads": 32, "head_dim": 64, "cap": TTS_CONTEXT}
# decode_attention_int8's main-path shapes, (B, heads, cap) at head dim 128:
# asr_300m_202501 at B = 256 (16 launches per frame), Moshi-7B at B = 16 (32)
INT8_KV = {"asr": (ASR_SLOTS, 8, 750), "moshi_b16": (SLOTS, 32, 3000),
           "tts": (TTS_SLOTS, TTS_KV["heads"], TTS_CONTEXT)}
TPU_KERNELS = {
    # q4gemm and q4gemm_stacked: q4_gemv on the CUDA cores (B = 1, f32),
    # q4_mma on the tensor cores (bf16, M = MMA_MIN_BATCH..16 rows),
    # q4_wgmma with wgmma (bf16, M > 16 rows)
    "q4_gemv": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    "q4_mma": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    "q4_wgmma": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    # qgemv: int8_gemv on the CUDA cores (f32), int8_mma on the tensor cores
    # (bf16, B = 1..16)
    "int8_gemv": "moshi_tpu/ops/qmatmul.py:48",
    "int8_mma": "moshi_tpu/ops/qmatmul.py:48",
    "decode_attention_int4": "moshi_tpu/ops/int4_attention.py:165",
    "cache_write_int4": "moshi_tpu/ops/int4_attention.py:313",
    "decode_attention_int8": "moshi_tpu/ops/decode_attention.py:90",
}
SOURCES = {name: f"moshi_tpu_torch/csrc/{name}.cu" for name in TPU_KERNELS}
# the cache write runs in decode_attention_int4's launch
SOURCES["cache_write_int4"] = SOURCES["decode_attention_int4"]
# the designs before the write moved into the attention's launch, on the
# H100 (PERF.md §6): the standalone cache_write_int4 kernel per int4 B = 16
# frame, and the attention alone per launch at that frame's shape
EARLIER_MS = {"cache_write_int4 per frame": 0.174, "decode_attention_int4 per launch": 0.0880}
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def free_memory() -> None:
    """Return what dropped engines held to the card before the next phase
    measures memory: the cycle collector for anything still in a
    reference cycle, then the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


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
    CUDA graph after one warm-up call per operand set on the capture's side
    stream (moshi_tpu_torch.utils.graphs); the graph's replays are timed
    with CUDA events, so the host's launch cost is not in the number."""
    from moshi_tpu_torch.utils.graphs import capture, side_stream

    side = torch.cuda.Stream()
    with side_stream(side):
        for ops in operands:
            fn(*ops)
    graph, _ = capture(lambda: [fn(*operands[i % len(operands)]) for i in range(iters)],
                       stream=side)
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


def plan_phrase(name, B, din, q) -> str:
    """The launch plan of the q4_gemv / int8_gemv kernel for x of B rows on
    q (gemv_plan: a lane's columns, warps a block, blocks a cluster), as a
    phrase; "" for another kernel."""
    from moshi_tpu_torch.ops import q4matmul, qmatmul

    if name == "q4_gemv":
        p = q4matmul.q4_gemv_plan(min(B, q4matmul.MAX_BATCH), din, q, 32, True, q.device)
    elif name == "int8_gemv":
        p = qmatmul.int8_gemv_plan(B, din, q, True, q.device)
    else:
        return ""
    return (f" [plan: {p.cols} columns a lane, {p.warps} warps, cluster {p.cluster}, "
            f"{p.rows_per_block} rows a block]")


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
                          f"{bytes_w / t['ms'] / 1e6:.1f} GB/s of packed weight"
                          + plan_phrase(name, B, din, qt.q))
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


def check_tts_gemvs(dev, g) -> dict:
    """The int8 GEMVs at the TTS frame's shapes (TTS_INT8_SHAPES), B =
    TTS_SLOTS: each shape on the kernel its route takes (int8_mma where
    qmatmul.use_mma says so, else the int8_gemv kernel, which the heads of
    32001 and 2049 columns take) against the plain version in bf16 (the
    int8_gemv kernel in f32 too); then in bf16, weights cold in L2, its time
    beside the plain version's, torch.matmul's on the bf16 weights and the
    bound, summed by kernel over one frame's launches.  Returns {kernel:
    its summary}."""
    from moshi_tpu_torch.ops import qmatmul
    from moshi_tpu_torch.utils.quantize import dequantize, quantize_tensor

    B, plain = TTS_SLOTS, qmatmul.int8_gemv_plain
    out = {name: {"per_frame": dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0),
                  "launches_per_frame": 0, "by_shape": {}, "max_abs_err": 0.0, "bound_by": set()}
           for name in ("int8_mma", "int8_gemv")}
    for (din, dout), n in TTS_INT8_SHAPES.items():
        qt = quantize_tensor(torch.randn(din, dout, device=dev, generator=g) / din ** 0.5)
        mma = qmatmul.use_mma(B, torch.bfloat16, din, dout)
        name, fn = ("int8_mma", qmatmul.int8_mma) if mma else ("int8_gemv",
                                                                qmatmul.int8_gemv_kernel)
        row = out[name]
        for dt in (torch.bfloat16,) if mma else (torch.bfloat16, torch.float32):
            x = torch.randn(B, din, device=dev, generator=g).to(dt)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     _check_against_plain(name, fn, plain, qt, x))
        bytes_w = qt.q.numel() + 4 * qt.scale.numel()
        copies = [qt] + [quantize_tensor(dequantize(qt.q, qt.scale, torch.float32))
                         for _ in range(copies_for_cold_l2(bytes_w) - 1)]
        dense = [dequantize(qt.q, qt.scale, torch.bfloat16)
                 for _ in range(copies_for_cold_l2(2 * din * dout))]
        x = torch.randn(B, din, device=dev, generator=g).to(torch.bfloat16)
        ops = [(x, c.q, c.scale) for c in copies]
        t = {"ms": time_ms(fn, ops), "plain_ms": time_ms(plain, ops),
             "library_ms": time_ms(torch.matmul, [(x, d) for d in dense])}
        t["bound_ms"], by = bound(bytes_w + 2 * B * (din + dout), 2 * B * din * dout)
        row["bound_by"].add(by)
        for k, v in t.items():
            row["per_frame"][k] += n * v
        row["launches_per_frame"] += n
        row["by_shape"][f"{din}x{dout} B={B}"] = {**t, "launches_per_frame": n}
        phase("kernels", f"tts {name} {din}x{dout} B={B} bf16 ({n} per frame): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; "
              f"{bytes_w / t['ms'] / 1e6:.1f} GB/s of packed weight"
              + plan_phrase(name, B, din, qt.q))
        del copies, dense
    for name, row in out.items():
        row["bound_by"] = "operations" if row["bound_by"] == {"operations"} else "bytes"
        f = row["per_frame"]
        phase("kernels", f"tts per frame: {name} x {row['launches_per_frame']} at B={B}: "
              f"kernel {f['ms']:.3f} ms, plain {f['plain_ms']:.3f} ms, torch.matmul on bf16 "
              f"{f['library_ms']:.3f} ms, bound {f['bound_ms']:.3f} ms")
    free_memory()
    return out


def check_offline_q4(dev, g) -> dict:
    """q4_wgmma above a decoding batch, at OFFLINE_ROWS rows and every
    Q4_SHAPES shape: against the plain version in bf16, then (operands cold
    in L2) its time beside the plain version's, torch.matmul's on the
    dequantized bf16 weight and the bound, with TFLOP/s, and the sums over
    one offline forward's launches at each row count.  At CROSSOVER_ROWS
    (where the route keeps q4_mma) q4_wgmma and q4_mma are checked and timed
    side by side, for the record.  Then the f32 route (q4_gemv -> the
    q4_gemv kernel, ceil(M / 16) launches) at F32_ROUTE_ROWS rows against
    its plain version."""
    from moshi_tpu_torch.ops import q4matmul
    from moshi_tpu_torch.utils.quantize import dequantize4, quantize_tensor4

    plain = q4matmul.q4_gemv_plain
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    rows = OFFLINE_ROWS + (CROSSOVER_ROWS,)
    per_forward = {M: dict.fromkeys(keys, 0.0) for M in rows}
    crossover_mma_ms = 0.0
    by_shape, max_abs, bound_by = {}, 0.0, {M: set() for M in rows}
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (din, dout), n in Q4_SHAPES.items():
        w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
        qt = quantize_tensor4(w)
        bytes_w = qt.q.numel() + 4 * qt.scale.numel()
        copies = [qt] + [quantize_tensor4(w) for _ in range(copies_for_cold_l2(bytes_w) - 1)]
        del w
        dense = [dequantize4(qt.q, qt.scale, torch.bfloat16)
                 for _ in range(copies_for_cold_l2(2 * din * dout))]
        for M in rows:
            expect = "q4_mma" if M == CROSSOVER_ROWS else "q4_wgmma"
            if q4matmul.route(M, torch.bfloat16, 32, dout) != expect:
                raise RuntimeError(f"q4 {din}x{dout} at M = {M} would not run {expect}")
            x = torch.randn(M, din, device=dev, generator=g).to(torch.bfloat16)
            max_abs = max(max_abs, _check_against_plain("q4_wgmma", q4matmul.q4_wgmma, plain,
                                                        qt, x))
            ops = [(x, c.q, c.scale) for c in copies]
            t = {"ms": time_ms(q4matmul.q4_wgmma, ops), "plain_ms": time_ms(plain, ops),
                 "library_ms": time_ms(torch.matmul, [(x, d) for d in dense])}
            t["bound_ms"], by = bound(bytes_w + 2 * M * (din + dout), 2 * M * din * dout)
            t["bound_by"] = by
            t["tflops"] = 2 * M * din * dout / t["ms"] / 1e9
            bound_by[M].add(by)
            gps, splits = q4matmul.wgmma_plan_splits(din, dout, 32, num_sms, M)
            t["plan"] = {"groups_per_split": gps, "splits": splits}
            extra = ""
            if M == CROSSOVER_ROWS:
                _check_against_plain("q4_mma", q4matmul.q4_mma, plain, qt, x)
                t["q4_mma_ms"] = time_ms(q4matmul.q4_mma, ops)
                crossover_mma_ms += n * t["q4_mma_ms"]
                extra = f", q4_mma {t['q4_mma_ms']:.4f} ms (the route's)"
            by_shape[f"{din}x{dout} M={M}"] = t
            for k in keys:
                per_forward[M][k] += n * t[k]
            phase("kernels", f"q4_wgmma {din}x{dout} M={M} bf16 ({splits} splits): kernel "
                  f"{t['ms']:.4f} ms{extra}, plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by}); "
                  f"{t['tflops']:.1f} TFLOP/s")
        del copies, dense
    for M in rows:
        f = per_forward[M]
        f["bound_by"] = "operations" if bound_by[M] == {"operations"} else "bytes"
        f["tflops"] = 2 * M * sum(n * din * dout for (din, dout), n in Q4_SHAPES.items()) \
            / f["ms"] / 1e9
        what = "q4 offline forward" if M != CROSSOVER_ROWS else "q4 crossover, not a route:"
        extra = f", q4_mma {crossover_mma_ms:.3f} ms" if M == CROSSOVER_ROWS else ""
        phase("kernels", f"{what} ({sum(Q4_SHAPES.values())} launches) M={M}: "
              f"q4_wgmma {f['ms']:.3f} ms ({f['tflops']:.1f} TFLOP/s){extra}, plain "
              f"{f['plain_ms']:.3f} ms, torch.matmul on bf16 {f['library_ms']:.3f} ms, bound "
              f"{f['bound_ms']:.3f} ms ({f['bound_by']})")
    per_forward[CROSSOVER_ROWS]["q4_mma_ms"] = crossover_mma_ms

    M, (din, dout) = F32_ROUTE_ROWS, (4096, 4096)
    qt = quantize_tensor4(torch.randn(din, dout, device=dev, generator=g) / din ** 0.5)
    x = torch.randn(M, din, device=dev, generator=g)
    counted = (q4matmul.q4_gemv, q4matmul.q4_mma, q4matmul.q4_wgmma)
    before = [fn.launches for fn in counted]
    err = _check_against_plain("q4_gemv", q4matmul.q4_gemv, plain, qt, x)
    launched = tuple(fn.launches - b for fn, b in zip(counted, before))
    if launched != (-(-M // q4matmul.MAX_BATCH), 0, 0):
        raise RuntimeError(f"the f32 route at M = {M} launched (q4_gemv, q4_mma, q4_wgmma) "
                           f"{launched}")
    phase("kernels", f"q4 f32 route at M={M}: {launched[0]} q4_gemv kernel launches, "
          f"max |kernel - plain| {err:.3e}")
    free_memory()
    return {"per_forward": {M: per_forward[M] for M in OFFLINE_ROWS},
            "crossover": per_forward[CROSSOVER_ROWS], "by_shape": by_shape,
            "max_abs_err": max_abs, "launches_per_forward": sum(Q4_SHAPES.values()),
            "f32_route": {"rows": M, "shape": f"{din}x{dout}", "q4_gemv_launches": launched[0],
                          "max_abs_err": err}}


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
    D = 128 and 64, cap 3000, layer 5 of 8, with its plan (warps, blocks and
    warps per SM): a ragged mask, then slot 0 with positions 0..99 only and
    slot 1 with every position masked (m must be -1e30 and l = cap); times
    per launch at both head dims beside the plain version,
    scaled_dot_product_attention and the bound (the frame's row: D = 128)."""
    from moshi_tpu_torch.ops import int4_attention as i4
    from moshi_tpu_torch.ops.int4_attention import (decode_attention_int4_stats as k4,
                                                    decode_attention_int4_stats_plain as k4p)

    B, H, cap, L, layer = SLOTS, KV["heads"], KV["cap"], 8, 5
    cap_pad = -(-cap // 128) * 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps = i4.plan_warps(B, H, H, cap, sms)
    blocks = i4.attention_blocks(B, H, H)
    phase("kernels", f"decode_attention_int4 B={B} H={H} cap={cap} plan: {blocks} blocks of "
          f"{warps} warps and up to {i4.HEADS_PER_BLOCK} heads, chunks of {i4.CHUNK} "
          f"positions, {blocks / sms:.2f} blocks ({blocks * warps / sms:.1f} warps) per SM on "
          f"{sms} SMs")
    max_abs, row, per_launch = 0.0, {"plan": {"warps": warps, "blocks": blocks,
                                              "warps_per_sm": blocks * warps / sms}}, {}
    for D in (128, 64):
        caches = random_int4_cache(g, L, B, H, D, cap_pad, dev)
        q = torch.randn(B, H, 1, D, device=dev, generator=g).to(torch.bfloat16)
        valid = torch.randint(1, cap + 1, (B,), device=dev, generator=g)
        ragged = ((torch.rand(B, cap, device=dev, generator=g) < 0.9)
                  & (torch.arange(cap, device=dev)[None] < valid[:, None]))
        ragged[:, 0] = True
        # slot 0: a ring in its first 8 s; slot 1: every position masked
        edges = ragged.clone()
        edges[0] = False
        edges[0, :100] = True
        edges[1] = False
        for kind, mask in (("ragged", ragged), ("first100+masked", edges)):
            acc, m, lse = k4(q, layer, *caches, mask)
            torch.cuda.synchronize()
            racc, rm, rl = k4p(q, layer, *caches, mask)
            live = torch.ones(B, dtype=torch.bool, device=dev)
            masked_ok = True
            if kind != "ragged":
                live[1] = False
                masked_ok = bool((m[1] == i4.MASKED).all()) and bool((lse[1] == cap).all())
            err = max(rel_err(acc[live] / lse[live], racc[live] / rl[live]),
                      rel_err(m[live], rm[live]))
            max_abs = max(max_abs, (acc[live] / lse[live] - racc[live] / rl[live]).abs().max()
                          .item())
            ok = err <= ATTN_BOUND and bool(torch.isfinite(acc / lse).all()) and masked_ok
            note = "" if kind == "ragged" else (", fully masked slot: m = -1e30 and l = cap"
                                                if masked_ok else ", fully masked slot WRONG")
            phase("kernels", f"decode_attention_int4 B={B} H={H} D={D} cap={cap} layer={layer} "
                  f"{kind} mask: max rel err of acc/l and m {err:.3e} (bound "
                  f"{ATTN_BOUND:.0e}){note} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("decode_attention_int4 disagrees with its plain version")
        mask = ragged
        ops = [(q, li, *caches, mask) for li in range(L)]
        t = {"ms": time_ms(k4, ops), "plain_ms": time_ms(k4p, ops, iters=4),
             "library_ms": sdpa_dequantized_ms(q, caches, mask)}
        nbytes = (2 * B * H * D // 2 * cap + 2 * 2 * B * H * cap + B * cap + 2 * B * H * D
                  + 4 * B * H * (D + 2))
        t["bound_ms"], row["bound_by"] = bound(nbytes, 4 * B * H * cap * D)
        phase("kernels", f"decode_attention_int4 B={B} H={H} D={D} cap={cap}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"on the dequantized bf16 layer {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB); "
              f"{nbytes / t['ms'] / 1e6:.1f} GB/s, {t['bound_ms'] / t['ms']:.0%} of the bound")
        per_launch[D] = t
        del ops, caches
        free_memory()
    row["per_launch"] = per_launch[KV["head_dim"]]
    row["per_launch_by_head_dim"] = per_launch
    row["max_abs_err"] = max_abs
    return row


def sdpa_dequantized_ms(q, caches, mask) -> float:
    """Time of scaled_dot_product_attention of q [B, H, 1, D] over layers 0
    and 1 of the packed int4 caches, dequantized to bf16 beforehand (the
    library call for K4's work; the port never calls it)."""
    import torch.nn.functional as F

    from moshi_tpu_torch.ops.int4_attention import _dequant_layer

    cap = mask.shape[-1]

    def dense(li):
        return [_dequant_layer(c[li], s[li], cap).transpose(-1, -2).to(torch.bfloat16)
                .contiguous() for c, s in ((caches[0], caches[2]), (caches[1], caches[3]))]
    lib_ops = [(q, *dense(li), mask[:, None, None, :]) for li in range(2)]
    return time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=m_), lib_ops)


def main_path_rows(g, B, Hkv, D, dev):
    """Current rows as the int4 step passes them: kk contiguous, vv a view
    of a qkv-like [B, 3 * Hkv * D] tensor (its slots 3 * Hkv * D apart)."""
    kk = torch.randn(B, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
    qkv = torch.randn(B, 3 * Hkv * D, device=dev, generator=g).to(torch.bfloat16)
    return kk, qkv[:, Hkv * D:2 * Hkv * D].view(B, Hkv, D)


def check_fused_write(dev, g) -> dict:
    """decode_attention_int4_write, the attention whose launch also writes
    the layer's new column, at the batched path's shape (L = 32, B = SLOTS,
    H = Hkv = 32, cap 3000), D = 128 and 64, and at the tts path's (L = 48,
    cap 1000, D = 64), layer 5, over two launches as
    two frames of the ring: slots 0-3 at lanes 0, 63, 64 and cap - 1, slot
    2 frozen (its second write lands on its first's lane), slot 4 with
    every position masked, the second launch attending the lanes the first
    wrote.  After each launch the four caches must equal, byte for byte,
    the plain quantization of the rows on the card written by
    cache_write_int4_plain into a copy of the caches (so every other byte
    is unchanged), and the stats must be within ATTN_BOUND of the plain
    version's; two calls on copies of one cache must give the same bits.
    The plain quantization on the card must give the bytes and scales of
    the rows' CPU copies (the JAX package's).  Then, on the same operands,
    the fused launch's time beside the attention alone: their difference
    is the write's cost."""
    from moshi_tpu_torch.ops import int4_attention as i4

    k4w, k4 = i4.decode_attention_int4_write, i4.decode_attention_int4_stats
    B, H, layer = SLOTS, KV["heads"], 5
    frozen, masked = 2, 4
    max_abs, per_launch = 0.0, {}
    cases = [("moshi", KV["layers"], KV["cap"], 128), ("moshi", KV["layers"], KV["cap"], 64),
             ("tts", TTS_KV["layers"], TTS_KV["cap"], TTS_KV["head_dim"])]
    for path, L, cap, D in cases:
        cap_pad = -(-cap // 128) * 128
        lanes = torch.arange(cap, device=dev)[None]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = {"warps": i4.plan_warps(B, H, H, cap, sms), "blocks": i4.attention_blocks(B, H, H)}
        plan["warps_per_sm"] = plan["blocks"] * plan["warps"] / sms
        phase("kernels", f"decode_attention_int4_write {path} L={L} B={B} H={H} D={D} cap={cap} "
              f"(cap_pad {cap_pad}) plan: {plan['blocks']} blocks of {plan['warps']} warps, "
              f"{plan['warps_per_sm']:.1f} warps per SM on {sms} SMs")
        caches = random_int4_cache(g, L, B, H, D, cap_pad, dev)
        expected = [c.clone() for c in caches]
        pos = torch.cat([torch.tensor([0, 63, 64, cap - 1], device=dev),
                         torch.randint(0, cap, (B - 4,), device=dev, generator=g)])
        card_vs_cpu = 0
        for step in range(2):
            if step:
                pos = torch.where(torch.arange(B, device=dev) == frozen, pos, (pos + 1) % cap)
            # each slot's ring holds its lanes below the write lane and, from
            # an earlier lap, its last 100
            mask = ((lanes < pos[:, None]) | (lanes >= cap - 100)) & (lanes != pos[:, None])
            mask[masked] = False
            q = torch.randn(B, H, 1, D, device=dev, generator=g).to(torch.bfloat16)
            kk, vv = main_path_rows(g, B, H, D, dev)
            racc, rm, rl = i4.decode_attention_int4_stats_plain(q, layer, *expected, mask)
            cols = i4.int4_columns(kk, vv)
            card_vs_cpu += sum(int((a.cpu() != b).sum())
                               for a, b in zip(cols, i4.int4_columns(kk.cpu(), vv.cpu())))
            i4.cache_write_int4_plain(pos, *cols, *(e[layer:layer + 1] for e in expected))
            acc, m, lse = k4w(q, kk, vv, pos, layer, *caches, mask)
            torch.cuda.synchronize()
            equal = all(torch.equal(c, e) for c, e in zip(caches, expected))
            live = torch.arange(B, device=dev) != masked
            err = max(rel_err(acc[live] / lse[live], racc[live] / rl[live]),
                      rel_err(m[live], rm[live]))
            max_abs = max(max_abs, (acc[live] / lse[live] - racc[live] / rl[live]).abs().max()
                          .item())
            masked_ok = bool((m[masked] == i4.MASKED).all()) and bool((lse[masked] == cap).all())
            ok = equal and err <= ATTN_BOUND and masked_ok and bool(torch.isfinite(acc).all())
            phase("kernels", f"decode_attention_int4_write L={L} B={B} H={H} D={D} cap={cap} "
                  f"layer={layer} frame {step + 1} (lanes {pos[:5].tolist()}, slot {frozen} "
                  f"frozen, slot {masked} fully masked): caches "
                  f"{'byte-equal to the plain write' if equal else 'DIFFER'}, max rel err of "
                  f"acc/l and m {err:.3e} (bound {ATTN_BOUND:.0e}), fully masked slot "
                  f"{'m = -1e30 and l = cap' if masked_ok else 'WRONG'} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("decode_attention_int4_write disagrees with its plain version")
        phase("kernels", f"decode_attention_int4_write D={D}: the plain quantization on the "
              f"card differs from the CPU's in {card_vs_cpu} column bytes and scales over the "
              f"two frames {'ok' if card_vs_cpu == 0 else 'FAIL'}")
        if card_vs_cpu:
            raise RuntimeError("the plain int4 quantization on the card is not the CPU's")
        del expected
        small = random_int4_cache(g, 2, B, H, D, cap_pad, dev)
        runs = []
        for _ in range(2):
            copy = [c.clone() for c in small]
            runs.append(k4w(q, kk, vv, pos, 1, *copy, mask) + tuple(copy))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        phase("kernels", f"decode_attention_int4_write D={D}: two calls on copies of one cache "
              f"(slot {masked} fully masked) give {'the same bits' if same else 'OTHER BITS'}")
        if not same:
            raise RuntimeError("decode_attention_int4_write is not deterministic")
        del small, runs

        ops_w = [(q, kk, vv, pos, li, *caches, mask) for li in range(L)]
        ops_s = [(q, li, *caches, mask) for li in range(L)]
        # in turns after a discarded reading: the first timing after the
        # checks read ~6 us high in three calls out of three
        time_ms(k4w, ops_w)
        fused = [time_ms(k4w, ops_w)]
        alone = [time_ms(k4, ops_s), time_ms(k4, ops_s)]
        fused.append(time_ms(k4w, ops_w))
        t_fused, t_alone = sum(fused) / 2, sum(alone) / 2
        cols = i4.int4_columns(kk, vv)
        bi, pi = torch.arange(B, device=dev)[:, None], pos[:, None]

        def write_plain(kk_, vv_, pos_, li, k_all, v_all, ks_all, vs_all):
            at = slice(li, li + 1)
            i4.cache_write_int4_plain(pos_, *i4.int4_columns(kk_, vv_), k_all[at], v_all[at],
                                      ks_all[at], vs_all[at])

        def index_put(li, k_all, v_all, ks_all, vs_all):
            for col, cache in zip(cols, (k_all, v_all, ks_all, vs_all)):
                ri = torch.arange(col.shape[-1], device=dev)[None]
                cache[li].index_put_((bi, ri, pi), col[0])
        write_ops = [(kk, vv, pos, li, *caches) for li in range(L)]
        write_bytes = 2 * B * H * D * 2 + 8 * B + 2 * B * H * D // 2 + 2 * 2 * B * H
        attn_bytes = (2 * B * H * D // 2 * cap + 2 * 2 * B * H * cap + B * cap + 2 * B * H * D
                      + 4 * B * H * (D + 2))
        write = {"ms": t_fused - t_alone, "plain_ms": time_ms(write_plain, write_ops),
                 "library_ms": time_ms(index_put, [(li, *caches) for li in range(L)])}
        write["bound_ms"], _ = bound(write_bytes, 0)
        k4_row = {"ms": t_fused, "attention_alone_ms": t_alone,
                  "plain_ms": time_ms(i4.decode_attention_int4_write_plain, ops_w, iters=4),
                  "library_ms": sdpa_dequantized_ms(q, caches, mask)}
        k4_row["bound_ms"], _ = bound(attn_bytes + write_bytes, 4 * B * H * cap * D)
        phase("kernels", f"decode_attention_int4_write B={B} H={H} D={D} cap={cap}: fused "
              f"launch {fused[0]:.4f} / {fused[1]:.4f} ms (scaled_dot_product_attention on "
              f"the dequantized bf16 layer {k4_row['library_ms']:.4f} ms, bound "
              f"{k4_row['bound_ms']:.4f} ms), the attention alone "
              f"{alone[0]:.4f} / {alone[1]:.4f} ms: the write costs "
              f"{write['ms'] * 1e3:.2f} us per launch, {write['ms'] * L:.4f} ms per frame "
              f"({L} launches; bound {write['bound_ms'] * L:.5f} ms, "
              f"{write_bytes * L / 1e6:.2f} MB read + written; the plain write "
              f"{write['plain_ms'] * L:.3f} ms, index_put_ of the packed columns into the 4 "
              f"caches {write['library_ms'] * L:.3f} ms); earlier designs (PERF.md): the "
              f"standalone cache_write_int4 {EARLIER_MS['cache_write_int4 per frame']} ms per "
              f"frame, the attention {EARLIER_MS['decode_attention_int4 per launch']} ms per "
              f"launch")
        per_launch[f"{path} L={L} cap={cap} D={D}"] = {"write": write, "k4": k4_row,
                                                       "plan": plan}
        del ops_w, ops_s, write_ops, caches
        free_memory()
    at_d = per_launch[f"moshi L={KV['layers']} cap={KV['cap']} D={KV['head_dim']}"]
    tts = per_launch[f"tts L={TTS_KV['layers']} cap={TTS_KV['cap']} D={TTS_KV['head_dim']}"]
    return {"per_launch": at_d["write"], "k4_per_launch": at_d["k4"],
            "tts_per_launch": tts["write"], "tts_k4_per_launch": tts["k4"],
            "per_launch_by_case": per_launch, "bound_by": "bytes", "max_abs_err": 0.0,
            "stats_max_abs_err": max_abs}


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
    """decode_attention_int8 against its plain version at the main paths'
    shapes (INT8_KV), D = 128 and 64 (the TTS shape at its D = 64), layer
    3 of 4, a ragged mask and slot 0 with every position masked (which must
    give 0); times per launch at each path's head dim beside
    scaled_dot_product_attention on the dequantized bf16 layer and the
    bound."""
    import torch.nn.functional as F

    from moshi_tpu_torch.ops import decode_attention as da
    from moshi_tpu_torch.ops.decode_attention import (decode_attention_int8 as k6,
                                                      decode_attention_int8_plain as k6p)

    L, layer = 4, 3
    max_abs, per_launch, bound_by, plans = 0.0, {}, None, {}
    for path, (B, H, cap) in INT8_KV.items():
        timed_d = TTS_KV["head_dim"] if path == "tts" else 128  # the path's head dim
        for D in (64,) if path == "tts" else (128, 64):
            caches = random_int8_cache(g, L, B, cap, H, D, dev)
            q = torch.randn(B, H, D, device=dev, generator=g).to(torch.bfloat16)
            valid = torch.randint(1, cap + 1, (B,), device=dev, generator=g)
            ragged = ((torch.rand(B, cap, device=dev, generator=g) < 0.9)
                      & (torch.arange(cap, device=dev)[None] < valid[:, None]))
            ragged[:, 0] = True
            # the Moshi ring's first 8 s: only positions 0..99 masked in, so
            # every later split holds none
            first100 = torch.zeros(B, cap, dtype=torch.bool, device=dev)
            first100[:, :100] = True
            masks = {"ragged": ragged, **({"first100": first100} if path == "moshi_b16" else {})}
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            splits, per, warps = da.plan_splits(B, H, D, cap, sms)
            blocks = B * -(-H // da.heads_per_block(D)) * splits
            plans[f"{path} D={D}"] = {"splits": splits, "cluster": splits, "per_split": per,
                                      "warps": warps, "blocks": blocks,
                                      "blocks_per_sm": blocks / sms}
            phase("kernels", f"decode_attention_int8 {path} B={B} H={H} D={D} cap={cap} plan: "
                  f"{splits} splits of {per} positions (clusters of {splits} blocks), "
                  f"{blocks} blocks of {warps} warps and {da.heads_per_block(D)} heads, "
                  f"{blocks / sms:.2f} blocks ({blocks * warps / sms:.1f} warps) per SM on "
                  f"{sms} SMs")
            for kind, mask in masks.items():
                mask[0] = False
                out = k6(q, layer, *caches, mask)
                torch.cuda.synchronize()
                ref = k6p(q, layer, *caches, mask)
                err = rel_err(out[1:], ref[1:])
                max_abs = max(max_abs, (out.float() - ref.float()).abs().max().item())
                ok = (err <= ATTN_BOUND and bool(torch.isfinite(out).all())
                      and bool((out[0] == 0).all()))
                phase("kernels", f"decode_attention_int8 B={B} H={H} D={D} cap={cap} "
                      f"layer={layer} {kind} mask: max rel err {err:.3e} (bound "
                      f"{ATTN_BOUND:.0e}), fully masked slot "
                      f"{'0' if (out[0] == 0).all() else 'NOT 0'} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError("decode_attention_int8 disagrees with its plain version")
            mask = ragged
            if D != timed_d:
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
        free_memory()
    return {"per_launch": per_launch["asr"], "per_launch_by_shape": per_launch,
            "bound_by": bound_by, "max_abs_err": max_abs, "plans": plans}


# ------------------------------------------------------------------ slice
def per_step_launches(cfg, params, batch: int) -> dict:
    """Kernel launches one LMGen.step of `batch` slots implies: each q4
    temporal linear once per layer plus the text head, each on the kernel
    that q4matmul.route picks for bf16 x of `batch` rows; each int8
    depformer linear once per layer and codebook, plus depformer_in and the
    output head per codebook, each on the kernel that qmatmul.use_mma
    picks; with the int4 KV cache, one decode_attention_int4 per layer,
    each writing its layer's column (counted as cache_write_int4 too); with
    the int8 KV cache, one decode_attention_int8 per layer."""
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
    per_step = dict.fromkeys(("q4_gemv", "q4_mma", "q4_wgmma", "int8_gemv", "int8_mma"), 0)
    for w, n in [(w, cfg.num_layers) for w in temporal] + [(params["text_linear"]["weight"], 1)]:
        dout = w.q.shape[-1]
        gs = 2 * w.q.shape[-2] // w.scale.shape[-3]
        per_step[q4matmul.route(batch, torch.bfloat16, gs, dout)] += n
    for w, n in ([(w, cfg.depformer_num_layers * cfg.dep_q) for w in dep]
                 + [(params["depformer_in"]["weight"], cfg.dep_q),
                    (params["linears"]["weight"], cfg.dep_q)]):
        din, dout = w.q.shape[-2:]
        per_step["int8_mma" if qmatmul.use_mma(batch, torch.bfloat16, din, dout)
                 else "int8_gemv"] += n
    if (per_step["q4_gemv"] + per_step["q4_mma"] + per_step["q4_wgmma"]
            != sum(Q4_SHAPES.values())
            or per_step["int8_gemv"] + per_step["int8_mma"] != sum(INT8_SHAPES.values())):
        raise RuntimeError(f"launches per step {per_step} do not match the shape tables")
    int4 = cfg.kv_cache_dtype == "int4"
    per_step["decode_attention_int4"] = cfg.num_layers if int4 else 0
    per_step["cache_write_int4"] = cfg.num_layers if int4 else 0
    per_step["decode_attention_int8"] = cfg.num_layers if cfg.kv_cache_dtype == "int8" else 0
    return per_step


def counters() -> dict:
    """The launch-counted wrappers, by kernel name: decode_attention_int4
    counts every launch of that kernel, cache_write_int4 those that write."""
    from moshi_tpu_torch.ops.decode_attention import decode_attention_int8
    from moshi_tpu_torch.ops.int4_attention import (decode_attention_int4_stats,
                                                    decode_attention_int4_write)
    from moshi_tpu_torch.ops.q4matmul import q4_gemv, q4_mma, q4_wgmma
    from moshi_tpu_torch.ops.qmatmul import int8_gemv, int8_mma
    return {"q4_gemv": q4_gemv, "q4_mma": q4_mma, "q4_wgmma": q4_wgmma, "int8_gemv": int8_gemv,
            "int8_mma": int8_mma,
            "decode_attention_int4": decode_attention_int4_stats,
            "cache_write_int4": decode_attention_int4_write,
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
    free_memory()
    mimi = MimiModel(mimi_v0_1_config(cfg.dep_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    torch.cuda.synchronize()
    phase("slice", f"Moshi-7B q4 + Mimi bf16 built from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB on the card")
    return lm, lm_params, mimi, mimi_params


def run_slice(dev, card: str, lm, lm_params, mimi, mimi_params) -> dict:
    """ServerState (B = 1) as the server runs it on the card: warm-up, then
    SESSIONS of FRAMES frames, each frame replays of the three graphs
    captured at its first frame (encode, LMGen.step, decode); launch counts
    from the captured step; a profiler pass over 5 graphed frames; then one
    session of the same path eagerly, for the comparison."""
    from moshi_tpu_torch.serve.server import ServerState, serve_sessions

    cfg = lm.config
    expected = per_step_launches(cfg, lm_params, 1)
    if expected["q4_mma"]:
        raise RuntimeError(f"the B = 1 frame would run q4_mma: {expected}")
    state = ServerState(mimi, mimi_params, lm, lm_params, device=dev)
    if not state.graphed:
        raise RuntimeError("ServerState on the card is not graphed")
    state.warmup()
    torch.cuda.synchronize()

    zero_counts()
    results = serve_sessions(state, SESSIONS, FRAMES)
    launches = read_counts()

    steps = len(SESSIONS) * FRAMES
    check_counts(launches, expected, 1, "slice (the captured LMGen.step)")
    replays = {name: getattr(state, name).replays for name in ("encode", "step", "decode")}
    generated = len(SESSIONS) * (FRAMES - cfg.max_delay)
    if replays != {"encode": steps, "step": steps, "decode": generated}:
        raise RuntimeError(f"slice: replays {replays}")
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
    p50, p90 = (float(np.percentile(ms, p)) for p in (50, 90))
    phase("slice", f"graphed, {len(SESSIONS)} sessions x {FRAMES} frames: launches {launches} "
          f"= per step {expected} x 1 captured step; replays {replays}; sessions 1 and 3 "
          f"identical, 1 and 2 not; p50 {p50:.2f} ms/frame, p90 {p90:.2f} ms/frame ({card})")
    pcm = (0.1 * np.random.RandomState(SEED + 6).randn(5, mimi.frame_size)).astype(np.float32)
    prof = profile_frames(lambda i: state.step_frame(pcm[i]), len(pcm))
    prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / p50
    phase("slice", f"profiler over 5 graphed frames: {profile_line(prof)}")
    del state
    free_memory()

    eager = ServerState(mimi, mimi_params, lm, lm_params, device=dev, graphed=False)
    eager.warmup()
    zero_counts()
    (tokens, _, ems), = serve_sessions(eager, SESSIONS[:1], FRAMES)
    eager_launches = read_counts()
    check_counts(eager_launches, expected, FRAMES, "slice, eager")
    same = np.array_equal(tokens, results[0][0])
    e50, e90 = (float(np.percentile(ems, p)) for p in (50, 90))
    phase("slice", f"eager, 1 session x {FRAMES} frames: p50 {e50:.2f} ms/frame, p90 "
          f"{e90:.2f} ms/frame; launches {eager_launches}; its sampled tokens "
          f"{'equal' if same else 'DIFFER from'} the graphed session's of the same seed")
    del eager
    free_memory()
    return {"launches": launches, "replays": replays, "p50_ms": p50, "p90_ms": p90,
            "profile": prof, "eager": {"p50_ms": e50, "p90_ms": e90, "frames": len(ems),
                                       "launches": eager_launches,
                                       "sampled_tokens_equal_graphed": same}}


# ---------------------------------------------------------------- batched
# the isolation script's copies of slot 0: slot -> (its session index,
# frames it executes in that session)
SAME_AS_0 = {1: (0, FRAMES), 2: (0, FRAMES - 5), 3: (0, FRAMES - 5), 4: (1, FRAMES - 20)}


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
    return schedule, frames, SAME_AS_0


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


def profile_line(prof: dict) -> str:
    return (f"card busy {prof['busy_ms_per_frame']:.2f} ms/frame, idle share "
            f"{prof['idle_share']:.3f} (host {prof['host_ms_per_frame']:.2f} ms/frame under the "
            f"profiler); kernels ms/frame {json.dumps(prof['kernel_ms_per_frame'])}; "
            f"{prof['device_ops_per_frame']:.0f} device ops/frame, the most costly "
            f"{json.dumps(prof['top_device_ms_per_frame'])}")


def tensor_leaves(tree) -> list:
    """Every tensor of a tree of dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def state_leaves(state) -> list:
    """Every tensor of a batched engine's streaming state (Mimi encode and
    decode, LMGen), in a fixed order."""
    return tensor_leaves([state.enc_state, state.dec_state, state.gen_state])


def every_slot_frame(state, seed: int, frames: int):
    """run_frame(i): frame i of `frames` frames of every slot sending seeded
    PCM, its outputs read back."""
    pcm = (0.1 * np.random.RandomState(seed).randn(frames, SLOTS, 1, state.frame_size)
           ).astype(np.float32)

    def run_frame(i):
        out, audio = state.frame(pcm[i], np.ones(SLOTS, bool))
        out.cpu(), audio.cpu()
    return run_frame


def host_ms(run_frame, n: int) -> list:
    """Host ms of run_frame(i) for i < n, each ending in a read back."""
    ms = []
    for i in range(n):
        t0 = time.perf_counter()
        run_frame(i)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def greedy_isolation(dev, lm, lm_params, mimi, mimi_params, what: str,
                     profile: bool = False) -> tuple[dict, dict]:
    """The greedy run of BatchedMoshiState at B = SLOTS over the isolation
    script, graphed (the main path: token checks, launch counts from the
    captured frame, one replay per frame), then eagerly (a launch count per
    frame), and the two held equal: tokens and PCM of every session, and
    every state byte at the end.  With `profile`, then 5 frames of every
    slot timed on each engine and 5 graphed ones under the profiler (card
    busy ms, kernel ms per frame, idle share of the graphed p50).  Returns
    the graphed launches and a summary."""
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState, serve_batched

    cfg = lm.config
    expected = per_step_launches(cfg, lm_params, SLOTS)
    schedule, frames, same_as_0 = isolation_script(mimi.frame_size)
    runs = {}
    for graphed in (True, False):
        state = BatchedMoshiState(mimi, mimi_params, lm, lm_params, SLOTS, device=dev,
                                  graphed=graphed, use_sampling=False)
        if graphed:
            kshape = tuple(state.gen_state["transformer"]["k"].shape)
            phase("batched", f"{what}: B = {SLOTS}, {cfg.kv_cache_dtype} KV cache {kshape} "
                  f"int8 x 2 + bf16 scales; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
                  f"on the card")
        state.warmup()
        zero_counts()
        sessions, ms = serve_batched(state, schedule, frames)
        launches = read_counts()
        kind = "graphed" if graphed else "eager"
        check_counts(launches, expected, 1 if graphed else len(ms), f"batched {what} {kind} run")
        runs[kind] = (state, sessions, ms, launches)
    state, sessions, ms, launches = runs["graphed"]
    if state.step.replays != len(ms):
        raise RuntimeError(f"{what}: {state.step.replays} replays for {len(ms)} frames")
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
    eager, eager_sessions, eager_ms, eager_launches = runs["eager"]
    same_tokens = all(np.array_equal(a[0], b[0]) and all(np.array_equal(x, y)
                                                         for x, y in zip(a[1], b[1]))
                      for s in range(SLOTS)
                      for a, b in zip(sessions[s], eager_sessions[s]))
    same_state = all(torch.equal(a, b) for a, b in zip(state_leaves(state), state_leaves(eager)))
    p50, p90 = (float(np.percentile(ms, p)) for p in (50, 90))
    e50, e90 = (float(np.percentile(eager_ms, p)) for p in (50, 90))
    phase("batched", f"{what}, {len(ms)} frames graphed: slots 1 (same PCM), 2 (joined 5 "
          f"frames late), 3 (frozen on frames 10-14) and 4 (reset at frame 20) repeat slot 0's "
          f"tokens; {distinct} of {SLOTS - 5} other slots differ; launches {launches} = per "
          f"frame {expected} x 1 captured frame, {state.step.replays} replays; p50 {p50:.2f} "
          f"ms, p90 {p90:.2f} ms per batched frame (eager: p50 {e50:.2f}, p90 {e90:.2f}; "
          f"launches {eager_launches}); graphed against eager: tokens and PCM "
          f"{'equal' if same_tokens else 'DIFFER'}, every state byte "
          f"{'equal' if same_state else 'DIFFERS'}")
    if not (same_tokens and same_state):
        raise RuntimeError(f"{what}: the graphed frames differ from the eager ones")
    summary = {"p50_ms": p50, "p90_ms": p90, "replays": state.step.replays,
               "eager": {"p50_ms": e50, "p90_ms": e90, "launches": eager_launches}}
    if profile:
        eager_all = host_ms(every_slot_frame(eager, SEED + 5, 5), 5)
        graphed_all = host_ms(every_slot_frame(state, SEED + 5, 5), 5)
        prof = profile_frames(every_slot_frame(state, SEED + 7, 5), 5)
        prof["p50_ms"] = float(np.percentile(graphed_all, 50))
        prof["p90_ms"] = float(np.percentile(graphed_all, 90))
        prof["eager_p50_ms"] = float(np.percentile(eager_all, 50))
        prof["eager_p90_ms"] = float(np.percentile(eager_all, 90))
        prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / prof["p50_ms"]
        phase("batched", f"{what}, every slot, 5 frames: graphed p50 {prof['p50_ms']:.2f} ms, "
              f"p90 {prof['p90_ms']:.2f} ms per batched frame (eager p50 "
              f"{prof['eager_p50_ms']:.2f}, p90 {prof['eager_p90_ms']:.2f}); profiler over 5 "
              f"graphed frames: {profile_line(prof)}")
        summary["profile"] = prof
    del runs, state, sessions, eager, eager_sessions
    free_memory()
    return launches, summary


def run_batched(dev, card: str, lm_params, mimi, mimi_params) -> dict:
    """The batched path at B = SLOTS with the int4 KV cache (its greedy run,
    then a sampled run of every slot, graphed, then a shorter eager one),
    then its greedy run with the int8 KV cache."""
    from dataclasses import replace

    from moshi_tpu_torch.models.lm import LMModel, lm_config_v0_1
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState, serve_batched

    cfg = replace(lm_config_v0_1(), kv_cache_dtype="int4")
    lm = LMModel(cfg)
    expected = per_step_launches(cfg, lm_params, SLOTS)
    if expected["q4_gemv"] or expected["int8_gemv"]:
        raise RuntimeError(f"the B = {SLOTS} frame would run a CUDA-core GEMV kernel: {expected}")

    # 1. greedy isolation run, graphed and eager
    greedy_launches, greedy = greedy_isolation(dev, lm, lm_params, mimi, mimi_params, "greedy")

    # 2. sampled run, every slot active: graphed (the main path), then eager
    rs = np.random.RandomState(SEED + 2)
    frames = {s: (0.1 * rs.randn(FRAMES + 1, mimi.frame_size)).astype(np.float32)
              for s in range(SLOTS)}
    runs = {}
    for graphed, n in ((True, FRAMES), (False, EAGER_FRAMES)):
        state = BatchedMoshiState(mimi, mimi_params, lm, lm_params, SLOTS, device=dev,
                                  rng_seed=SEED, graphed=graphed, use_sampling=True)
        state.warmup()
        schedule = [dict.fromkeys(range(SLOTS), "join")] + [dict.fromkeys(range(SLOTS), "send")] * n
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        sessions, ms = serve_batched(state, schedule, frames)
        launches = read_counts()
        kind = "graphed" if graphed else "eager"
        check_counts(launches, expected, 1 if graphed else len(ms), f"batched sampled {kind} run")
        for s in range(SLOTS):
            tokens, audio = sessions[s][0]
            if len(tokens) != n - cfg.max_delay:
                raise RuntimeError(f"sampled {kind} slot {s}: {len(tokens)} frames generated")
            check_tokens(tokens, cfg, f"sampled {kind} slot {s}")
            check_pcm(audio, mimi.frame_size, f"sampled {kind} slot {s}")
        runs[kind] = {"launches": launches, "frames": len(ms),
                      **{f"p{p}_ms": float(np.percentile(ms, p)) for p in (50, 75, 90)},
                      "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                      "reserved_gib": torch.cuda.memory_reserved(dev) / 2 ** 30}
        if graphed:
            if state.step.replays != len(ms):
                raise RuntimeError(f"sampled: {state.step.replays} replays for {len(ms)} frames")
            runs[kind]["replays"] = state.step.replays
            # the profiler slows the host, so the idle share is taken against
            # the frame time measured without it
            prof = profile_frames(every_slot_frame(state, SEED + 1, 5), 5)
            prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / runs[kind]["p50_ms"]
            runs[kind]["profile"] = prof
        del state, sessions
        free_memory()
    g, e = runs["graphed"], runs["eager"]
    phase("batched", f"sampled, {g['frames']} frames x {SLOTS} slots graphed: p50 "
          f"{g['p50_ms']:.2f} ms, p75 {g['p75_ms']:.2f} ms, p90 {g['p90_ms']:.2f} ms per batched "
          f"frame; {g['p50_ms'] / SLOTS:.2f} ms per user-frame at p50; peak {g['peak_gib']:.2f} "
          f"GiB allocated, {g['reserved_gib']:.2f} GiB reserved; launches {g['launches']} = per "
          f"frame {expected} x 1 captured frame, {g['replays']} replays ({card})")
    phase("batched", f"sampled, {e['frames']} frames x {SLOTS} slots eager: p50 "
          f"{e['p50_ms']:.2f} ms, p90 {e['p90_ms']:.2f} ms per batched frame; peak "
          f"{e['peak_gib']:.2f} GiB allocated, {e['reserved_gib']:.2f} GiB reserved; launches "
          f"{e['launches']} ({card})")
    phase("batched", f"profiler over 5 graphed sampled frames: {profile_line(g['profile'])}")

    # 3. the greedy run with the int8 KV cache (the worker's kv_cache = "int8")
    lm8 = LMModel(replace(cfg, kv_cache_dtype="int8"))
    int8_launches, int8 = greedy_isolation(dev, lm8, lm_params, mimi, mimi_params,
                                           "int8 greedy", profile=True)
    return {"launches": {"greedy": greedy_launches, "sampled": g["launches"],
                         "int8_greedy": int8_launches},
            "per_frame": {"int4": expected,
                          "int8": per_step_launches(lm8.config, lm_params, SLOTS)},
            "sampled": g, "sampled_eager": e, "greedy": greedy, "int8_greedy": int8}


# ---------------------------------------------------------------- offline
def cast_tree(tree, dtype):
    """A copy of a param tree with every floating tensor in `dtype`."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def timed(fn, reps: int = 3):
    """(result, p50 host ms) of reps calls of fn after one warm-up call,
    each ending in a synchronize."""
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.percentile(ms, 50))


def stream_encode(mimi, params, pcm, dtype):
    """Codes of pcm [B, 1, n * frame_size] by encode_step, one frame at a
    time from a fresh state."""
    state = mimi.init_encode_state(pcm.shape[0], dtype, pcm.device)
    fs = mimi.frame_size
    return torch.cat([mimi.encode_step(params, state, pcm[..., f * fs:(f + 1) * fs])[0]
                      for f in range(pcm.shape[-1] // fs)], dim=-1)


def stream_decode(mimi, params, codes, dtype):
    state = mimi.init_decode_state(codes.shape[0], dtype, codes.device)
    return torch.cat([mimi.decode_step(params, state, codes[..., f:f + 1])[0]
                      for f in range(codes.shape[-1])], dim=-1)


def offline_mimi(dev, card: str, mimi, params, dtype) -> dict:
    """Mimi's offline encode and decode in `dtype` against encode_step /
    decode_step over the same input from a fresh state: the share of equal
    codes (with the first difference's frame and codebook) and the relative
    error of the decoded PCM, each held to OFFLINE_BOUNDS; the offline
    calls' ms and seconds of audio per second."""
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    B, n, extra = OFFLINE_MIMI["batch"], OFFLINE_MIMI["frames"], OFFLINE_MIMI["extra"]
    fs = mimi.frame_size
    rs = np.random.RandomState(SEED + 20)
    pcm = torch.from_numpy((0.1 * rs.randn(B, 1, n * fs)).astype(np.float32)).to(dev, dtype)
    longer = torch.from_numpy((0.1 * rs.randn(1, 1, n * fs + extra)).astype(np.float32)).to(
        dev, dtype)
    codes, enc_ms = timed(lambda: mimi.encode(params, pcm))
    codes_long = mimi.encode(params, longer)
    n_long = -(-longer.shape[-1] // fs)
    if codes.shape != (B, mimi.num_codebooks, n) or codes_long.shape[-1] != n_long:
        raise RuntimeError(f"offline {name}: codes {tuple(codes.shape)}, "
                           f"{tuple(codes_long.shape)}")
    ref = stream_encode(mimi, params, pcm, dtype)
    ref_long = stream_encode(mimi, params, torch.nn.functional.pad(
        longer, (0, n_long * fs - longer.shape[-1])), dtype)
    equal = torch.cat([(codes == ref).flatten(), (codes_long == ref_long).flatten()])
    share = equal.float().mean().item()
    first = None
    if share < 1.0:
        diff = (codes != ref).nonzero()
        diff = diff if len(diff) else (codes_long != ref_long).nonzero()
        b, k, f = diff[diff[:, 2].argmin()].tolist()
        first = {"slot": b, "codebook": k, "frame": f}
    pcm_off, dec_ms = timed(lambda: mimi.decode(params, codes))
    pcm_ref = stream_decode(mimi, params, codes, dtype)
    if pcm_off.shape != pcm_ref.shape or not bool(torch.isfinite(pcm_off).all()):
        raise RuntimeError(f"offline {name}: decode gave {tuple(pcm_off.shape)} or non-finite PCM")
    err = rel_err(pcm_off, pcm_ref)
    bounds = OFFLINE_BOUNDS[name]
    seconds = B * n * fs / mimi.config.sample_rate
    ok = share >= bounds["share"] and err <= bounds["pcm"]
    phase("offline", f"Mimi v0.1 {name}, B = {B} x {n} frames ({seconds / B:.1f} s each) and "
          f"one input {extra} samples longer: encode {enc_ms:.2f} ms "
          f"({seconds / enc_ms * 1e3:.1f} s of audio per s), decode {dec_ms:.2f} ms "
          f"({seconds / dec_ms * 1e3:.1f} s/s); codes equal to encode_step's: share "
          f"{share:.6f} (bound >= {bounds['share']}; first difference {first}); decode against "
          f"decode_step: rel err {err:.3e} (bound {bounds['pcm']:.0e}) "
          f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise RuntimeError(f"offline Mimi {name} disagrees with its streaming path")
    return {"encode_ms": enc_ms, "decode_ms": dec_ms, "audio_s": seconds,
            "encode_audio_s_per_s": seconds / enc_ms * 1e3,
            "decode_audio_s_per_s": seconds / dec_ms * 1e3, "codes_equal_share": share,
            "first_difference": first, "pcm_rel_err": err}


class RowsSeen:
    """Records the rows of x of every q4_wgmma launch while it is entered
    (the wrapper's counter counts launches only): the wrapper plans each
    launch with one call of q4matmul.wgmma_plan_splits, whose last argument
    is M."""

    def __enter__(self):
        from moshi_tpu_torch.ops import q4matmul

        self.rows, self._orig = [], q4matmul.wgmma_plan_splits

        def spy(din, dout, group_size, num_sms, rows):
            self.rows.append(rows)
            return self._orig(din, dout, group_size, num_sms, rows)
        q4matmul.wgmma_plan_splits = spy
        return self

    def __exit__(self, *exc):
        from moshi_tpu_torch.ops import q4matmul

        q4matmul.wgmma_plan_splits = self._orig


def offline_lm(dev, card: str, lm, lm_params) -> dict:
    """Moshi-7B's teacher-forced forward (LMModel.forward, q4 temporal
    linears and text head, int8 depformer, bf16) over seeded codes
    [OFFLINE_LM batch, 17, frames]: exact launches (one q4_wgmma of B * T rows
    per q4 linear, no other GEMV), finite logits where the masks say and
    masks equal to the plain ones on the CPU; forward_text's text logits
    against forward_text_step over the bf16 ring KV cache one frame at a
    time; p50 of 5 calls and a profiler pass."""
    from moshi_tpu_torch.models.lm import undelay_logits

    cfg = lm.config
    B, T = OFFLINE_LM["batch"], OFFLINE_LM["frames"]
    rs = np.random.RandomState(SEED + 21)
    codes = rs.randint(0, cfg.card, (B, cfg.num_codebooks, T))
    codes[:, 0] = rs.randint(0, cfg.text_card, (B, T))
    codes = torch.from_numpy(codes).to(dev)
    expected = dict.fromkeys(counters(), 0)
    expected["q4_wgmma"] = sum(Q4_SHAPES.values())

    zero_counts()
    with RowsSeen() as seen:
        out = lm.forward(lm_params, codes)
    launches = read_counts()
    if launches != expected or seen.rows != [B * T] * expected["q4_wgmma"]:
        raise RuntimeError(f"offline forward: launches {launches} (expected {expected}), "
                           f"q4_wgmma rows {sorted(set(seen.rows))}")
    audio = slice(cfg.audio_offset, cfg.audio_offset + cfg.dep_q)
    cpu = codes.cpu()
    _, mask = undelay_logits(cfg.delays[audio], torch.zeros(B, cfg.dep_q, T, 1))
    _, text_mask = undelay_logits(cfg.delays[:1], torch.zeros(B, 1, T, 1))
    mask &= cpu[:, audio] != -1
    text_mask &= cpu[:, :1] != -1
    if not (torch.equal(out["mask"].cpu(), mask) and torch.equal(out["text_mask"].cpu(), text_mask)):
        raise RuntimeError("offline forward: masks differ from the plain ones")
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if (shapes["logits"] != (B, cfg.dep_q, T, cfg.card)
            or shapes["text_logits"] != (B, 1, T, cfg.text_out_card)
            or not bool(torch.isfinite(out["logits"][out["mask"]]).all())
            or not bool(torch.isfinite(out["text_logits"][out["text_mask"]]).all())
            or not bool(torch.isnan(out["logits"][~out["mask"]]).all())):
        raise RuntimeError(f"offline forward: outputs {shapes} not finite where the masks say")
    del out
    _, fwd_ms = timed(lambda: lm.forward(lm_params, codes), reps=5)
    prof = profile_frames(lambda i: (lm.forward(lm_params, codes), torch.cuda.synchronize()), 1)
    q4_ms = prof["kernel_ms_per_frame"].get("q4_wgmma", 0.0)

    # streaming == offline: the text logits of forward_text against T single
    # steps of forward_text_step over the bf16 ring KV cache
    _, text_off = lm.forward_text(lm_params, codes)
    state = lm.transformer.init_state(B, torch.bfloat16, dev)
    text_step = torch.cat([lm.forward_text_step(lm_params, state, codes[:, :, t:t + 1])[1]
                           for t in range(T)], dim=2)
    diff = text_off.float() - text_step.float()
    err = (diff.norm() / text_step.float().norm()).item()
    err_max = rel_err(text_off, text_step)
    argmax = (text_off.argmax(-1) == text_step.argmax(-1)).float().mean().item()
    bound_ = OFFLINE_BOUNDS["lm_text_logits"]
    ok = err <= bound_ and bool(torch.isfinite(text_off).all())
    phase("offline", f"Moshi-7B q4 LMModel.forward over codes [{B}, {cfg.num_codebooks}, {T}]: "
          f"launches {launches} (every q4_wgmma of {B * T} rows); masks equal the plain ones; "
          f"p50 {fwd_ms:.2f} ms of 5, {B * T / fwd_ms * 1e3:.0f} scored frames/s; profiler: "
          f"card busy {prof['busy_ms_per_frame']:.2f} ms, q4_wgmma {q4_ms:.2f} ms of it "
          f"({q4_ms / prof['busy_ms_per_frame']:.3f}); top {json.dumps(prof['top_device_ms_per_frame'])} "
          f"({card})")
    phase("offline", f"forward_text against {T} forward_text_step over the bf16 ring KV: text "
          f"logits ||diff|| / ||step|| {err:.3e} (bound {bound_:.0e}), max |diff| / max |step| "
          f"{err_max:.3e}, greedy argmax agreement {argmax:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("offline text logits disagree with the streaming ones")
    del state
    free_memory()
    return {"launches": launches, "q4_wgmma_rows": B * T, "p50_ms": fwd_ms,
            "scored_frames_per_s": B * T / fwd_ms * 1e3, "profile": prof,
            "q4_wgmma_busy_share": q4_ms / prof["busy_ms_per_frame"],
            "text_logits_rel_err": err, "text_logits_max_rel_err": err_max,
            "text_argmax_agreement": argmax}


def run_offline(dev, card: str, lm, lm_params, mimi, mimi_params) -> dict:
    """The offline halves at full width: Mimi v0.1's encode / decode in f32
    (the bf16 weights cast up) and in bf16, then Moshi-7B's forward."""
    mimi32 = cast_tree(mimi_params, torch.float32)
    res = {"mimi_f32": offline_mimi(dev, card, mimi, mimi32, torch.float32)}
    del mimi32
    free_memory()
    res["mimi_bf16"] = offline_mimi(dev, card, mimi, mimi_params, torch.bfloat16)
    res.update(offline_lm(dev, card, lm, lm_params))
    return res


# -------------------------------------------------------------------- asr
def build_asr(dev):
    """asr_300m_202501 at full width with the int8 KV cache and bf16
    weights (the text head's pad columns scaled by ASR_PAD_LOGIT_SCALE), the
    bf16 Mimi v0.1 with 32 codebooks and the `delay` condition, all from a
    seed.  Returns the models for asr_engine."""
    from dataclasses import replace

    from moshi_tpu_torch.conditioners import ConditionProvider, ContinuousAttributeConditioner
    from moshi_tpu_torch.models.asr import asr_sum_condition
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
    torch.cuda.synchronize()
    phase("asr", f"asr_300m_202501 bf16 (dim {cfg.dim}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads x {cfg.transformer_config.head_dim}, n_q {cfg.n_q}, ctx "
          f"{cfg.context}) + Mimi bf16 with {mimi.num_codebooks} codebooks built from seed "
          f"{SEED + 3} in {time.perf_counter() - t0:.1f} s")
    return {"mimi": mimi, "lm": lm, "mimi_params": mimi_params, "lm_params": lm_params,
            "cond": cond}


def asr_engine(dev, models, batch: int, graphed: bool):
    """A warmed-up BatchedAsrState at B = batch over a StreamingASR of the
    models (graphed: Mimi encode and the temporal step as CUDA graphs)."""
    from moshi_tpu_torch.models.asr import StreamingASR
    from moshi_tpu_torch.serve.batched_asr import BatchedAsrState

    asr = StreamingASR(models["mimi"], models["lm"], batch, asr_delay_in_tokens=ASR_DELAY,
                       temperature=0.0, mimi_dtype=torch.bfloat16, sum_condition=models["cond"],
                       device=dev, graphed=graphed)
    if asr.graphed != graphed:
        raise RuntimeError(f"StreamingASR on the card: graphed {asr.graphed}")
    state = BatchedAsrState(asr, models["mimi_params"], models["lm_params"])
    state.warmup()
    torch.cuda.synchronize()
    return state


def reckoned_kv_gib(cfg, batch: int) -> float:
    """The int8 K and V caches and their bf16 scales at B = batch."""
    tc = cfg.transformer_config
    rows = 2 * cfg.num_layers * batch * tc.kv_capacity * tc.num_kv_heads
    return rows * (tc.head_dim + 2) / 2 ** 30


# the resume within the asr greedy run: slot U sends slot 0's PCM with a
# pause on ticks 15-16; slot S sends the same until its session leaves at
# tick 15, then a new tenant joins slot S (tick 16) with PCM of its own; the
# session resumes on slot R at tick 17 and goes on with U.  Two more ticks
# let U and R reach slot 0's 40 frames.
ASR_RESUME = {"U": 5, "S": 6, "R": 7, "leave": 15, "resume": 17, "extra_ticks": 2}


def asr_script(frame_size: int, slots: int):
    """The batched phase's isolation script at B = slots with ASR_RESUME:
    (schedule, frames)."""
    schedule, frames, _ = isolation_script(frame_size, slots)
    schedule = [dict(t) for t in schedule[:FRAMES]]
    u, s, r = ASR_RESUME["U"], ASR_RESUME["S"], ASR_RESUME["R"]
    leave, resume = ASR_RESUME["leave"], ASR_RESUME["resume"]
    ref = frames[0]
    tenant = np.random.RandomState(SEED + 8).randn(FRAMES, frame_size).astype(np.float32)
    frames[u], frames[s], frames[r] = ref, np.concatenate([ref[:leave], tenant]), ref[leave:]
    schedule += [{} for _ in range(ASR_RESUME["extra_ticks"])]
    for i, tick in enumerate(schedule):
        for slot in (u, s, r):
            tick.pop(slot, None)
        if i < FRAMES:
            if not leave <= i < resume:
                tick[u] = "join" if i == 0 else "send"
            if i <= leave:
                tick[s] = "join" if i == 0 else "send" if i < leave else "leave"
        else:
            tick[u] = "send"
        if i > leave:
            tick[s] = "join" if i == leave + 1 else "send"
        if i >= resume:
            tick[r] = ("resume", s) if i == resume else "send"
    return schedule, frames


def asr_leaves(state) -> list:
    """Every tensor of a BatchedAsrState's streaming state, in a fixed
    order."""
    return tensor_leaves([state.state["mimi"], state.state["transformer"]])


def same_bytes(a, b) -> bool:
    """Equal bit for bit, NaN included (a slot frozen at offset 0 writes NaN
    rows into Mimi's KV cache, as the JAX package's does)."""
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def asr_greedy(dev, models, graphed: bool):
    """A warmed-up engine at B = ASR_SLOTS, then the greedy run of
    asr_script, one frame per tick, with the launches counted.  Returns
    (state, sessions, ms, launches)."""
    from moshi_tpu_torch.serve.batched_asr import serve_asr

    state = asr_engine(dev, models, ASR_SLOTS, graphed)
    schedule, frames = asr_script(state.frame_size, ASR_SLOTS)
    ptrs = [t.data_ptr() for t in asr_leaves(state)]
    zero_counts()
    sessions, ms = serve_asr(state, schedule, frames)
    launches = read_counts()
    if [t.data_ptr() for t in asr_leaves(state)] != ptrs:
        raise RuntimeError("asr: a reset or a restore moved a state tensor")
    return state, sessions, ms, launches


def asr_runs(dev, models, graphed: bool):
    """One engine at B = ASR_SLOTS: its greedy run, then 10 frames of every
    slot sending and a profiler pass over 5 more.  Returns (state, summary
    with the peak memory over the engine's life so far: allocated, and
    above what was allocated before it)."""
    free_memory()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state, sessions, ms, launches = asr_greedy(dev, models, graphed)
    if graphed:
        kv = state.state["transformer"]
        phase("asr", f"B = {ASR_SLOTS}, int8 KV cache {tuple(kv['k'].shape)} x 2 + bf16 scales "
              f"{tuple(kv['k_scale'].shape)}; {(torch.cuda.memory_allocated(dev) - before) / 2**30:.2f} "
              f"GiB for the engine")
        del kv
    # the resumed session against the unbroken slot, before they part
    u, r = ASR_RESUME["U"], ASR_RESUME["R"]
    resume = {"rows_equal": all(same_bytes(a, b) for a, b in zip(*(
        tensor_leaves(state.asr.extract_slot_arrays(state.state, slot)) for slot in (u, r)))),
        "clock": state.asr.items[r].step_idx, "resumed": state.slot_resumed.get(r),
        "left_at": ASR_RESUME["leave"], "resumed_at": ASR_RESUME["resume"]}
    every = every_slot_asr(state, SEED + 4, 10, True)
    peak = torch.cuda.max_memory_allocated(dev)
    return state, {"sessions": sessions, "ms": ms, "launches": launches, "resume": resume,
                   "every_slot": every, "peak_gib": peak / 2 ** 30,
                   "engine_peak_gib": (peak - before) / 2 ** 30}


def words(msgs):
    return [m for m in msgs if m["type"] in ("Word", "EndWord")]


def check_asr_sessions(cfg, sessions, ms) -> dict:
    """The greedy run's checks: token ranges and Word / EndWord messages,
    slots 1-4 and U repeating slot 0, the resumed session (S then R)
    repeating slot 0, other slots differing.  Returns what it counted."""
    B = len(sessions)
    u, s, r = ASR_RESUME["U"], ASR_RESUME["S"], ASR_RESUME["R"]
    ref = sessions[0][0][0]
    if len(ms) != FRAMES + ASR_RESUME["extra_ticks"] or len(ref) != FRAMES:
        raise RuntimeError(f"asr: {len(ms)} frames, slot 0 has {len(ref)} tokens")
    said = {"Word": 0, "EndWord": 0}
    for slot in range(B):
        for tokens, msgs in sessions[slot]:
            if not ((tokens >= 0).all() and (tokens < cfg.text_card).all()):
                raise RuntimeError(f"asr slot {slot}: text token out of range")
            for m in msgs:
                said[m["type"]] = said.get(m["type"], 0) + 1
    if not (said["Word"] and said["EndWord"]):
        raise RuntimeError(f"asr: no Word or no EndWord message came out: {said}")
    ref_words = words(sessions[0][0][1])
    if not ref_words:
        raise RuntimeError("asr: slot 0 said no word, so its copies have nothing to repeat")
    (left_t, left_m), _ = sessions[s]
    (resumed_t, resumed_m), = sessions[r]
    copies = {**{slot: sessions[slot][i] for slot, (i, _) in SAME_AS_0.items()},
              u: sessions[u][0],
              "resumed": (np.concatenate([left_t, resumed_t]), left_m + resumed_m)}
    executed = {**{slot: n for slot, (_, n) in SAME_AS_0.items()}, u: FRAMES,
                "resumed": FRAMES}
    for slot, (got, msgs) in copies.items():
        if len(got) != executed[slot] or not np.array_equal(got, ref[:len(got)]):
            raise RuntimeError(f"asr: slot {slot} does not repeat slot 0's text tokens")
        # a slot that executed fewer frames said what slot 0 said in them
        got_words = words(msgs)
        if got_words != ref_words[:len(got_words)] or (
                executed[slot] == FRAMES and got_words != ref_words):
            raise RuntimeError(f"asr: slot {slot} does not repeat slot 0's Word / EndWord "
                               f"messages")
    if len(left_t) != ASR_RESUME["leave"]:
        raise RuntimeError(f"asr: the session left after {len(left_t)} frames")
    distinct = sum(not np.array_equal(sessions[slot][0][0], ref) for slot in range(8, B))
    if distinct == 0:
        raise RuntimeError("asr: no slot with its own PCM differs from slot 0")
    return {"said": said, "ref_words": len(ref_words), "distinct": distinct}


def every_slot_asr(state, seed: int, frames: int, profile: bool):
    """Every slot of an engine sends `frames` frames of unit-RMS noise, one
    tick each: host ms per batched frame (the tick), the word trackers' host
    ms, then a profiler pass over 5 more frames when asked.  The engine's
    slots must all be open."""
    B, fs = state.batch_size, state.frame_size
    pcm = np.random.RandomState(seed).randn(frames + 5, B, fs).astype(np.float32)

    def run_frame(i):
        for slot in range(B):
            state.feed_pcm(slot, pcm[i, slot])
        state.tick()
    full, host = [], []
    for i in range(frames):
        run_frame(i)
        full.append(state.frame_ms)
        host.append(state.asr.host_ms)
    out = {f"p{p}_ms": float(np.percentile(full, p)) for p in (50, 75, 90)}
    out["host_ms_p50"] = float(np.percentile(host, 50))
    out["frames"] = frames
    if profile:
        prof = profile_frames(lambda i: run_frame(frames + i), 5)
        # against the p50 of the same kind of frame, taken without the profiler
        prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / out["p50_ms"]
        out["profile"] = prof
    return out


def asr_sweep(dev, models, card: str) -> dict:
    """Graphed engines at ASR_SWEEP slots, every slot sending: one frame
    (the capture), then 20 timed; p50 / p90 ms per batched frame and peak
    memory at each B.  Names the largest B whose p90 stays under 80 ms."""
    cfg, out = models["lm"].config, {}
    for B in ASR_SWEEP:
        free_memory()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state = asr_engine(dev, models, B, True)
        for slot in range(B):
            state.acquire_slot(slot)
        every_slot_asr(state, SEED + 9, 1, False)
        r = every_slot_asr(state, SEED + 10, 20, False)
        r["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        r["engine_peak_gib"] = r["peak_gib"] - before / 2 ** 30
        r["reckoned_kv_gib"] = reckoned_kv_gib(cfg, B)
        r["replays"] = state.asr.step.replays
        out[B] = r
        phase("asr", f"sweep B = {B}, graphed, 20 frames of every slot: p50 {r['p50_ms']:.2f} "
              f"ms, p90 {r['p90_ms']:.2f} ms per batched frame ({r['p50_ms'] / B:.4f} ms per "
              f"stream at p50); peak {r['peak_gib']:.2f} GiB allocated, {r['engine_peak_gib']:.2f} "
              f"GiB of it above what the card held before the engine, of that the int8 KV cache "
              f"and scales {r['reckoned_kv_gib']:.2f} GiB reckoned ({card})")
        del state
    real_time = [B for B, r in out.items() if r["p90_ms"] < 80.0]
    largest = max(real_time) if real_time else None
    phase("asr", f"sweep: the largest B of {list(ASR_SWEEP)} whose p90 stays under 80 ms: "
          f"{largest}")
    return {"by_batch": out, "largest_real_time_batch": largest}


def asr_plain_witness(dev, models, ref, ref_words) -> dict:
    """The greedy run eagerly with the plain attention in the kernel's
    place.  The seeded random model's text stream turns on near-ties, so
    the kernel's rounding can move it: slot 0 must say words with the plain
    attention too, so the pad factors do not rest on one kernel's rounding;
    the frames up to the streams' first difference are printed (graphed or
    not changes no bit)."""
    from moshi_tpu_torch.modules import transformer
    from moshi_tpu_torch.ops.decode_attention import decode_attention_int8_plain

    transformer.decode_attention_int8 = decode_attention_int8_plain
    try:
        _, sessions, _, launches = asr_greedy(dev, models, False)
    finally:
        transformer.decode_attention_int8 = counters()["decode_attention_int8"]
    plain_ref, plain_words = sessions[0][0][0], words(sessions[0][0][1])
    same = next((i for i in range(FRAMES) if plain_ref[i] != ref[i]), FRAMES)
    phase("asr", f"the greedy run with decode_attention_int8_plain in the kernel's place, "
          f"eager: slot 0 says {len(plain_words)} Word / EndWord messages (with the kernel "
          f"{len(ref_words)}); its text tokens equal the kernel run's for the first {same} of "
          f"{FRAMES} frames")
    if any(launches.values()):
        raise RuntimeError(f"asr: the plain run launched kernels: {launches}")
    if not plain_words:
        raise RuntimeError("asr: with the plain attention slot 0 said no word, so the Word "
                           "check rests on the kernel's rounding")
    return {"words": len(plain_words), "same_tokens_frames": same}


def run_asr(dev, card: str) -> dict:
    """The batched STT path at B = ASR_SLOTS: the greedy run of asr_script
    graphed (the main path), then every slot sending; the same on an eager
    engine, the two held equal; the greedy run eagerly with the plain
    attention in the kernel's place; then the batch sweep, graphed."""
    models = build_asr(dev)
    cfg, B = models["lm"].config, ASR_SLOTS
    expected = {name: 0 for name in TPU_KERNELS}
    expected["decode_attention_int8"] = cfg.num_layers
    state, g = asr_runs(dev, models, True)
    eager, e = asr_runs(dev, models, False)
    ms, sessions = g["ms"], g["sessions"]
    check_counts(g["launches"], expected, 1, "asr greedy graphed run (the captured step)")
    check_counts(e["launches"], expected, len(e["ms"]), "asr greedy eager run")
    replays = {"encode": state.asr.encode.replays, "step": state.asr.step.replays}
    if replays != {"encode": len(ms) + 15, "step": len(ms) + 15}:
        raise RuntimeError(f"asr: replays {replays} for {len(ms)} + 15 frames")
    counted = check_asr_sessions(cfg, sessions, ms)
    u, r = ASR_RESUME["U"], ASR_RESUME["R"]
    rows_equal = g["resume"]["rows_equal"]
    resumed = g["resume"]["resumed"] and g["resume"]["clock"] == FRAMES
    same_tokens = all(len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
        for a, b in zip(sessions.values(), e["sessions"].values()))
    same_state = all(same_bytes(a, b) for a, b in zip(asr_leaves(state), asr_leaves(eager)))
    del state, eager
    p50, p75, p90 = (float(np.percentile(ms, p)) for p in (50, 75, 90))
    e50, e90 = (float(np.percentile(e["ms"], p)) for p in (50, 90))
    phase("asr", f"greedy, {len(ms)} frames x {B} slots graphed: slots 1 (same PCM), 2 (joined "
          f"5 frames late), 3 (frozen on frames 10-14), 4 (reset at frame 20) and {u} (paused on "
          f"ticks 15-16) repeat slot 0's text tokens and its {counted['ref_words']} Word / "
          f"EndWord messages, and so does the session that left slot {ASR_RESUME['S']} at "
          f"frame {ASR_RESUME['leave']} and resumed on slot {r} after a new tenant took slot "
          f"{ASR_RESUME['S']}; its device rows at the end "
          f"{'equal' if rows_equal else 'DIFFER from'} slot {u}'s, bit for bit; "
          f"{counted['distinct']} of {B - 8} other slots differ; messages by type "
          f"{counted['said']}; launches {g['launches']} = per step {expected} x 1 captured "
          f"step, replays {replays} (with 15 frames of every slot); eager launches "
          f"{e['launches']} = x {len(e['ms'])}; graphed against eager: text tokens and messages "
          f"{'equal' if same_tokens else 'DIFFER'}, every state byte after the same frames "
          f"{'equal' if same_state else 'DIFFERS'}")
    if not (rows_equal and resumed):
        raise RuntimeError("asr: the resumed session's rows or clock differ from the unbroken "
                           "slot's")
    if not (same_tokens and same_state):
        raise RuntimeError("asr: the graphed frames differ from the eager ones")
    phase("asr", f"greedy run: graphed p50 {p50:.2f} ms, p75 {p75:.2f} ms, p90 {p90:.2f} ms per "
          f"batched frame (the capture's frame included), {p50 / B:.4f} ms per stream at p50; "
          f"eager p50 {e50:.2f} ms, p90 {e90:.2f} ms ({card})")
    for kind, run in (("graphed", g), ("eager", e)):
        every = run["every_slot"]
        phase("asr", f"all {B} slots, 10 frames {kind}: p50 {every['p50_ms']:.2f} ms, p75 "
              f"{every['p75_ms']:.2f} ms, p90 {every['p90_ms']:.2f} ms per batched frame, "
              f"{every['p50_ms'] / B:.4f} ms per stream at p50, of it {every['host_ms_p50']:.2f} "
              f"ms of host Python in the per-slot input and word-tracker loops; peak "
              f"{run['peak_gib']:.2f} GiB allocated, {run['engine_peak_gib']:.2f} GiB of it "
              f"above what the card held before the engine; profiler over 5 frames: "
              f"{profile_line(every['profile'])} ({card})")
    witness = asr_plain_witness(dev, models, sessions[0][0][0], words(sessions[0][0][1]))
    sweep = asr_sweep(dev, models, card)
    del models
    free_memory()
    summary = {key: v for key, v in g.items() if key != "sessions"}
    summary.update({"per_frame": expected, "replays": replays, "p50_ms": p50, "p75_ms": p75,
                    "p90_ms": p90, "frames": len(ms),
                    "eager": {key: v for key, v in e.items() if key not in ("sessions", "ms")},
                    "sweep": sweep, "plain_witness": witness})
    summary["eager"].update({"p50_ms": e50, "p90_ms": e90})
    del summary["ms"]
    return summary


# -------------------------------------------------------------------- tts
class TtsTokenizer:
    """The JAX benchmark's host tokenizer stub (moshi_tpu/benchmark.py:352-354):
    one token per word."""

    def encode(self, word):
        return [7 + (len(word) % 13)]


def build_tts(dev):
    """tts_v0_1 at full width from a seed on the card: int8 weights on every
    linear the JAX package's `--weights int8` quantizes, the int4 KV cache
    at context TTS_CONTEXT, the bf16 Mimi v0.1 with 16 codebooks, a
    speaker_wavs tensor condition fused by cross and a `cfg` LUT condition
    fused by sum."""
    from moshi_tpu_torch.conditioners import (ConditionFuser, ConditionProvider,
                                              LUTConditioner, TensorConditioner)
    from moshi_tpu_torch.models.lm import LMModel, lm_config_tts_v0_1
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config
    from moshi_tpu_torch.utils.quantize import quantize_lm_params
    from moshi_tpu_torch.utils.serving import override_lm

    t0 = time.perf_counter()
    lm = override_lm(LMModel(lm_config_tts_v0_1()), kv_cache="int4", context=TTS_CONTEXT)
    cfg = lm.config
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    lm_params = quantize_lm_params(lm.init_params(g, torch.bfloat16, dev), mode="int8")
    free_memory()
    mimi = MimiModel(mimi_v0_1_config(cfg.dep_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    provider = ConditionProvider({
        "speaker_wavs": TensorConditioner(output_dim=cfg.dim, dim=TTS_VOICE[1]),
        "cfg": LUTConditioner(output_dim=cfg.dim, **TTS_CFG)})
    cp_params = provider.init_params(g, torch.float32, dev)
    torch.cuda.synchronize()
    tc = cfg.transformer_config
    phase("tts", f"tts_v0_1 int8 (dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} "
          f"heads x {tc.head_dim}, {cfg.kv_cache_dtype} KV at ctx {cfg.context}, text head "
          f"{cfg.text_out_card}, card {cfg.card}, depformer {cfg.dep_q} x "
          f"{cfg.depformer_num_layers} layers of {cfg.depformer_dim}) + Mimi bf16 with "
          f"{mimi.num_codebooks} codebooks built from seed {SEED + 11} in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          f"on the card")
    return {"lm": lm, "lm_params": lm_params, "mimi": mimi, "mimi_params": mimi_params,
            "provider": provider, "cp_params": cp_params,
            "fuser": ConditionFuser({"cross": ["speaker_wavs"], "sum": ["cfg"]})}


def tts_model(models, lm, temp: float):
    """TTSModel over `lm` and the models' Mimi and conditioners, the JAX
    benchmark's state machine and delays."""
    from moshi_tpu_torch.models.tts import StateMachine, TokenIds, TTSModel

    c = lm.config
    return TTSModel(lm, models["mimi"], TtsTokenizer(),
                    StateMachine(TokenIds(card=c.text_card + 1), max_padding=8,
                                 initial_padding=2),
                    delay_steps=TTS_DELAY_STEPS, condition_provider=models["provider"],
                    fuser=models["fuser"], max_speakers=TTS_MAX_SPEAKERS, temp=temp,
                    n_q=c.dep_q, max_gen_length=10_000, final_padding=4)


def tts_get_prefix(dev, models, card: str) -> dict:
    """TTSModel.get_prefix on TTS_PREFIX_SECONDS of seeded PCM through the
    TTS engine's Mimi (bf16, 16 codebooks): its audio rows must equal that
    Mimi's offline encode of the same PCM, its text row ZERO_TOKEN."""
    from moshi_tpu_torch.models.lm import ZERO_TOKEN

    mimi, params = models["mimi"], models["mimi_params"]
    tts = tts_model(models, models["lm"], 0.0)
    n_q = models["lm"].config.n_q
    wav = (0.1 * np.random.RandomState(SEED + 22).randn(
        TTS_PREFIX_SECONDS * mimi.config.sample_rate)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefix = tts.get_prefix(params, wav)
    ms = (time.perf_counter() - t0) * 1e3
    codes = mimi.encode(params, torch.from_numpy(wav).to(dev, torch.bfloat16)[None, None])
    ref = codes[0, :n_q, :-2].cpu().numpy()
    if not (prefix.shape == (1 + n_q, ref.shape[1]) and np.array_equal(prefix[1:], ref)
            and (prefix[0] == ZERO_TOKEN).all()):
        raise RuntimeError(f"get_prefix {prefix.shape} differs from Mimi's encode {ref.shape}")
    phase("tts", f"get_prefix of {TTS_PREFIX_SECONDS} s of PCM: {prefix.shape[1]} frames x "
          f"{n_q} codebooks + the ZERO_TOKEN text row, equal to Mimi's offline encode; "
          f"{ms:.2f} ms (the first call, from host PCM to host codes) ({card})")
    return {"ms": ms, "frames": int(prefix.shape[1])}


def tts_engine(dev, models, lm, temp: float, graphed: bool):
    """A warmed-up BatchedTTSState at B = TTS_SLOTS over `lm` (the models'
    weights), the JAX benchmark's state machine and delays."""
    from moshi_tpu_torch.serve.batched_tts import BatchedTTSState

    tts = tts_model(models, lm, temp)
    state = BatchedTTSState(tts, models["lm_params"], models["mimi_params"], TTS_SLOTS,
                            condition_params=models["cp_params"], voice_frames=TTS_VOICE[0],
                            device=dev, graphed=graphed, rng_seed=SEED)
    if state.graphed != graphed:
        raise RuntimeError(f"BatchedTTSState on the card: graphed {state.graphed}")
    state.warmup()
    torch.cuda.synchronize()
    return state


def tts_launches(cfg, params, batch: int) -> dict:
    """Kernel launches of one TTS frame at B = batch, by graph: "main" (graph
    1 with the cross block: each temporal linear per layer, the cross q and
    out projections per layer, the text head, and one K4 (int4 KV, each
    writing its layer's column) or K6 (int8 KV) per layer), "main_plain"
    (the same without the cross block, while no slot has a voice) and
    "depth" (graph 2: each depformer linear per layer and step,
    depformer_in and the audio head per step); each linear on the kernel
    qmatmul.use_mma picks for bf16 x of `batch` rows; no q4."""
    from moshi_tpu_torch.ops import qmatmul
    from moshi_tpu_torch.utils.quantize import QTensor

    tl, dl = params["transformer"]["layers"], params["depformer"]["layers"]
    temporal = [tl["attn"]["in_proj"], tl["attn"]["out_proj"], tl["mlp"]["linear1"],
                tl["mlp"]["linear2"]]
    cross = [tl["cross_attn"]["q_proj"], tl["cross_attn"]["out_proj"]]
    dep = [dl["attn"]["in_proj"], dl["attn"]["out_proj"], dl["mlp"]["linear_in"],
           dl["mlp"]["linear_out"]]
    head = [(params["text_linear"]["weight"], 1)]
    graphs = {"main": [(w, cfg.num_layers) for w in temporal + cross] + head,
              "main_plain": [(w, cfg.num_layers) for w in temporal] + head,
              "depth": [(w, cfg.depformer_num_layers * cfg.dep_q) for w in dep]
              + [(params["depformer_in"]["weight"], cfg.dep_q),
                 (params["linears"]["weight"], cfg.dep_q)]}
    out, shapes = {}, {}
    for name, ws in graphs.items():
        per = dict.fromkeys(TPU_KERNELS, 0)
        for w, n in ws:
            if not isinstance(w, QTensor):
                raise RuntimeError("the tts tree is not int8 on every linear")
            din, dout = w.q.shape[-2:]
            per["int8_mma" if qmatmul.use_mma(batch, torch.bfloat16, din, dout)
                else "int8_gemv"] += n
            if name != "main_plain":
                shapes[(din, dout)] = shapes.get((din, dout), 0) + n
        if name != "depth":
            kv = cfg.kv_cache_dtype
            per["decode_attention_int4"] = per["cache_write_int4"] = (
                cfg.num_layers if kv == "int4" else 0)
            per["decode_attention_int8"] = cfg.num_layers if kv == "int8" else 0
        out[name] = per
    if shapes != TTS_INT8_SHAPES:
        raise RuntimeError(f"the TTS frame's linears {shapes} are not TTS_INT8_SHAPES")
    return out


def tts_words(n: int, salt: int) -> list[str]:
    """n words of a seeded vocabulary, different for each salt."""
    vocab = ("the quick brown fox jumps over a lazy dog while seven wizards quietly hex "
             "one jolly zebra near old stone bridges under bright winter skies").split()
    rs = np.random.RandomState(SEED + 100 + salt)
    return [vocab[i] for i in rs.randint(0, len(vocab), n)]


# the tts isolation run: slot -> (its session index, frames it executes in
# that session) of the copies of slot 0's session
TTS_SAME_AS_0 = {1: (0, TTS_FRAMES - 2), 2: (0, TTS_FRAMES - 7), 3: (0, TTS_FRAMES - 7),
                 4: (1, TTS_FRAMES - 22)}
TTS_ROLES = {"voiceless": 6, "voice_change": 5, "starved": 3, "starved_ticks": 5}


def tts_isolation_schedule():
    """serve_tts's script at B = TTS_SLOTS over TTS_FRAMES ticks: slot 6
    alone and voiceless on ticks 0-1 (the unconditioned mode), then slots 0
    and 1 with one script and voice A, slot 2 with them joining 5 ticks late,
    slot 3 with them starved of its last words for 5 ticks, slot 4 reset at
    tick 22 to them, slot 5 changing its voice at tick 20, slots 7.. with
    scripts and voices of their own."""
    rs = np.random.RandomState(SEED + 12)
    voice = [rs.randn(*TTS_VOICE).astype(np.float32) for _ in range(TTS_SLOTS + 2)]
    script = tts_words(12, 0)
    ref = [("join", voice[0]), ("words", [" ".join(script)]), "eos"]
    sched = [{} for _ in range(TTS_FRAMES)]
    sched[0] = {6: [("join", None), ("words", tts_words(12, 6))]}
    sched[2] = {0: ref, 1: ref,
                3: [("join", voice[0]), ("words", script[:2]),
                    ("refill", TTS_ROLES["starved_ticks"], script[2:], True)],
                4: [("join", voice[4]), ("words", tts_words(12, 4))],
                5: [("join", voice[5]), ("words", tts_words(12, 5))],
                **{s: [("join", voice[s]), ("words", tts_words(12, s))]
                   for s in range(7, TTS_SLOTS)}}
    sched[7] = {2: ref}
    sched[20] = {5: [("voice", voice[TTS_SLOTS])]}
    sched[22] = {4: ref}
    return sched


def tts_leaves(state) -> list:
    """Every tensor of a BatchedTTSState's streaming state: LMGen's (the
    caches, the cross K/V) and Mimi's decoder, and the summed condition."""
    return tensor_leaves([state.gen_state_cross, state.dec_state, state.cond_sum])


def check_tts_frames(tokens, cfg, what: str) -> None:
    """Output frames past the delays: text ids in [0, text_card], audio ids
    in [0, card) or the zero token of a codebook still within its delay."""
    gen = tokens[(tokens != -2).all(axis=1)]
    if not ((gen[:, 0] >= 0).all() and (gen[:, 0] <= cfg.text_card).all()
            and (gen[:, 1:] >= -1).all() and (gen[:, 1:] < cfg.card).all()):
        raise RuntimeError(f"{what}: token out of range")


def slowest_ticks(ms: list, n: int = 5) -> dict:
    """{tick: ms} of the n slowest ticks of a run."""
    return {int(i): round(ms[i], 2) for i in np.argsort(ms)[::-1][:n]}


def tts_greedy(dev, models, lm, what: str, profile: bool = False) -> tuple[dict, dict]:
    """The greedy isolation run of BatchedTTSState (tts_isolation_schedule),
    graphed (the main path: launch counts from the captures, replays), then
    eagerly (launches per frame), the two held equal in output frames, Text
    events, PCM and every state byte; the copies of slot 0's session must
    repeat it, the starved slot must sit out exactly its ticks.  With
    `profile`, then 5 frames of every slot on each engine and 5 graphed ones
    under the profiler.  Returns the graphed launches and a summary."""
    from moshi_tpu_torch.serve.batched_tts import serve_tts

    cfg = lm.config
    per = tts_launches(cfg, models["lm_params"], TTS_SLOTS)
    per_frame = {k: per["main"][k] + per["depth"][k] for k in per["main"]}
    schedule = tts_isolation_schedule()
    runs = {}
    for graphed in (True, False):
        state = tts_engine(dev, models, lm, 0.0, graphed)
        if graphed:
            kv = state.gen_state_cross["transformer"]
            phase("tts", f"{what}: B = {TTS_SLOTS}, {cfg.kv_cache_dtype} KV cache "
                  f"{tuple(kv['k'].shape)}, cross K/V {tuple(kv['k_cross'].shape)} "
                  f"{str(kv['k_cross'].dtype)[6:]} x 2; "
                  f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card")
            del kv
        ptrs = [t.data_ptr() for t in tts_leaves(state)]
        zero_counts()
        sessions, ticks = serve_tts(state, schedule)
        launches = read_counts()
        if [t.data_ptr() for t in tts_leaves(state)] != ptrs:
            raise RuntimeError(f"{what}: a reset or a voice change moved a state tensor")
        runs["graphed" if graphed else "eager"] = (state, sessions, ticks, launches)
    state, sessions, ticks, launches = runs["graphed"]
    eager, e_sessions, e_ticks, e_launches = runs["eager"]
    n = len(ticks)
    replays = {"main_unconditioned": state.main[False].replays,
               "main_conditioned": state.main[True].replays, "depth": state.depth.replays}
    if n != TTS_FRAMES or replays != {"main_unconditioned": 2, "main_conditioned": n - 2,
                                      "depth": n}:
        raise RuntimeError(f"{what}: {n} frames, replays {replays}")
    check_counts(launches, {k: sum(v[k] for v in per.values()) for k in per_frame}, 1,
                 f"tts {what} graphed run (graph 1 captured with and without the cross "
                 f"block, graph 2 once)")
    check_counts(e_launches, {k: 2 * per["main_plain"][k] + (n - 2) * per["main"][k]
                              + n * per["depth"][k] for k in per_frame}, 1,
                 f"tts {what} eager run")
    masks = np.stack([m for m, _ in ticks])
    starved = TTS_ROLES["starved"]
    frozen = np.nonzero(~masks[3:, starved])[0]
    if len(frozen) != TTS_ROLES["starved_ticks"] or np.any(np.diff(frozen) != 1):
        raise RuntimeError(f"{what}: the starved slot sat out ticks {frozen + 3}")
    ref = sessions[0][0]
    for s in range(TTS_SLOTS):
        for sess in sessions[s]:
            check_tts_frames(sess["tokens"], cfg, f"{what} slot {s}")
            check_pcm(sess["pcm"], models["mimi"].frame_size, f"{what} slot {s}")
    if len(ref["tokens"]) != TTS_FRAMES - 2 or not ref["events"] or not ref["pcm"]:
        raise RuntimeError(f"{what}: slot 0 ran {len(ref['tokens'])} frames, "
                           f"{len(ref['events'])} Text events, {len(ref['pcm'])} PCM frames")
    for s, (i, executed) in TTS_SAME_AS_0.items():
        got = sessions[s][i]
        if (len(got["tokens"]) != executed
                or not np.array_equal(got["tokens"], ref["tokens"][:executed])
                or got["events"] != ref["events"][:len(got["events"])]
                or (executed == len(ref["tokens"]) and got["events"] != ref["events"])):
            raise RuntimeError(f"{what}: slot {s} session {i} does not repeat slot 0's frames "
                               f"and Text events")
    distinct = sum(not np.array_equal(sessions[s][0]["tokens"], ref["tokens"])
                   for s in range(7, TTS_SLOTS))
    if distinct == 0:
        raise RuntimeError(f"{what}: no slot with its own script and voice differs from slot 0")
    same = all(len(a) == len(b) and all(
        np.array_equal(x["tokens"], y["tokens"]) and x["events"] == y["events"]
        and x["eos"] == y["eos"] and len(x["pcm"]) == len(y["pcm"])
        and all(np.array_equal(p, q) for p, q in zip(x["pcm"], y["pcm"]))
        for x, y in zip(a, b)) for a, b in zip(sessions.values(), e_sessions.values()))
    same_state = all(same_bytes(a, b) for a, b in zip(tts_leaves(state), tts_leaves(eager)))
    ms = [t for _, t in ticks]
    p50, p90 = (float(np.percentile(ms, p)) for p in (50, 90))
    e_ms = [t for _, t in e_ticks]
    e50, e90 = (float(np.percentile(e_ms, p)) for p in (50, 90))
    events = sum(len(x["events"]) for v in sessions.values() for x in v)
    pcm = sum(len(x["pcm"]) for v in sessions.values() for x in v)
    phase("tts", f"{what}, {n} frames graphed: slots 1 (same script and voice), 2 (joined 5 "
          f"ticks late), 3 (starved on ticks {(frozen + 3).tolist()}) and 4 (reset at tick 22) "
          f"repeat slot 0's frames and Text events; {distinct} of {TTS_SLOTS - 7} other slots "
          f"differ; slot 5 changed its voice at tick 20, slot 6 has none; {events} Text events, "
          f"{pcm} PCM frames; launches {launches} = graph 1 {per['main']} (captured with the "
          f"cross block) + {per['main_plain']} (without) + graph 2 {per['depth']}; replays "
          f"{replays}; p50 {p50:.2f} ms, p90 {p90:.2f} ms per batched frame, the slowest "
          f"ticks {slowest_ticks(ms)} (eager: p50 {e50:.2f}, p90 {e90:.2f}, the slowest "
          f"{slowest_ticks(e_ms)}; launches {e_launches} over {len(e_ticks)} frames, 2 "
          f"without the cross block); graphed against "
          f"eager: frames, events and PCM {'equal' if same else 'DIFFER'}, every state byte "
          f"{'equal' if same_state else 'DIFFERS'}")
    if not (same and same_state):
        raise RuntimeError(f"{what}: the graphed frames differ from the eager ones")
    summary = {"p50_ms": p50, "p90_ms": p90, "max_ms": max(ms), "ms": ms, "replays": replays,
               "frames": n, "text_events": events, "pcm_frames": pcm,
               "eager": {"p50_ms": e50, "p90_ms": e90, "max_ms": max(e_ms),
                         "launches": e_launches}}
    if profile:
        g_all = tts_every_slot(state, 5, SEED + 13)
        e_all = tts_every_slot(eager, 5, SEED + 13)
        prof = profile_frames(g_all["run_frame"], 5)
        prof.update({f"p{p}_ms": float(np.percentile(g_all["ms"], p)) for p in (50, 90)})
        prof.update({f"eager_p{p}_ms": float(np.percentile(e_all["ms"], p)) for p in (50, 90)})
        prof.update(max_ms=max(g_all["ms"]), eager_max_ms=max(e_all["ms"]),
                    parts=g_all["parts"], eager_parts=e_all["parts"])
        prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / prof["p50_ms"]
        # what a frame pays when the cycle collector sweeps every generation
        t0 = time.perf_counter()
        gc.collect()
        prof["gc_full_ms"] = (time.perf_counter() - t0) * 1e3
        prof["gc_objects"] = len(gc.get_objects())
        phase("tts", f"{what}: one full pass of the cycle collector here {prof['gc_full_ms']:.2f} "
              f"ms over {prof['gc_objects']} tracked objects")
        phase("tts", f"{what}, every slot, 5 frames: graphed p50 {prof['p50_ms']:.2f} ms, p90 "
              f"{prof['p90_ms']:.2f} ms, {slowest_frame(g_all)} per batched frame (eager p50 "
              f"{prof['eager_p50_ms']:.2f}, p90 {prof['eager_p90_ms']:.2f}, "
              f"{slowest_frame(e_all)}); profiler over 5 graphed frames: {profile_line(prof)}")
        summary["profile"] = prof
    del runs, state, eager, sessions, e_sessions
    free_memory()
    return launches, summary


class GraphClock:
    """Wraps an engine's GraphedStep: CUDA events around each call, so a
    frame's card ms of the graph (its launch to its end on the stream) can
    be read after the frame."""

    def __init__(self, step):
        self.step, self.events = step, []

    def __call__(self, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step(*args)
        end.record()
        self.events.append((start, end))
        return out

    def take_ms(self) -> float:
        """Card ms of the calls since the last take (their ends are read)."""
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms


def tts_every_slot(state, frames: int, seed: int) -> dict:
    """Every slot of `state` opened with a voice of its own (the resets and
    the voices' conditions applied before any timing) and fed words as the
    JAX benchmark feeds them (a sentence whenever fewer than 4 words wait),
    then `frames` ticks, each timed on the host from its inputs to its
    outputs read back, with its parts: the engine's host ms of its queued
    ops, of each graph up to its outputs read back and of the state
    machines, and the rest of the frame (feeding words, clearing the
    outboxes); the card ms of each graph (CUDA events); the ms of the cycle
    collector's passes in the frame and the oldest generation they swept
    (-1: none).  Returns {"ms", "host_ms", "parts",
    "run_frame", "voices_ms"}: parts holds one dict per frame; run_frame(i)
    runs one more tick; voices_ms is the host ms of opening the slots with
    their voices."""
    rs = np.random.RandomState(seed)
    for s in range(TTS_SLOTS):
        if state.slots[s] is not None:
            state.release_slot(s)
        state.acquire_slot(s)
        state.set_slot_voice(s, rs.randn(*TTS_VOICE).astype(np.float32))
    # the joins and voices (one recompute of every slot's conditions and
    # cross K/V), timed on their own and finished before the timed ticks
    t0 = time.perf_counter()
    state.apply_pending_ops()
    torch.cuda.synchronize()
    voices_ms = (time.perf_counter() - t0) * 1e3

    def run_frame(i):
        for s in range(TTS_SLOTS):
            if len(state.slots[s].state.entries) < 4:
                state.feed_words(s, ["hello world how are you today friend"])
        if state.tick() is None:
            raise RuntimeError("tts: no slot ran")
        for s in range(TTS_SLOTS):
            state.slots[s].outbox.clear()

    gc_ms, gc_t0, gc_gen = [0.0], [0.0], [-1]

    def gc_clock(event, info):
        if event == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3
            gc_gen[0] = max(gc_gen[0], info["generation"])
    steps = {"main": state.main[True], "depth": state.depth}
    clocks = {k: GraphClock(v) for k, v in steps.items()}
    state.main[True], state.depth = clocks["main"], clocks["depth"]
    gc.callbacks.append(gc_clock)
    ms, parts = [], []
    try:
        for i in range(frames):
            gc_ms[0], gc_gen[0] = 0.0, -1
            t0 = time.perf_counter()
            run_frame(i)
            ms.append((time.perf_counter() - t0) * 1e3)
            parts.append({**{f"{k}_host_ms": v for k, v in state.frame_ms.items()},
                          "other_host_ms": ms[-1] - sum(state.frame_ms.values()),
                          **{f"{k}_card_ms": c.take_ms() for k, c in clocks.items()},
                          "gc_ms": gc_ms[0], "gc_generation": gc_gen[0]})
    finally:
        gc.callbacks.remove(gc_clock)
        state.main[True], state.depth = steps["main"], steps["depth"]
    return {"ms": ms, "host_ms": [p["machines_host_ms"] for p in parts], "parts": parts,
            "run_frame": run_frame, "voices_ms": voices_ms}


def slowest_frame(r: dict) -> str:
    """The slowest frame of a tts_every_slot run and its parts."""
    i = int(np.argmax(r["ms"]))
    return (f"max {r['ms'][i]:.2f} ms (frame {i} of {len(r['ms'])}: "
            + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in r["parts"][i].items()) + ")")


def run_tts(dev, card: str) -> dict:
    """The batched TTS path at B = TTS_SLOTS: the greedy isolation run with
    the int4 KV cache, graphed and eager; a sampled run of every slot, 40
    graphed frames and 10 eager ones, with a profiler pass; then the greedy
    run with the int8 KV cache and 5 frames of every slot."""
    from dataclasses import replace

    from moshi_tpu_torch.models.lm import LMModel

    models = build_tts(dev)
    lm = models["lm"]
    per = tts_launches(lm.config, models["lm_params"], TTS_SLOTS)
    per_frame = {k: per["main"][k] + per["depth"][k] for k in per["main"]}
    if any(per_frame[k] for k in ("q4_gemv", "q4_mma", "q4_wgmma")):
        raise RuntimeError("the tts frame would run a q4 kernel")
    prefix = tts_get_prefix(dev, models, card)
    greedy_launches, greedy = tts_greedy(dev, models, lm, "greedy")

    runs = {}
    for graphed, n in ((True, FRAMES), (False, EAGER_FRAMES)):
        free_memory()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state = tts_engine(dev, models, lm, TTS_TEMP, graphed)
        zero_counts()
        r = tts_every_slot(state, n, SEED + 14)
        launches = read_counts()
        kind = "graphed" if graphed else "eager"
        check_counts(launches, per_frame, 1 if graphed else n, f"tts sampled {kind} run")
        run = {"launches": launches, "frames": n,
               **{f"p{p}_ms": float(np.percentile(r["ms"], p)) for p in (50, 75, 90)},
               "max_ms": max(r["ms"]), "slowest": slowest_frame(r), "parts": r["parts"],
               "host_ms_p50": float(np.percentile(r["host_ms"], 50)),
               "voices_ms": r["voices_ms"],
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "engine_peak_gib": (torch.cuda.max_memory_allocated(dev) - before) / 2 ** 30}
        if graphed:
            run["replays"] = {"main": state.main[True].replays, "depth": state.depth.replays}
            if run["replays"] != {"main": n, "depth": n}:
                raise RuntimeError(f"tts sampled: replays {run['replays']} for {n} frames")
            prof = profile_frames(r["run_frame"], 5)
            prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / run["p50_ms"]
            run["profile"] = prof
        for s in range(TTS_SLOTS):
            if state.slots[s].state.transcript == []:
                raise RuntimeError(f"tts sampled {kind}: slot {s} said no word")
        runs[kind] = run
        del state
    g, e = runs["graphed"], runs["eager"]
    phase("tts", f"sampled (temp {TTS_TEMP}), {g['frames']} frames x {TTS_SLOTS} slots graphed: "
          f"p50 {g['p50_ms']:.2f} ms, p75 {g['p75_ms']:.2f} ms, p90 {g['p90_ms']:.2f} ms, "
          f"{g['slowest']} per batched frame, {g['p50_ms'] / TTS_SLOTS:.3f} ms per stream "
          f"at p50, of it "
          f"{g['host_ms_p50']:.3f} ms of host Python in the DSM machines (opening the "
          f"{TTS_SLOTS} slots with their voices, one recompute of every slot's conditions "
          f"and cross K/V: {g['voices_ms']:.1f} ms); peak "
          f"{g['peak_gib']:.2f} GiB allocated, {g['engine_peak_gib']:.2f} GiB of it above what "
          f"the card held before the engine; launches {g['launches']} (1 captured frame), "
          f"replays {g['replays']} ({card})")
    phase("tts", f"sampled, {e['frames']} frames x {TTS_SLOTS} slots eager: p50 "
          f"{e['p50_ms']:.2f} ms, p90 {e['p90_ms']:.2f} ms, {e['slowest']} per batched "
          f"frame; peak {e['peak_gib']:.2f} GiB; launches {e['launches']} ({card})")
    phase("tts", f"profiler over 5 graphed sampled frames: {profile_line(g['profile'])}")

    lm8 = LMModel(replace(lm.config, kv_cache_dtype="int8"))
    int8_launches, int8 = tts_greedy(dev, models, lm8, "int8 greedy", profile=True)
    del models
    free_memory()
    return {"launches": {"tts_greedy": greedy_launches, "tts_sampled": g["launches"],
                         "tts_int8_greedy": int8_launches},
            "per_frame": {"tts": per_frame,
                          "tts_int8": {**per_frame, "decode_attention_int4": 0,
                                       "cache_write_int4": 0,
                                       "decode_attention_int8": lm8.config.num_layers}},
            "sampled": g, "sampled_eager": e, "greedy": greedy, "int8_greedy": int8,
            "get_prefix": prefix}


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
        if spills:
            raise RuntimeError(f"{name} spills registers")

    g = torch.Generator(device=dev).manual_seed(SEED)
    gemvs = check_gemvs(dev, g)
    attn = check_attention(dev, g)
    write = check_fused_write(dev, g)
    # K4's row: the launch of the main path, the write included
    attn["per_launch"] = {**attn["per_launch"], **write["k4_per_launch"]}
    attn8 = check_attention_int8(dev, g)
    tts_gemvs = check_tts_gemvs(dev, g)
    offline_q4 = check_offline_q4(dev, g)
    free_memory()

    lm, lm_params, mimi, mimi_params = build_models(dev)
    slice_ = run_slice(dev, card, lm, lm_params, mimi, mimi_params)
    free_memory()
    batched = run_batched(dev, card, lm_params, mimi, mimi_params)
    free_memory()
    offline = run_offline(dev, card, lm, lm_params, mimi, mimi_params)
    del lm, lm_params, mimi, mimi_params
    free_memory()
    asr = run_asr(dev, card)
    free_memory()
    tts = run_tts(dev, card)

    # the main paths' runs, all graphed: their launches counted at capture
    # (the offline forward is not graphed: its launches are one eager call's)
    by_path = {"slice_b1": slice_["launches"],
               **{f"batched_{p}": v for p, v in batched["launches"].items()},
               "offline_forward": offline["launches"],
               "asr": asr["launches"], **tts["launches"]}
    per_frame_by_path = {"batched": batched["per_frame"]["int4"],
                         "batched_int8": batched["per_frame"]["int8"],
                         "offline_forward": offline["launches"], "asr": asr["per_frame"],
                         **tts["per_frame"]}
    kernels = []
    # ms / plain_ms / library_ms / bound_ms: card time of one frame's
    # launches of the kernel (bf16, operands cold in L2) on the path it
    # runs, from the per-shape (GEMVs) or per-launch times: the B = 1 frame
    # for the q4_gemv kernel, a B = 16 batched frame for q4_mma, int8_mma,
    # decode_attention_int4 (the fused launch) and cache_write_int4 (the
    # fused launch's time over the attention alone), a B = 256 ASR frame for
    # decode_attention_int8, one offline forward (M = 256) for q4_wgmma
    # (int8_gemv: Moshi's depformer linears at B = 16,
    # as int8_mma, though only the TTS heads launch it on a path);
    # "per_frame_by_batch" has the GEMVs' Moshi frames at each batch timed,
    # "tts" / "tts_per_frame" the TTS frame's launches
    for k in gemvs:
        main_b = 1 if k["name"] == "q4_gemv" else SLOTS
        row = {**k["per_frame"][main_b], "per_frame_by_batch": k["per_frame"],
               **{key: v for key, v in k.items() if key != "per_frame"}}
        if k["name"] in tts_gemvs:
            row["tts"] = tts_gemvs[k["name"]]
        kernels.append(row)
    # q4_wgmma: the offline forward's launches at M = 256 (OFFLINE_LM's
    # B * T), the other row counts timed and the crossover beside them
    kernels.append({"name": "q4_wgmma", **offline_q4["per_forward"][256],
                    "per_forward_by_rows": offline_q4["per_forward"],
                    **{key: v for key, v in offline_q4.items() if key != "per_forward"}})
    tts_per_launch = {"decode_attention_int4": write["tts_k4_per_launch"],
                      "cache_write_int4": write["tts_per_launch"],
                      "decode_attention_int8": attn8["per_launch_by_shape"]["tts"]}
    for name, k, path in (("decode_attention_int4", attn, "batched"),
                          ("cache_write_int4", write, "batched"),
                          ("decode_attention_int8", attn8, "asr")):
        n = per_frame_by_path[path][name]
        n_tts = per_frame_by_path["tts" if name != "decode_attention_int8" else "tts_int8"][name]
        kernels.append({"name": name, **{key: v * n for key, v in k["per_launch"].items()},
                        **k, "tts_per_frame": {key: v * n_tts for key, v
                                               in tts_per_launch[name].items()}})
    for k in kernels:
        name = k["name"]
        if name == "cache_write_int4":
            k["runs_in"] = "decode_attention_int4's launch"
        k.update({"route": "cuda", "source": SOURCES[name], "replaces": TPU_KERNELS[name],
                  "launches": sum(v[name] for v in by_path.values()),
                  "launches_by_path": {p: v[name] for p, v in by_path.items()},
                  "launches_per_frame": {p: v[name] for p, v in per_frame_by_path.items()}})
    print(json.dumps({"kernels": kernels, "slice": slice_,
                      "batched": {key: batched[key] for key in ("sampled", "sampled_eager",
                                                                "greedy", "int8_greedy")},
                      "offline": {key: v for key, v in offline.items() if key != "launches"},
                      "asr": {key: v for key, v in asr.items()
                              if key not in ("launches", "per_frame")},
                      "tts": {key: v for key, v in tts.items()
                              if key not in ("launches", "per_frame")}}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
