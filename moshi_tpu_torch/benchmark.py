"""Real-time-paced benchmark harness with per-step JSON event logging
(counterpart of moshi_tpu/benchmark.py).

Behavioral reference: `rust/moshi-backend/src/benchmark.rs:57-139` — feeds
zero frames paced at the 80 ms frame interval and records timestamped
per-step events to a JSON file (StepStart / StepPostSampling equivalents),
plus a `--mimi-only` mode; and the streaming engines' own frames: batched
speech-to-text (`--mode asr`), text-to-speech (`--mode tts`, batched above
`--batch 1`).  Each mode prints one JSON line, with the JAX package's keys.

The models are built at the published widths from a seed: `init_params`
from a generator seeded 0 (the JAX package fills `eval_shape`'s shapes with
zeros, which torch cannot do without allocating them, and seeds its states
with PRNGKey(0)).  The card does the same work on either, and seeded
weights keep the codec and the state machines on their live paths.  The
device steps run as CUDA graphs on a card (the counterparts of the JAX
package's jitted programs), eagerly on the CPU.

Usage:
  python -m moshi_tpu_torch.benchmark --model moshi_2b --steps 100 --out events.json
  python -m moshi_tpu_torch.benchmark --mimi-only
  python -m moshi_tpu_torch.benchmark --mode asr --batch 64 --kv-cache int8
"""

import argparse
import json
import time

import numpy as np
import torch

from .utils.graphs import GraphedStep

SEED = 0


def _generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _dump(out_path: str | None, summary: dict, events: list) -> None:
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"summary": summary, "events": events}, f)


# ------------------------------------------------------------------ models
def build_lm(name: str, device="cuda"):
    """`moshi_7b` or `moshi_2b` (the JAX package's bench.py builders), bf16,
    with an `_int8` / `_int4` suffix quantized by quantize_lm_params (int4:
    q4 temporal linears, an int8 depformer)."""
    from .models.lm import LmConfig, LMModel, lm_config_v0_1
    from .utils.quantize import quantize_lm_params

    quant_mode = None
    for suffix in ("_int8", "_int4"):
        if name.endswith(suffix):
            quant_mode = suffix[1:]
            name = name.removesuffix(suffix)
    if name == "moshi_7b":
        config = lm_config_v0_1()
    elif name == "moshi_2b":
        config = LmConfig(
            dim=2560, text_card=48000, n_q=32, dep_q=16, card=2048, num_heads=20,
            num_layers=24, hidden_scale=4.125, context=3000, max_period=100000.0,
            gating="silu", norm="rms_norm_f32", positional_embedding="rope",
            depformer_dim=1024, depformer_dim_feedforward=4224,
            depformer_num_heads=16, depformer_num_layers=6,
            delays=tuple([0, 0] + [2] * 15 + [0] + [2] * 15))
    else:
        raise ValueError(name)
    model = LMModel(config)
    params = model.init_params(_generator(device), torch.bfloat16, device)
    if quant_mode is not None:
        params = quantize_lm_params(params, mode=quant_mode)
    return model, params


def build_mimi(num_codebooks: int, dtype=torch.float32, device="cuda"):
    from .models.mimi import MimiModel, mimi_v0_1_config

    model = MimiModel(mimi_v0_1_config(num_codebooks=num_codebooks))
    return model, model.init_params(_generator(device), dtype, device)


def _preset_lm(name: str, dtype=torch.bfloat16, quantize: str | None = None, device="cuda"):
    from .models.lm import LMModel
    from .models.loaders import LM_PRESETS
    from .utils.quantize import quantize_lm_params

    model = LMModel(LM_PRESETS[name]())
    params = model.init_params(_generator(device), dtype, device)
    if quantize:
        params = quantize_lm_params(params, mode=quantize)
    return model, params


# -------------------------------------------------------------- full duplex
def bench_paced(lm_name: str, steps: int, out_path: str | None,
                paced: bool = True, device="cuda") -> dict:
    """Mimi encode, LMGen.step and Mimi decode at B = 1, each a step of its
    own (three CUDA graphs on a card) over static PCM and code buffers,
    paced at the frame interval; 5 warm-up steps are not recorded (the
    first runs each step eagerly, the second captures it)."""
    from .models.lm_gen import LMGen, LMGenConfig

    lm, lm_params = build_lm(lm_name, device)
    c = lm.config
    n_in = c.num_codebooks - c.dep_q - 1
    mimi, mimi_params = build_mimi(max(c.dep_q, n_in), device=device)
    gen = LMGen(lm, LMGenConfig())
    graphed = torch.device(device).type == "cuda"

    fs = mimi.frame_size
    frame_interval = fs / mimi.config.sample_rate  # 0.080 s

    enc_state = mimi.init_encode_state(1, torch.float32, device)
    dec_state = mimi.init_decode_state(1, torch.float32, device)
    gen_state = gen.init_state(1, _generator(device), torch.bfloat16, device)
    pcm = torch.zeros((1, 1, fs), dtype=torch.float32, device=device)

    def encode(x):
        return mimi.encode_step(mimi_params, enc_state, x)[0][:, :n_in]

    def lm_step(codes):
        return gen.step(lm_params, gen_state, codes)[0]

    def decode(out):
        audio = out[:, 1:1 + mimi.num_codebooks].clamp(min=0)
        return mimi.decode_step(mimi_params, dec_state, audio)[0]

    enc = GraphedStep(encode, graphed=graphed, device=device)
    step = GraphedStep(lm_step, graphed=graphed, device=device,
                       generators=(gen_state["generator"],))
    dec = GraphedStep(decode, graphed=graphed, device=device)

    events = []
    t_start = time.perf_counter()
    for i in range(steps + 5):
        if paced:
            target = t_start + i * frame_interval
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
        e = {"event": "step_start", "step": i, "ts": time.perf_counter() - t_start}
        codes = enc.warm_or_call(pcm)
        e["post_encode"] = time.perf_counter() - t_start
        out = step.warm_or_call(codes)
        _sync(device)
        e["post_sampling"] = time.perf_counter() - t_start
        dec.warm_or_call(out)
        _sync(device)
        e["post_decode"] = time.perf_counter() - t_start
        if i >= 5:  # skip warmup
            events.append(e)

    durations = sorted(e["post_decode"] - e["ts"] for e in events)
    summary = {
        "model": lm_name,
        "steps": len(events),
        "frame_interval_ms": frame_interval * 1000,
        "p50_ms": durations[len(durations) // 2] * 1000,
        "p90_ms": durations[int(len(durations) * 0.9)] * 1000,
        "max_ms": durations[-1] * 1000,
        "realtime": durations[int(len(durations) * 0.9)] < frame_interval,
    }
    _dump(out_path, summary, events)
    return summary


# ---------------------------------------------------------------------- asr
def bench_asr(model_name: str = "asr_300m_202501", batch: int = 8,
              steps: int = 50, out_path: str | None = None,
              kv_cache: str | None = None,
              context: int | None = None,
              weights: str | None = None,
              mimi_dtype=torch.float32, device="cuda") -> dict:
    """Batched streaming-ASR step benchmark: StreamingASR.step_pcm (Mimi
    encode, the host's delayed feeding, the temporal step, the word
    trackers), the round trip that serve/batched_asr.py pays per 80 ms
    frame, after the engine's warm-up.  device_only_ms chains the engine's
    two steps (two CUDA graphs on a card) over fixed inputs with one final
    sync.  The summary's `mimi_chunks` is 1: the JAX package's split of
    the encoder works round XLA's rematerialization and is not ported
    (models/asr.py)."""
    from .models.asr import StreamingASR
    from .utils.serving import override_lm

    lm, lm_params = _preset_lm(model_name, quantize=weights, device=device)
    lm = override_lm(lm, kv_cache, context)
    mimi, mimi_params = build_mimi(min(lm.config.n_q, 32), mimi_dtype, device)
    asr = StreamingASR(mimi, lm, batch, asr_delay_in_tokens=6, temperature=0.0,
                       mimi_dtype=mimi_dtype, device=device, rng_seed=SEED)
    state = asr.warmup(mimi_params, lm_params, asr.init_state())
    fs = mimi.frame_size
    rs = np.random.RandomState(0)

    events = []
    for i in range(steps + 5):
        pcm = (rs.randn(batch, 1, fs) * 0.05).astype(np.float32)
        t0 = time.perf_counter()
        msgs, state = asr.step_pcm(mimi_params, lm_params, state, pcm,
                                   exec_mask=np.ones((batch,), bool))
        dt = time.perf_counter() - t0
        if i >= 5:
            events.append({"event": "asr_step", "step": i, "ms": dt * 1000,
                           "n_msgs": len(msgs)})
    # device-only share: the engine's two steps chained over fixed inputs
    # (zero PCM, zero tokens, every slot), one final sync; the difference
    # from the full step is the host's part of the round trip
    asr.pcm_in.zero_()
    asr.tokens_in.zero_()
    asr.mask_in.fill_(True)
    mask = asr.mask_in if asr.graphed else None

    def device_step():
        asr.encode(mimi_params, state["mimi"], asr.pcm_in, mask)
        return asr.step(lm_params, state, asr.tokens_in, mask)[0]

    for _ in range(3):
        device_step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(len(events)):
        tok = device_step()
    tok.cpu()
    device_ms = (time.perf_counter() - t0) * 1000 / len(events)

    durations = sorted(e["ms"] for e in events)
    summary = {
        "mode": "asr", "model": model_name, "batch": batch,
        "mimi_chunks": 1,
        "kv_cache": kv_cache or lm.config.kv_cache_dtype,
        "context": lm.config.context,
        "weights": weights or "bf16",
        "mimi": _dtype_name(mimi_dtype),
        "steps": len(events),
        "p50_ms": durations[len(durations) // 2],
        "p90_ms": durations[int(len(durations) * 0.9)],
        "ms_per_user_p50": durations[len(durations) // 2] / batch,
        "device_only_ms": round(device_ms, 2),
        "host_roundtrip_ms": round(durations[len(durations) // 2] - device_ms, 2),
        "realtime": durations[int(len(durations) * 0.9)] < 80.0,
        "realtime_device_only": device_ms < 80.0,
    }
    _dump(out_path, summary, events)
    return summary


def bench_asr_host_only(model_name: str = "asr_300m_202501",
                        batch: int = 64, steps: int = 200) -> dict:
    """Pure-python cost of the ASR host control plane at batch: the
    per-slot delayed feeding and word tracking of StreamingASR.step_tokens
    with the device step (`_device_step`) stubbed by a seeded text stream,
    on the CPU: what the host burns per frame at scale."""
    from .models.asr import StreamingASR
    from .models.lm import LMModel
    from .models.loaders import LM_PRESETS
    from .models.mimi import MimiConfig, MimiModel

    config = LM_PRESETS[model_name]()
    lm = LMModel(config)
    mimi = MimiModel(MimiConfig(num_codebooks=min(config.n_q, 32)))

    class WordyTok:
        def decode(self, ids):
            return "w" * len(ids)

    rs = np.random.RandomState(0)
    # plausible text stream: ~40% pads/epads so words flush at a realistic
    # rate (2-3 words/s), rest real tokens
    text_seq = np.where(rs.rand(steps + 5, batch) < 0.25, 0,
                        np.where(rs.rand(steps + 5, batch) < 0.2, 3,
                                 rs.randint(4, 1000, (steps + 5, batch))))
    text_seq = torch.from_numpy(text_seq.astype(np.int64))
    prs = torch.zeros((2, batch), dtype=torch.float32)

    class HostOnlyASR(StreamingASR):
        calls = 0

        def _device_step(self, lm_params, state, tokens, exec_mask):
            i = self.calls
            self.calls += 1
            return text_seq[min(i, steps + 4)], prs

    asr = HostOnlyASR(mimi, lm, batch, asr_delay_in_tokens=6, temperature=0.0,
                      text_tokenizer=WordyTok(), device="cpu", graphed=False)
    state = {"transformer": {}, "generator": None, "mimi": {}}
    audio = rs.randint(0, 2048, (batch, asr.n_codebooks, 1)).astype(np.int32)

    for i in range(5):  # warm the interpreter/caches
        asr.step_tokens(None, state, audio)
    t0 = time.perf_counter()
    n_msgs = 0
    for i in range(steps):
        msgs, _ = asr.step_tokens(None, state, audio)
        n_msgs += len(msgs)
    host_ms = (time.perf_counter() - t0) * 1000 / steps
    return {"mode": "asr_host_only", "model": model_name, "batch": batch,
            "steps": steps, "host_python_ms": round(host_ms, 3),
            "host_python_us_per_user": round(host_ms * 1000 / batch, 1),
            "msgs_per_step": n_msgs / steps}


# ---------------------------------------------------------------------- tts
class _Tok:
    def encode(self, word):
        return [7 + (len(word) % 13)]


def _tts_model(lm, mimi):
    from .models.tts import StateMachine, TokenIds, TTSModel

    c = lm.config
    machine = StateMachine(TokenIds(card=c.text_card + 1), max_padding=8,
                           initial_padding=2)
    return TTSModel(lm, mimi, _Tok(), machine, delay_steps=25, temp=0.6,
                    n_q=c.dep_q, max_gen_length=10_000, final_padding=4)


def _tts_device_ms(engine, frames: int, device) -> float:
    """ms per frame of the engine's two steps chained over fixed inputs
    (a fixed text token, no audio zeroing, every slot live), one final
    sync."""
    engine.text_in.zero_()
    engine.zero_in.fill_(False)
    engine.mask_in.fill_(True)
    engine.dec_in.fill_(True)
    main, depth = engine._frame_args(engine.conditioned)

    def frame():
        engine.main[engine.conditioned](*main)
        return engine.depth(*depth)[1]

    for _ in range(3):
        frame()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(frames):
        pcm = frame()
    pcm.cpu()
    return (time.perf_counter() - t0) * 1000 / frames


def bench_tts(model_name: str = "tts_v0_1", steps: int = 50,
              out_path: str | None = None, device="cuda") -> dict:
    """Streaming-TTS frame benchmark: the host loop of serve/tts_ws.py
    TTSStreamer.step (temporal step, the host's text state machine,
    depformer, Mimi decode), with the device-host round trip that the DSM
    text machine needs every frame."""
    from .serve.tts_ws import TTSStreamer

    lm, lm_params = _preset_lm(model_name, device=device)
    mimi, mimi_params = build_mimi(min(lm.config.dep_q, 32), device=device)
    streamer = TTSStreamer(_tts_model(lm, mimi), lm_params, mimi_params, device=device,
                           rng_seed=SEED)
    streamer.warmup()

    events = []
    for i in range(steps + 5):
        # keep the word queue fed so the machine never starves
        if len(streamer.session.state.entries) < 4:
            streamer.feed_words(["hello world how are you"])
        t0 = time.perf_counter()
        pcm, _ = streamer.step()
        dt = time.perf_counter() - t0
        if i >= 5:
            events.append({"event": "tts_step", "step": i, "ms": dt * 1000,
                           "audio": pcm is not None})
    device_ms = _tts_device_ms(streamer.engine, len(events), device)

    durations = sorted(e["ms"] for e in events)
    summary = {
        "mode": "tts", "model": model_name, "steps": len(events),
        "p50_ms": durations[len(durations) // 2],
        "p90_ms": durations[int(len(durations) * 0.9)],
        "frames_per_s": 1000.0 / max(durations[len(durations) // 2], 1e-9),
        "device_only_ms": round(device_ms, 2),
        "host_roundtrip_ms": round(durations[len(durations) // 2] - device_ms, 2),
        "realtime": durations[int(len(durations) * 0.9)] < 80.0,
        "realtime_device_only": device_ms < 80.0,
    }
    _dump(out_path, summary, events)
    return summary


def bench_tts_batched(model_name: str = "tts_v0_1", batch: int = 8,
                      steps: int = 50, out_path: str | None = None,
                      kv_cache: str | None = None,
                      context: int | None = None,
                      weights: str | None = None,
                      mimi_dtype=torch.float32, device="cuda") -> dict:
    """Batched-TTS frame benchmark: serve/batched_tts.py
    BatchedTTSState.step_batch with every slot active (one temporal step,
    the per-slot DSM machines, depformer, Mimi decode).  Also the
    pure-python host share (the machines and the masks) with the two device
    steps stubbed."""
    from .serve.batched_tts import BatchedTTSState, _TtsSlot
    from .utils.serving import override_lm

    lm, lm_params = _preset_lm(model_name, quantize=weights, device=device)
    # capacity knobs: int8/int4 KV and a bounded context are the
    # production batched config
    lm = override_lm(lm, kv_cache, context)
    c = lm.config
    mimi, mimi_params = build_mimi(min(c.dep_q, 32), mimi_dtype, device)
    state = BatchedTTSState(_tts_model(lm, mimi), lm_params, mimi_params, batch,
                            device=device, rng_seed=SEED)
    active = list(range(batch))
    for b in active:
        state.open_slot(b)
    state.warmup()
    state.apply_pending_ops()

    def feed(words: str):
        for b in active:
            if len(state.slots[b].state.entries) < 4:
                state.feed_words(b, [words])

    def drain():  # so the outboxes do not grow
        for b in active:
            state.slots[b].outbox.clear()

    events = []
    for i in range(steps + 5):
        feed("hello world how are you today friend")
        t0 = time.perf_counter()
        state.step_batch(active)
        dt = time.perf_counter() - t0
        if i >= 5:
            events.append({"event": "tts_batch_step", "step": i, "ms": dt * 1000})
        drain()
    device_ms = _tts_device_ms(state, len(events), device)

    # pure-python host share: the device steps stubbed on the SAME state
    # (a second engine would hold a second KV cache)
    for b in active:
        state.slots[b] = _TtsSlot(state.machine)
    toks = torch.full((batch,), 5, dtype=torch.long)
    out = torch.zeros((batch, 1 + c.dep_q, 1), dtype=torch.long)
    pcm = torch.zeros((batch, 1, mimi.frame_size), dtype=torch.float32)
    state.main = dict.fromkeys((False, True), lambda *a: toks)
    state.depth = lambda *a: (out, pcm)
    for b in active:
        state.feed_words(b, ["hello world how are you today"] * 10)
    for _ in range(5):
        state.step_batch(active)
    t0 = time.perf_counter()
    for _ in range(len(events)):
        feed("hello world how are you")
        state.step_batch(active)
        drain()
    host_python_ms = (time.perf_counter() - t0) * 1000 / len(events)

    durations = sorted(e["ms"] for e in events)
    summary = {
        "mode": "tts_batched", "model": model_name, "batch": batch,
        "kv_cache": kv_cache or c.kv_cache_dtype,
        "context": c.context,
        "weights": weights or "bf16",
        "mimi": _dtype_name(mimi_dtype),
        "steps": len(events),
        "p50_ms": durations[len(durations) // 2],
        "p90_ms": durations[int(len(durations) * 0.9)],
        "ms_per_user_p50": durations[len(durations) // 2] / batch,
        "device_only_ms": round(device_ms, 2),
        "ms_per_user_device": round(device_ms / batch, 3),
        "host_python_ms": round(host_python_ms, 3),
        "realtime_device_only": device_ms < 80.0,
    }
    _dump(out_path, summary, events)
    return summary


# --------------------------------------------------------------------- mimi
def bench_mimi_only(steps: int = 100, device="cuda") -> dict:
    """Mimi encode then decode of zero frames at B = 1 (f32, 8 codebooks),
    each a step of its own (a CUDA graph on a card), 5 warm-up frames."""
    mimi, mimi_params = build_mimi(8, device=device)
    graphed = torch.device(device).type == "cuda"
    fs = mimi.frame_size
    enc_state = mimi.init_encode_state(1, torch.float32, device)
    dec_state = mimi.init_decode_state(1, torch.float32, device)
    enc = GraphedStep(lambda x: mimi.encode_step(mimi_params, enc_state, x)[0],
                      graphed=graphed, device=device)
    dec = GraphedStep(lambda codes: mimi.decode_step(mimi_params, dec_state, codes)[0],
                      graphed=graphed, device=device)
    pcm = torch.zeros((1, 1, fs), dtype=torch.float32, device=device)
    for _ in range(5):  # warmup
        out = dec.warm_or_call(enc.warm_or_call(pcm))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = dec(enc(pcm))
    out.cpu()
    dt = time.perf_counter() - t0
    per_step = dt / steps
    rtf = (fs / mimi.config.sample_rate) / per_step
    return {"mimi_steps_per_s": steps / dt, "ms_per_step": per_step * 1000,
            "rtf": rtf}


def main(argv=None) -> dict:
    """The CLI: prints the mode's summary as one JSON line and returns it."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="moshi_2b")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--out", default=None, help="JSON event log path")
    parser.add_argument("--no-pacing", action="store_true")
    parser.add_argument("--mimi-only", action="store_true")
    parser.add_argument("--mode", default="duplex",
                        choices=("duplex", "tts", "asr"))
    parser.add_argument("--batch", type=int, default=8,
                        help="asr/tts batch size (tts batch>1 runs the "
                             "batched multi-tenant step)")
    parser.add_argument("--kv-cache", default=None,
                        choices=["int8", "int4"],
                        help="KV cache dtype for batched tts/asr")
    parser.add_argument("--ctx", type=int, default=None,
                        help="context override for batched tts/asr")
    parser.add_argument("--weights", default=None,
                        choices=["int8", "int4"],
                        help="weight quantization for batched tts/asr")
    parser.add_argument("--mimi-dtype", default="f32",
                        choices=["f32", "bf16"],
                        help="codec dtype for batched tts/asr (bf16 halves "
                             "the codec share; codes not bit-exact — "
                             "QUALITY.md bounds)")
    parser.add_argument("--host-only", action="store_true",
                        help="measure only the pure-python host control "
                             "plane (no device): the per-slot state "
                             "machines at batch")
    parser.add_argument("--mimi-chunks", type=int, default=1,
                        help="split the mimi encoder into N sequential "
                             "batch chunks (not ported: only 1 runs)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch sees no CUDA device")
    if args.mimi_chunks != 1:
        raise NotImplementedError("mimi_chunks > 1 is not ported (models/asr.py)")
    mimi_dtype = torch.bfloat16 if args.mimi_dtype == "bf16" else torch.float32
    if args.mimi_only:
        out = bench_mimi_only(args.steps, device)
    elif args.mode == "asr":
        name = args.model if args.model != "moshi_2b" else "asr_300m_202501"
        if args.host_only:
            out = bench_asr_host_only(name, args.batch, max(args.steps, 100))
        else:
            out = bench_asr(name, args.batch, args.steps, args.out,
                            args.kv_cache, args.ctx, args.weights,
                            mimi_dtype, device=device)
            out.update(bench_asr_host_only(name, args.batch,
                                           max(args.steps, 100)))
            out["mode"] = "asr"
    elif args.mode == "tts":
        name = args.model if args.model != "moshi_2b" else "tts_v0_1"
        if args.batch > 1:
            out = bench_tts_batched(name, args.batch, args.steps,
                                    args.out, args.kv_cache,
                                    args.ctx, args.weights,
                                    mimi_dtype, device)
        else:
            out = bench_tts(name, args.steps, args.out, device)
    else:
        out = bench_paced(args.model, args.steps, args.out,
                          paced=not args.no_pacing, device=device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
