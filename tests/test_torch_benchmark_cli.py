"""The port's benchmark CLI (moshi_tpu_torch/benchmark.py) on the CPU at a
tiny size: every mode through main(argv), whose printed JSON must have
exactly the keys of the JAX function's summary (listed here from
moshi_tpu/benchmark.py), the event log of --out, and
bench_asr_host_only's msgs_per_step against the JAX package's on the same
seeded text stream.  The module's builders and the port's LM_PRESETS
entries are patched to tiny configs."""

import functools
import json

import pytest
import torch

from moshi_tpu import benchmark as jbench
from moshi_tpu_torch import benchmark
from moshi_tpu_torch.models import loaders
from moshi_tpu_torch.models.lm import LmConfig, LMModel
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.modules.seanet import SEANetConfig
from moshi_tpu_torch.modules.transformer import TransformerConfig
from moshi_tpu_torch.quantization.vq import RVQConfig
from moshi_tpu_torch.utils import quantize

# the summary keys of moshi_tpu/benchmark.py, by mode
PACED_KEYS = {"model", "steps", "frame_interval_ms", "p50_ms", "p90_ms", "max_ms", "realtime"}
ASR_KEYS = {"mode", "model", "batch", "mimi_chunks", "kv_cache", "context", "weights", "mimi",
            "steps", "p50_ms", "p90_ms", "ms_per_user_p50", "device_only_ms",
            "host_roundtrip_ms", "realtime", "realtime_device_only"}
ASR_HOST_KEYS = {"mode", "model", "batch", "steps", "host_python_ms",
                 "host_python_us_per_user", "msgs_per_step"}
TTS_KEYS = {"mode", "model", "steps", "p50_ms", "p90_ms", "frames_per_s", "device_only_ms",
            "host_roundtrip_ms", "realtime", "realtime_device_only"}
TTS_BATCHED_KEYS = {"mode", "model", "batch", "kv_cache", "context", "weights", "mimi", "steps",
                    "p50_ms", "p90_ms", "ms_per_user_p50", "device_only_ms",
                    "ms_per_user_device", "host_python_ms", "realtime_device_only"}
MIMI_KEYS = {"mimi_steps_per_s", "ms_per_step", "rtf"}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_lora.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_mimi(num_codebooks: int, dtype=torch.float32, device="cpu"):
    """A 1200 Hz Mimi (frame 96 samples) from a seed."""
    cfg = MimiConfig(
        sample_rate=1200, seanet=SEANetConfig(dimension=32, n_filters=4, ratios=(4, 3, 2)),
        transformer=TransformerConfig(d_model=32, num_heads=2, num_layers=2,
                                      dim_feedforward=64, context=25, gating="none",
                                      norm="layer_norm", layer_scale=0.01),
        quantizer=RVQConfig(dimension=16, input_dimension=32, output_dimension=32, n_q=8,
                            bins=32),
        num_codebooks=num_codebooks)
    mimi = MimiModel(cfg)
    return mimi, mimi.init_params(torch.Generator().manual_seed(0), dtype, device)


def tiny_moshi(name: str, device="cpu"):
    """build_lm's counterpart: a 2-layer Moshi LM with dim 64, the name's
    quantization suffix honoured."""
    cfg = LmConfig(dim=64, num_heads=2, num_layers=2, hidden_scale=4.5, n_q=4, dep_q=2,
                   card=32, text_card=64, context=20, depformer_dim=32, depformer_num_heads=2,
                   depformer_num_layers=2, depformer_dim_feedforward=64,
                   delays=(0, 0, 1, 0, 2))
    lm = LMModel(cfg)
    params = lm.init_params(torch.Generator().manual_seed(0), torch.bfloat16, device)
    for mode in ("int8", "int4"):
        if name.endswith("_" + mode):
            params = quantize.quantize_lm_params(params, min_size=1, mode=mode)
    return lm, params


TINY_ASR = LmConfig(dim=64, num_heads=2, num_layers=2, n_q=4, dep_q=0, card=32, text_card=64,
                    context=12, delays=(0,) * 5, extra_heads_num_heads=2, extra_heads_dim=2)
TINY_TTS = LmConfig(dim=64, num_heads=2, num_layers=2, n_q=4, dep_q=4, card=32, text_card=64,
                    text_card_out=65, context=24, depformer_dim=32, depformer_num_heads=2,
                    depformer_num_layers=2, depformer_dim_feedforward=64,
                    delays=(0, 0, 2, 2, 2))


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(benchmark, "build_lm", tiny_moshi)
    monkeypatch.setattr(benchmark, "build_mimi", tiny_mimi)
    monkeypatch.setitem(loaders.LM_PRESETS, "asr_300m_202501", lambda: TINY_ASR)
    monkeypatch.setitem(loaders.LM_PRESETS, "tts_v0_1", lambda: TINY_TTS)
    monkeypatch.setattr(quantize, "quantize_lm_params",
                        functools.partial(quantize.quantize_lm_params, min_size=1))


def run_main(capsys, *argv) -> dict:
    out = benchmark.main([*argv, "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    return out


@pytest.mark.parametrize("model", ["moshi_7b_int4", "moshi_2b"])
def test_duplex_paced_keys(tiny, capsys, tmp_path, model):
    events = tmp_path / "events.json"
    out = run_main(capsys, "--model", model, "--steps", "4", "--out", str(events))
    assert set(out) == PACED_KEYS
    assert out["model"] == model and out["steps"] == 4
    assert out["frame_interval_ms"] == pytest.approx(80.0)
    # paced: each step starts no earlier than its slot
    log = json.loads(events.read_text())
    assert log["summary"] == out and len(log["events"]) == 4
    for e in log["events"]:
        assert e["ts"] >= e["step"] * 0.08 - 1e-3
        assert e["ts"] <= e["post_encode"] <= e["post_sampling"] <= e["post_decode"]


def test_duplex_unpaced_keys(tiny, capsys):
    out = run_main(capsys, "--steps", "3", "--no-pacing")
    assert set(out) == PACED_KEYS and out["model"] == "moshi_2b"


@pytest.mark.parametrize("kv", [None, "int8"])
def test_asr_keys(tiny, capsys, tmp_path, kv):
    args = ["--mode", "asr", "--batch", "3", "--steps", "4", "--mimi-dtype", "bf16",
            "--out", str(tmp_path / "asr.json")]
    out = run_main(capsys, *args, *(["--kv-cache", kv] if kv else []))
    assert set(out) == ASR_KEYS | ASR_HOST_KEYS
    assert out["mode"] == "asr" and out["model"] == "asr_300m_202501"
    assert out["kv_cache"] == (kv or "model") and out["mimi"] == "bfloat16"
    assert out["steps"] == 100      # the host-only part's, as JAX's main merges them
    assert len(json.loads((tmp_path / "asr.json").read_text())["events"]) == 4


def test_asr_host_only_keys(tiny, capsys):
    out = run_main(capsys, "--mode", "asr", "--host-only", "--batch", "4", "--steps", "10")
    assert set(out) == ASR_HOST_KEYS and out["steps"] == 100


def test_asr_host_only_msgs_equal_jax():
    """The host control plane over the same seeded text stream: the same
    messages a step as the JAX package's, at the published preset."""
    for batch in (8, 64):
        mine = benchmark.bench_asr_host_only("asr_300m_202501", batch, 100)
        theirs = jbench.bench_asr_host_only("asr_300m_202501", batch, 100)
        assert set(mine) == set(theirs) == ASR_HOST_KEYS
        assert mine["msgs_per_step"] == theirs["msgs_per_step"] > 0


def test_asr_refuses_mimi_chunks(tiny, capsys):
    with pytest.raises(NotImplementedError, match="mimi_chunks"):
        run_main(capsys, "--mode", "asr", "--batch", "4", "--steps", "2", "--mimi-chunks", "2")


def test_tts_keys(tiny, capsys):
    out = run_main(capsys, "--mode", "tts", "--batch", "1", "--steps", "4")
    assert set(out) == TTS_KEYS and out["model"] == "tts_v0_1"


@pytest.mark.parametrize("extra", [[], ["--kv-cache", "int4", "--weights", "int8"]])
def test_tts_batched_keys(tiny, capsys, extra):
    out = run_main(capsys, "--mode", "tts", "--batch", "3", "--steps", "4", *extra)
    assert set(out) == TTS_BATCHED_KEYS and out["batch"] == 3
    assert out["weights"] == ("int8" if extra else "bf16")


def test_tts_batched_above_16_rows(tiny, capsys):
    out = run_main(capsys, "--mode", "tts", "--batch", "17", "--steps", "2")
    assert set(out) == TTS_BATCHED_KEYS and out["batch"] == 17


def test_mimi_only_keys(tiny, capsys):
    out = run_main(capsys, "--mimi-only", "--steps", "5")
    assert set(out) == MIMI_KEYS and out["rtf"] > 0


def test_cuda_without_a_card_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        benchmark.main(["--mimi-only"])
