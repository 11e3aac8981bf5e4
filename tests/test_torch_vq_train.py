"""The port's codec training (quantization/train.py and train.py's Mimi
half) against moshi_tpu's, in f32 on the CPU: the deterministic part of
rvq_train_forward (an initialized state, no expired code) and
spectral_loss equal JAX's; k-means reduces inertia and the EMA learns
codebooks (properties: the port's draws are not jax.random's); and
run_training overfits the tiny Mimi into a codec that still encodes and
decodes."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu import train as jtrain
from moshi_tpu.quantization import train as jqt
from moshi_tpu.quantization.vq import RVQConfig as JRVQConfig
from moshi_tpu_torch import train as ttrain
from moshi_tpu_torch.quantization import train as tqt
from moshi_tpu_torch.quantization.vq import (RVQConfig, ResidualVectorQuantizer,
                                             nearest_codebook)
from test_torch_lora import one_thread  # noqa: F401  (autouse)

RVQ_TOL = 1e-5    # f32 EMA sums and quantized values, max |diff| / max |JAX|
STFT_TOL = 1e-5   # f32 loss, relative


def _rvq_case(seed=0, proj=True):
    rs = np.random.RandomState(seed)
    cfg = dict(dimension=8, input_dimension=12, output_dimension=10, n_q=3, bins=16)
    params = {"input_proj": rs.randn(12, 8).astype(np.float32) / 12 ** 0.5,
              "output_proj": rs.randn(8, 10).astype(np.float32) / 8 ** 0.5} if proj else {}
    if not proj:
        cfg.update(input_dimension=8, output_dimension=8)
    usage = rs.rand(3, 16).astype(np.float32) + 0.5
    state = {"initialized": np.ones((), np.float32), "cluster_usage": usage,
             "embedding_sum": (rs.randn(3, 16, 8).astype(np.float32) * usage[..., None])}
    x = rs.randn(2, 7, cfg["input_dimension"]).astype(np.float32)
    return cfg, params, state, x


@pytest.mark.parametrize("proj", [True, False])
def test_rvq_train_forward_matches_jax(proj):
    """An initialized state and no expiry (threshold 0): codes, the
    straight-through output, the commit loss, the entropy, the new EMA
    state and the gradient of the commit loss plus the output's sum at the
    input equal JAX's."""
    cfg, params, state, x = _rvq_case(proj=proj)
    tcfg = dict(decay=0.9, threshold_usage_ratio=0.0)

    def jfn(x):
        out, st = jqt.rvq_train_forward(JRVQConfig(**cfg, force_projection=proj),
                                        jqt.RVQTrainConfig(**tcfg),
                                        {k: jnp.asarray(v) for k, v in params.items()},
                                        {k: jnp.asarray(v) for k, v in state.items()}, x,
                                        jax.random.PRNGKey(0))
        return out["commit_loss"] + out["quantized"].sum(), (out, st)
    (_, (jout, jst)), jgx = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, tst = tqt.rvq_train_forward(RVQConfig(**cfg), tqt.RVQTrainConfig(**tcfg),
                                      {k: torch.from_numpy(v) for k, v in params.items()},
                                      {k: torch.from_numpy(v) for k, v in state.items()}, tx,
                                      torch.Generator().manual_seed(0))
    (tgx,) = torch.autograd.grad(tout["commit_loss"] + tout["quantized"].sum(), tx)
    assert np.array_equal(tout["codes"].numpy(), np.asarray(jout["codes"]))
    for got, want in ((tout["quantized"], jout["quantized"]), (tgx, jgx),
                      (tst["cluster_usage"], jst["cluster_usage"]),
                      (tst["embedding_sum"], jst["embedding_sum"]),
                      (tout["commit_loss"], jout["commit_loss"]),
                      (tout["entropy"], jout["entropy"])):
        want = np.asarray(want)
        assert float(np.abs(got.detach().numpy() - want).max()) <= RVQ_TOL * float(
            np.abs(want).max())
    assert float(tout["expired_frac"]) == float(jout["expired_frac"]) == 0.0


def test_spectral_loss_matches_jax():
    rs = np.random.RandomState(1)
    a, b = (rs.randn(2, 2000).astype(np.float32) for _ in range(2))
    want = float(jtrain.spectral_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(ttrain.spectral_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= STFT_TOL * abs(want)
    short = float(ttrain.spectral_loss(torch.from_numpy(a[:, :100]), torch.from_numpy(b[:, :100])))
    assert abs(short - float(jtrain.spectral_loss(jnp.asarray(a[:, :100]),
                                                  jnp.asarray(b[:, :100])))) <= STFT_TOL * short


def test_kmeans_reduces_inertia():
    """Learnt means cut the quantization inertia far below the data's
    variance (the JAX package's own bound, tests/test_vq_train.py)."""
    rs = np.random.RandomState(0)
    centers = rs.randn(4, 8) * 3
    samples = np.concatenate([c + 0.05 * rs.randn(50, 8) for c in centers]).astype(np.float32)
    means, bins = tqt.kmeans(torch.Generator().manual_seed(0), torch.from_numpy(samples), 8,
                             num_iters=20)
    d2 = ((samples[:, None] - means.numpy()[None]) ** 2).sum(-1).min(1)
    variance = ((samples - samples.mean(0)) ** 2).sum(-1).mean()
    assert d2.mean() < 0.05 * variance
    assert float(bins.sum()) == len(samples)


def test_rvq_training_reduces_error():
    """EMA training with k-means init and expiry learns codebooks whose
    inference path reconstructs clustered data."""
    cfg = RVQConfig(dimension=8, input_dimension=8, output_dimension=8, n_q=2, bins=16)
    tcfg = tqt.RVQTrainConfig(decay=0.9, kmeans_iters=20)
    state = tqt.init_train_state(cfg)
    rs = np.random.RandomState(0)
    centers = rs.randn(16, 8)
    g = torch.Generator().manual_seed(0)
    errs = []
    for _ in range(30):
        x = torch.from_numpy((centers[rs.randint(0, 16, 64)] + 0.02 * rs.randn(64, 8))[None]
                             .astype(np.float32))
        out, state = tqt.rvq_train_forward(cfg, tcfg, {}, state, x, g)
        errs.append(float(((out["quantized"] - x) ** 2).mean()))
    assert errs[-1] < errs[0] * 0.5, errs[:3] + errs[-3:]
    assert float(out["entropy"]) > 0.5
    emb = tqt.embedding_from_state(state)
    x = torch.from_numpy(centers[rs.randint(0, 16, 64)][None].astype(np.float32))
    q = ResidualVectorQuantizer(cfg)
    y = q.decode({"embedding": emb, "output_proj": torch.eye(8)},
                 q.encode({"embedding": emb, "input_proj": torch.eye(8)}, x))
    assert float(((y - x) ** 2).mean()) < 0.1
    assert nearest_codebook(x, emb[0]).max() < 16


def test_run_training_overfits_tiny_mimi(tmp_path):
    """The CLI's codec target (tests/test_train.py:245-272 in the JAX
    package): the loss falls on a repeated batch, the codebooks stay in use
    (entropy), and the synced params drive the codec; a resume from step
    20 ends where the uninterrupted run ends, bit for bit."""
    from moshi_tpu_torch.models.loaders import mimi_config_from_dict
    from moshi_tpu_torch.models.mimi import MimiModel
    cfg = {"target": "mimi", "device": "cpu", "num_codebooks": 4,
           "mimi_config": {
               "sample_rate": 1200, "channels": 1, "frame_rate": 12.5,
               "seanet": dict(dimension=32, n_filters=4, n_residual_layers=1, ratios=[4, 3, 2],
                              kernel_size=7, residual_kernel_size=3, last_kernel_size=3,
                              dilation_base=2, compress=2, pad_mode="constant"),
               "transformer": dict(d_model=32, num_heads=2, num_layers=2, dim_feedforward=64,
                                   causal=True, context=25, positional_embedding="rope",
                                   gating="none", norm="layer_norm", layer_scale=0.01),
               "quantizer": dict(dimension=16, input_dimension=32, output_dimension=32, n_q=8,
                                 bins=32)},
           "optimizer": {"lr": 1e-3, "grad_clip": 1.0},
           "steps": 40, "batch_size": 2, "seq_len": 4, "log_every": 10,
           "save_every": 20, "out_dir": str(tmp_path / "ck")}
    losses = []

    def log(line):
        d = json.loads(line)
        if "loss" in d:
            losses.append(d["loss"])
    out = ttrain.run_training(cfg, log=log)
    assert np.isfinite(losses).all() and len(losses) == 4
    assert out["loss"] < losses[0] * 0.6, losses
    assert out["metrics"]["entropy"] > 0.5
    mimi = MimiModel(mimi_config_from_dict(cfg["mimi_config"], 4))
    pcm = torch.from_numpy(np.random.RandomState(0).randn(1, 1, 4 * mimi.frame_size)
                           .astype(np.float32) * 0.3)
    with torch.no_grad():
        codes = mimi.encode(out["params"], pcm)
        audio = mimi.decode(out["params"], codes)
    assert audio.shape[0] == 1 and bool(torch.isfinite(audio).all())
    assert codes.min() >= 0 and codes.max() < 32
    resumed = ttrain.run_training({**cfg, "out_dir": None,
                                   "resume": str(tmp_path / "ck" / "train-000020.safetensors")},
                                  log=lambda line: None)
    assert resumed["loss"] == out["loss"]
