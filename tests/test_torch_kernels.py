"""The port's weight-only GEMV wrappers and quantizers against moshi_tpu.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode (q4) and against the function
the JAX main path calls (`wdot` on a QTensor: qgemv has no interpret
switch).  The CUDA kernels themselves are checked on the card by the kernel
phase of chip_smoke.py and by tests/test_torch_cuda.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.ops.q4matmul import q4gemm, q4gemm_stacked
from moshi_tpu.utils import quantize as jq
from moshi_tpu.utils.matmul import wdot as jax_wdot
from moshi_tpu_torch.ops import q4matmul, qmatmul
from moshi_tpu_torch.utils import quantize as tq
from moshi_tpu_torch.utils.params import from_jax
from test_torch_port import rel_err, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32: accumulation order only; bf16: the plain version rounds the
# dequantized weights to bf16, the Pallas kernel scales after the dot
BOUND = {"f32": 1e-5, "bf16": 1e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return from_jax(np.asarray(a))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,din,dout", [(1, 256, 384), (4, 512, 256), (3, 128, 128)])
def test_q4_plain_matches_pallas(B, din, dout, dt):
    rs = np.random.RandomState(din + B)
    w = rs.randn(din, dout).astype(np.float32)
    x = rs.randn(B, din).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    qt = jq.quantize_tensor4(jnp.asarray(w), group_size=32)
    xj = jnp.asarray(x, jdt)
    y_ref = q4gemm(xj, qt.q, qt.scale, block_in=128, block_out=128, interpret=True)
    y = q4matmul.q4_gemv_plain(_t(xj), _t(qt.q), _t(qt.scale))
    assert y.dtype == tdt and tuple(y.shape) == (B, dout)
    assert rel_err(to_np(y), y_ref) <= BOUND[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_q4_plain_matches_pallas_stacked(dt):
    """One member of a stacked q4 weight: the view q[n] against
    q4gemm_stacked's scalar-prefetched member n."""
    rs = np.random.RandomState(1)
    jdt, _ = DTYPES[dt]
    qt = jq.quantize_tensor4(jnp.asarray(rs.randn(3, 256, 128).astype(np.float32) * 0.1))
    x = jnp.asarray(rs.randn(2, 256).astype(np.float32), jdt)
    q, scale = _t(qt.q), _t(qt.scale)
    for n in range(3):
        y_ref = q4gemm_stacked(x, qt.q, qt.scale, jnp.int32(n), block_in=128,
                               block_out=128, interpret=True)
        y = q4matmul.q4_gemv(_t(x), q[n], scale[n])
        assert rel_err(to_np(y), y_ref) <= BOUND[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,din,dout", [(1, 256, 384), (4, 96, 64)])
def test_int8_plain_matches_jax_wdot(B, din, dout, dt):
    rs = np.random.RandomState(din + B)
    jdt, tdt = DTYPES[dt]
    qt = jq.quantize_tensor(jnp.asarray(rs.randn(din, dout).astype(np.float32)))
    x = jnp.asarray(rs.randn(B, din).astype(np.float32), jdt)
    y_ref = jax_wdot(x, qt)
    y = qmatmul.int8_gemv_plain(_t(x), _t(qt.q), _t(qt.scale))
    assert y.dtype == tdt
    assert rel_err(to_np(y), y_ref) <= BOUND[dt]


@pytest.mark.parametrize("shape", [(128, 64), (2, 3, 64, 32), (192, 8)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_bytes_identical(shape, dt):
    rs = np.random.RandomState(len(shape))
    jdt, _ = DTYPES[dt]
    w = jnp.asarray(rs.randn(*shape).astype(np.float32) * 0.05, jdt)
    for jfn, tfn in ((jq.quantize_tensor4, tq.quantize_tensor4),
                     (jq.quantize_tensor, tq.quantize_tensor)):
        ref, got = jfn(w), tfn(_t(w))
        np.testing.assert_array_equal(to_np(got.q), np.asarray(ref.q))
        np.testing.assert_array_equal(to_np(got.scale), np.asarray(ref.scale))
        assert got.scale.dtype == torch.float32
    # and the dequantized weights agree
    for deq, ref in ((tq.dequantize4, jq.quantize_tensor4(w)),
                     (tq.dequantize, jq.quantize_tensor(w))):
        np.testing.assert_array_equal(
            to_np(deq(_t(ref.q), _t(ref.scale), torch.float32)),
            np.asarray(ref.astype(jnp.float32)))


def test_unpack_nibbles_sign_extension():
    b = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    low, high = tq.unpack_nibbles(b)
    jl, jh = jq.unpack_nibbles(jnp.arange(-128, 128).astype(jnp.int8))
    np.testing.assert_array_equal(low.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(high.numpy(), np.asarray(jh))
    assert int(low.min()) == -8 and int(low.max()) == 7


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_quantize_lm_params_identical(mode):
    """The whole tiny LM tree: same leaf kinds (q4 on the temporal linears
    and text head, int8 on the depformer), same bytes."""
    import jax
    from moshi_tpu.models.lm import LMModel
    from test_lm import tiny_lm_config

    cfg = tiny_lm_config(dim=64, depformer_dim=32)
    params = LMModel(cfg).init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    ref = from_jax(jax.device_get(jq.quantize_lm_params(params, min_size=1, mode=mode)))
    got = tq.quantize_lm_params(from_jax(jax.device_get(params)), min_size=1, mode=mode)

    kinds = []

    def compare(a, b, path=""):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                compare(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (tq.QTensor, tq.QTensor4)):
            kinds.append((path, type(a).__name__))
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), path
        else:
            assert torch.equal(a, b), path

    compare(got, ref)
    kinds = dict(kinds)
    if mode == "int4":
        assert kinds["/transformer/layers/attn/in_proj"] == "QTensor4"
        assert kinds["/text_linear/weight"] == "QTensor4"
        assert kinds["/depformer/layers/attn/in_proj"] == "QTensor"
        assert kinds["/linears/weight"] == "QTensor"
    assert kinds["/depformer_in/weight"] == "QTensor"


def test_wrappers_on_cpu_run_the_plain_version():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 128).astype(np.float32))
    w = torch.from_numpy(rs.randn(128, 64).astype(np.float32))
    q4, q8 = tq.quantize_tensor4(w), tq.quantize_tensor(w)
    n4, n8 = q4matmul.q4_gemv.launches, qmatmul.int8_gemv.launches
    assert torch.equal(q4matmul.q4_gemv(x, q4.q, q4.scale),
                       q4matmul.q4_gemv_plain(x, q4.q, q4.scale))
    assert torch.equal(qmatmul.int8_gemv(x, q8.q, q8.scale),
                       qmatmul.int8_gemv_plain(x, q8.q, q8.scale))
    # the counters count kernel launches only
    assert (q4matmul.q4_gemv.launches, qmatmul.int8_gemv.launches) == (n4, n8)


def test_wrappers_reject_bad_operands():
    x = torch.zeros(1, 64)
    q4 = tq.quantize_tensor4(torch.zeros(64, 32))
    with pytest.raises(ValueError):
        q4matmul.q4_gemv(torch.zeros(1, 128), q4.q, q4.scale)
    with pytest.raises(TypeError):
        q4matmul.q4_gemv(x, q4.q, q4.scale.double())
    q8 = tq.quantize_tensor(torch.zeros(64, 32))
    with pytest.raises(ValueError):
        qmatmul.int8_gemv(x, q8.q, q8.scale[:, :16])


def test_split_plans_cover_the_main_path_shapes():
    """The din splits of the 7B's shapes cover din exactly and keep a block
    within the shared-memory staging limit."""
    for din, dout in ((4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096),
                      (4096, 32000)):
        gps, splits = q4matmul.plan_splits(din, dout, 32, 132)
        assert gps * 32 <= q4matmul.MAX_SPLIT_ROWS
        assert (splits - 1) * gps < din // 32 <= splits * gps
    for din, dout in ((1024, 3072), (1024, 1024), (1024, 5632), (2816, 1024),
                      (1024, 2048), (4096, 1024)):
        rows, splits = qmatmul.plan_splits(din, dout, 132)
        assert rows <= q4matmul.MAX_SPLIT_ROWS and rows % qmatmul.ROW_GRAIN == 0
        assert (splits - 1) * rows < din <= splits * rows


def test_kernel_modules_import_without_cuda_toolchain():
    """Importing the port builds nothing and needs neither nvcc nor triton."""
    code = ("import sys, moshi_tpu_torch.ops.q4matmul, moshi_tpu_torch.ops.qmatmul, "
            "moshi_tpu_torch.utils.matmul\n"
            "from moshi_tpu_torch.ops import build\n"
            "assert not build._loaded and 'triton' not in sys.modules\n")
    env = dict(os.environ, PATH="/usr/bin:/bin")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                   timeout=120)

