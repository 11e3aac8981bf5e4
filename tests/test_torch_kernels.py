"""The port's weight-only GEMV wrappers and quantizers against moshi_tpu.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode (q4gemm and q4gemm_stacked
through their `interpret` switch, qgemv through the `pallas_interpret`
fixture) and against the function the JAX main path calls (`wdot` on a
QTensor).  The CUDA kernels themselves are checked on the card by the
kernel phase of chip_smoke.py and by tests/test_torch_cuda.py."""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl
from moshi_tpu.ops.q4matmul import q4gemm, q4gemm_stacked
from moshi_tpu.ops.qmatmul import qgemv
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
            "moshi_tpu_torch.utils.matmul, moshi_tpu_torch.text\n"
            "from moshi_tpu_torch.ops import build\n"
            "assert moshi_tpu_torch.ops.q4matmul.q4_mma.launches == 0\n"
            "assert not build._loaded and 'triton' not in sys.modules\n")
    env = dict(os.environ, PATH="/usr/bin:/bin")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                   timeout=120)



Q4_MAIN_SHAPES = ((4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096), (4096, 32000))


@pytest.mark.parametrize("din,dout", Q4_MAIN_SHAPES)
def test_route_sends_the_batched_frame_to_q4_mma(din, dout):
    """bf16 at B = 16 (the batched frame) at every q4 shape of Moshi-7B goes
    to q4_mma; B = 1 (the B = 1 frame), f32 x, and a group size or a dout
    the kernel does not take go to the q4_gemv kernel."""
    assert dout % q4matmul.MMA_WARP_COLS == 0
    bf16, gs = torch.bfloat16, 32
    assert q4matmul.use_mma(16, bf16, gs, dout)
    assert q4matmul.use_mma(q4matmul.MMA_MIN_BATCH, bf16, gs, dout)
    assert not q4matmul.use_mma(1, bf16, gs, dout)
    assert not q4matmul.use_mma(16, torch.float32, gs, dout)
    assert not q4matmul.use_mma(16, torch.float16, gs, dout)
    assert not q4matmul.use_mma(17, bf16, gs, dout)
    assert not q4matmul.use_mma(16, bf16, 24, dout)     # gs % 16 != 0
    assert not q4matmul.use_mma(16, bf16, gs, dout + 16)  # dout % 32 != 0
    assert not q4matmul.use_mma(16, bf16, gs, dout + 32)  # dout % 64 != 0
    assert 1 < q4matmul.MMA_MIN_BATCH <= q4matmul.MAX_BATCH


@pytest.mark.parametrize("num_sms", [132, 114, 8])
def test_mma_split_plans_cover_the_main_path_shapes(num_sms):
    """q4_mma's din splits of the 7B's q4 shapes cover din exactly, keep a
    block's staged bf16 [16, rows + 8] x within 48 KB and give the grid
    one wave of about four blocks per SM (at least three, as the groups per
    split are rounded up, and at most four where din allows it)."""
    for din, dout in Q4_MAIN_SHAPES + ((256, 192), (4160, 8256)):
        gps, splits = q4matmul.mma_plan_splits(din, dout, 32, num_sms)
        assert (splits - 1) * gps < din // 32 <= splits * gps
        assert 2 * 16 * (gps * 32 + 8) <= 48 * 1024
        blocks = -(-dout // q4matmul.MMA_BLOCK_COLS) * splits
        assert blocks >= 3 * num_sms or gps == 1
        assert blocks <= 4 * num_sms or splits <= -(-din // q4matmul.MAX_SPLIT_ROWS)


def test_q4_mma_on_cpu_runs_the_plain_version():
    """On CPU tensors q4_mma and the q4_gemv entry point compute the plain
    version and count no launch, whatever the route says."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(16, 256).astype(np.float32)).to(torch.bfloat16)
    q4 = tq.quantize_tensor4(torch.from_numpy(rs.randn(256, 64).astype(np.float32)))
    counts = (q4matmul.q4_gemv.launches, q4matmul.q4_mma.launches)
    ref = q4matmul.q4_gemv_plain(x, q4.q, q4.scale)
    for fn in (q4matmul.q4_mma, q4matmul.q4_gemv, q4matmul.q4_gemv_kernel):
        assert torch.equal(fn(x, q4.q, q4.scale), ref)
    assert (q4matmul.q4_gemv.launches, q4matmul.q4_mma.launches) == counts
    with pytest.raises(ValueError):
        q4matmul.q4_mma(x[:, :128], q4.q, q4.scale)


def test_q4_mma_is_built_by_name():
    """q4_mma is a kernel of the build: its source and its C signature (the
    q4_gemv kernel's minus x_is_bf16)."""
    from moshi_tpu_torch.ops import build
    assert (build.CSRC / "q4_mma.cu").is_file()
    assert build.SIGNATURES["q4_mma"] == (build.SIGNATURES["q4_gemv"][:11]
                                          + build.SIGNATURES["q4_gemv"][12:])
    assert build.library_path("q4_mma").name.startswith("q4_mma-")


@pytest.mark.parametrize("batch", [1, 8, 9, 13, 16])
def test_split_plans_fit_the_staging_limit(batch):
    """At every batch the GEMVs take, a block's staged x (f32 [batch, rows])
    stays within the 48 KB a launch gets without opting in, and the splits
    still cover din exactly."""
    limit = 48 * 1024
    for din, dout in ((4096, 12288), (11264, 4096), (4096, 32000), (192, 100)):
        gps, splits = q4matmul.plan_splits(din, dout, 32, 132, batch)
        assert 4 * batch * gps * 32 <= limit
        assert (splits - 1) * gps < din // 32 <= splits * gps
    for din, dout in ((1024, 3072), (2816, 1024), (4096, 1024), (1000, 260)):
        rows, splits = qmatmul.plan_splits(din, dout, 132, batch)
        assert 4 * batch * rows <= limit and rows % qmatmul.ROW_GRAIN == 0
        assert (splits - 1) * rows < din <= splits * rows


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run moshi_tpu's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                             interpret=True))


@pytest.mark.parametrize("B", [1, 16])
def test_int8_plain_matches_pallas_qgemv(B, pallas_interpret):
    """The plain int8 version against the Pallas qgemv itself (interpret
    mode), bf16, at 128 x 128 blocks: 2 x 3 grid steps."""
    rs = np.random.RandomState(B)
    qt = jq.quantize_tensor(jnp.asarray(rs.randn(256, 384).astype(np.float32)))
    x = jnp.asarray(rs.randn(B, 256).astype(np.float32), jnp.bfloat16)
    y_ref = qgemv(x, qt.q, qt.scale, block_in=128, block_out=128)
    y = qmatmul.int8_gemv_plain(_t(x), _t(qt.q), _t(qt.scale))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (B, 384)
    assert rel_err(to_np(y), y_ref) <= BOUND["bf16"]


INT8_MAIN_SHAPES = ((1024, 3072), (1024, 1024), (1024, 5632), (2816, 1024), (1024, 2048),
                    (4096, 1024))


@pytest.mark.parametrize("din,dout", INT8_MAIN_SHAPES)
def test_route_sends_the_depformer_linears_to_int8_mma(din, dout):
    """bf16 at B = 1 and B = 16 (both frames) at every int8 shape of
    Moshi-7B goes to int8_mma; f32 x, B = 17, and a dout or din the kernel
    does not take go to the int8_gemv kernel."""
    bf16 = torch.bfloat16
    for B in (1, 16, qmatmul.MMA_MIN_BATCH):
        assert qmatmul.use_mma(B, bf16, din, dout)
    assert not qmatmul.use_mma(16, torch.float32, din, dout)
    assert not qmatmul.use_mma(1, torch.float16, din, dout)
    assert not qmatmul.use_mma(17, bf16, din, dout)
    assert not qmatmul.use_mma(16, bf16, din, dout + 32)   # dout % 64 != 0
    assert not qmatmul.use_mma(16, bf16, din + 8, dout)    # din % 16 != 0
    assert 1 <= qmatmul.MMA_MIN_BATCH <= q4matmul.MAX_BATCH


@pytest.mark.parametrize("num_sms", [132, 114])
def test_int8_mma_plans_cover_the_main_path_shapes(num_sms):
    """int8_mma's clusters of the depformer's shapes cover din exactly, in
    rows that are a multiple of 16 with only the last rank short, with at
    most 8 blocks to a cluster."""
    for din, dout in INT8_MAIN_SHAPES + ((16, 64), (1008, 192), (2064, 64)):
        cluster, rows = qmatmul.int8_mma_plan(din, dout, num_sms)
        assert 1 <= cluster <= qmatmul.MMA_MAX_CLUSTER == 8
        assert rows % 16 == 0 and rows > 0
        assert (cluster - 1) * rows < din <= cluster * rows


def test_int8_mma_on_cpu_runs_the_plain_version():
    """On CPU tensors int8_mma, the int8_gemv entry point and the int8_gemv
    kernel's wrapper compute the plain version and count no launch."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(16, 256).astype(np.float32)).to(torch.bfloat16)
    q8 = tq.quantize_tensor(torch.from_numpy(rs.randn(256, 128).astype(np.float32)))
    counts = (qmatmul.int8_gemv.launches, qmatmul.int8_mma.launches)
    ref = qmatmul.int8_gemv_plain(x, q8.q, q8.scale)
    for fn in (qmatmul.int8_mma, qmatmul.int8_gemv, qmatmul.int8_gemv_kernel):
        assert torch.equal(fn(x, q8.q, q8.scale), ref)
    assert (qmatmul.int8_gemv.launches, qmatmul.int8_mma.launches) == counts
    with pytest.raises(ValueError):
        qmatmul.int8_mma(x[:, :128], q8.q, q8.scale)


def test_int8_mma_is_built_by_name():
    """int8_mma is a kernel of the build: its source and its C signature
    (x, q, scale, out; batch, din, dout, rows_per_block, cluster; stream)."""
    from moshi_tpu_torch.ops import build
    assert (build.CSRC / "int8_mma.cu").is_file()
    p, i = build.SIGNATURES["int8_gemv"][0], build.SIGNATURES["int8_gemv"][5]
    assert build.SIGNATURES["int8_mma"] == [p] * 4 + [i] * 5 + [p]
    assert build.library_path("int8_mma").name.startswith("int8_mma-")
