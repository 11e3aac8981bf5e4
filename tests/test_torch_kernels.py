"""The port's weight-only GEMV wrappers and quantizers against moshi_tpu.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode (q4gemm and q4gemm_stacked
through their `interpret` switch, qgemv through the `pallas_interpret`
fixture) and against the function the JAX main path calls (`wdot` on a
QTensor).  The CUDA kernels themselves are checked on the card by the
kernel phase of chip_smoke.py and by tests/test_torch_cuda.py."""

import ctypes
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
from moshi_tpu_torch.ops import decode_attention as da8, int4_attention as i4, q4matmul, qmatmul
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
@pytest.mark.parametrize("B,din,dout", [(1, 256, 384), (4, 96, 64), (33, 256, 384),
                                        (200, 96, 64)])
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


# the CUDA-core GEMVs' main-path launches: (kernel, din, dout, batch, the
# columns a lane may own) -- Moshi-7B's 129 q4 linears at B = 1 (the B = 1
# frame), the TTS heads (32001 and 2049 columns, rows off any alignment) at
# B = 16, the f32 q4 route's 16-row chunks, the depformer's int8 shapes in f32
GEMV_CASES = ([("q4", din, dout, 1, (16, 8, 4)) for din, dout in
               ((4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096), (4096, 32000))]
              + [("int8", 2048, 32001, 16, (4,)), ("int8", 1024, 2049, 16, (4,)),
                 ("q4", 4096, 4096, 16, (4,)), ("q4", 4096, 4096, 2, (8, 4)),
                 ("int8", 1024, 3072, 16, (4,)), ("int8", 2816, 1024, 1, (16, 8, 4))])


def _warp_rows(plan, din, grain):
    """The din rows each (rank, warp) of a launch sums, as the kernels walk
    them (csrc/int8_gemv.cu, csrc/q4_gemv.cu): rank r's rows in segments of
    seg_rows, each segment cut into the warps' consecutive slices (int8 a
    multiple of GEMV_BATCH_ROWS rows, q4 whole groups)."""
    rows = {}
    for r in range(plan.cluster):
        b0, b1 = r * plan.rows_per_block, min(din, (r + 1) * plan.rows_per_block)
        for s0 in range(b0, b1, plan.seg_rows):
            s1 = min(b1, s0 + plan.seg_rows)
            if grain == 1:
                per = -(-(-(-(s1 - s0) // plan.warps)) // q4matmul.GEMV_BATCH_ROWS) \
                    * q4matmul.GEMV_BATCH_ROWS
            else:
                per = -(-((s1 - s0) // grain) // plan.warps) * grain
            for w in range(plan.warps):
                w0, w1 = min(s1, s0 + w * per), min(s1, s0 + (w + 1) * per)
                rows.setdefault((r, w), []).extend(range(w0, w1))
    return rows


def _resident(kind, batch, plan, num_sms):
    """A plan's shared memory and the blocks the card holds at once by
    gemv_resident_model."""
    smem = q4matmul.gemv_smem_bytes(batch, plan.cols, plan.warps, plan.cluster, plan.seg_rows,
                                    q4matmul.gemv_ring_bytes(kind, batch, plan.cols))
    model = q4matmul.gemv_resident_model(kind, batch, num_sms)
    return smem, model(plan.cols, plan.warps, plan.cluster, plan.seg_rows)


@pytest.mark.parametrize("num_sms", [132, 114])
@pytest.mark.parametrize("kind,din,dout,batch,cols", GEMV_CASES)
def test_split_plans_cover_the_main_path_shapes(kind, din, dout, batch, cols, num_sms):
    """gemv_plan at every main-path shape of the CUDA-core GEMVs: a cluster
    of at most 8, a lane's columns among those the operands allow and within
    its registers (batch x cols <= GEMV_MAX_ACC, Q4_MAX_ACC for q4, above
    4 columns), every din row summed by exactly one warp (q4 in whole
    groups), shared memory within an H100 block's, and a first wave that
    holds every block where the plan takes a cluster (by
    gemv_resident_model) and puts GEMV_MIN_WARPS_PER_SM warps on each SM
    unless the smallest columns a lane do not."""
    grain = 32 if kind == "q4" else 1
    plan = q4matmul.gemv_plan(kind, din, dout, batch, num_sms, grain, cols)
    assert 1 <= plan.cluster <= q4matmul.GEMV_MAX_CLUSTER == 8
    assert 1 <= plan.warps <= q4matmul.GEMV_MAX_WARPS
    most = q4matmul.Q4_MAX_ACC if kind == "q4" else q4matmul.GEMV_MAX_ACC
    assert plan.cols in cols and (plan.cols == 4 or batch * plan.cols <= most)
    assert plan.rows_per_block % grain == 0 and plan.seg_rows % grain == 0
    assert (plan.cluster - 1) * plan.rows_per_block < din <= plan.cluster * plan.rows_per_block
    covered = sorted(r for rows in _warp_rows(plan, din, grain).values() for r in rows)
    assert covered == list(range(din))
    smem, resident = _resident(kind, batch, plan, num_sms)
    assert smem <= q4matmul.GEMV_SMEM_LIMIT
    blocks = -(-dout // (32 * plan.cols)) * plan.cluster
    assert blocks <= resident or plan.cluster == 1
    assert (blocks * plan.warps >= q4matmul.GEMV_MIN_WARPS_PER_SM * num_sms
            or plan.cols == cols[-1])


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
    assert q4matmul.use_mma(17, bf16, gs, dout)  # any row count above (the offline M)
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
        assert splits == 1 or 4 * splits * 16 * dout <= q4matmul.MMA_WORKSPACE_BYTES
        assert 2 * 16 * (gps * 32 + 8) <= 48 * 1024
        blocks = -(-dout // q4matmul.MMA_BLOCK_COLS) * splits
        assert blocks >= 3 * num_sms or gps == 1
        assert blocks <= 4 * num_sms or splits <= -(-din // q4matmul.MAX_SPLIT_ROWS)


# the offline forward's rows: B * T of chip_smoke.py's [offline] LM pass
# (2 x 128), a long scoring pass, and the edges of a 16-row tile
OFFLINE_ROWS = (17, 32, 40, 64, 256, 4096)


@pytest.mark.parametrize("din,dout", Q4_MAIN_SHAPES)
def test_route_sends_offline_rows_to_q4_mma(din, dout):
    """bf16 x of any row count from MMA_MIN_BATCH on goes to a tensor-core
    kernel at every q4 shape of Moshi-7B (q4_mma up to 16 rows, q4_wgmma
    above); f32 x of any row count to the q4_gemv kernel."""
    for M in (2, 16) + OFFLINE_ROWS:
        assert q4matmul.use_mma(M, torch.bfloat16, 32, dout)
        assert not q4matmul.use_mma(M, torch.float32, 32, dout)
        assert q4matmul.route(M, torch.bfloat16, 32, dout) == ("q4_mma" if M <= 16
                                                               else "q4_wgmma")


@pytest.mark.parametrize("M,dtype,kernel", [
    (1, torch.bfloat16, "q4_gemv"), (2, torch.bfloat16, "q4_mma"),
    (16, torch.bfloat16, "q4_mma"), (17, torch.bfloat16, "q4_wgmma"),
    (256, torch.bfloat16, "q4_wgmma"), (1, torch.float32, "q4_gemv"),
    (16, torch.float32, "q4_gemv"), (17, torch.float32, "q4_gemv"),
    (256, torch.float32, "q4_gemv")])
def test_route_by_rows_and_dtype(M, dtype, kernel):
    """The kernel of a CUDA call by its rows and dtype at every Moshi-7B q4
    shape: bf16 M = 16 to q4_mma, 17 and 256 to q4_wgmma; one bf16 row and
    f32 of any M to the q4_gemv kernel; a group size or dout the
    tensor-core kernels do not take to the q4_gemv kernel whatever M."""
    for _, dout in Q4_MAIN_SHAPES:
        assert q4matmul.route(M, dtype, 32, dout) == kernel
        assert q4matmul.route(M, dtype, 24, dout) == "q4_gemv"
        assert q4matmul.route(M, dtype, 32, dout + 32) == "q4_gemv"


@pytest.mark.parametrize("num_sms", [132, 114, 8])
def test_mma_split_plans_by_rows(num_sms):
    """q4_wgmma's plan by row count M (OFFLINE_ROWS, and the rows of a
    decoding batch it also takes): the din splits cover din exactly in
    whole groups of at least WGMMA_MIN_SPLIT_ROWS rows, their f32 partial
    sums [splits, M, dout] stay within MMA_WORKSPACE_BYTES, and the grid
    fills one wave (WGMMA_WAVE_FILL of the SMs) unless the limits on the
    splits keep it from it; a large M runs unsplit."""
    for din, dout in Q4_MAIN_SHAPES + ((256, 192), (4160, 8256)):
        for M in (1, 16) + OFFLINE_ROWS:
            gps, splits = q4matmul.wgmma_plan_splits(din, dout, 32, num_sms, M)
            assert (splits - 1) * gps < din // 32 <= splits * gps
            assert splits == 1 or gps * 32 >= q4matmul.WGMMA_MIN_SPLIT_ROWS
            assert splits == 1 or 4 * splits * M * dout <= q4matmul.MMA_WORKSPACE_BYTES
            tiles = -(-M // q4matmul.WGMMA_ROWS) * -(-dout // q4matmul.WGMMA_COLS)
            most = min(din // 32, max(1, din // q4matmul.WGMMA_MIN_SPLIT_ROWS),
                       max(1, q4matmul.MMA_WORKSPACE_BYTES // (4 * M * dout)))
            fill = q4matmul.WGMMA_WAVE_FILL * num_sms
            assert tiles * splits >= fill or tiles * most < fill
        if (din, dout) in Q4_MAIN_SHAPES:
            assert q4matmul.wgmma_plan_splits(din, dout, 32, num_sms, 4096)[1] == 1


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M", [17, 40, 256])
def test_q4_wrapper_matches_pallas_at_any_row_count(M, dt, stacked):
    """The q4 entry point at more rows than a decoding batch, as the
    offline forward calls it, against q4gemm / q4gemm_stacked (member 1 of
    3) in interpret mode."""
    rs = np.random.RandomState(M)
    jdt, tdt = DTYPES[dt]
    lead = (3,) if stacked else ()
    qt = jq.quantize_tensor4(jnp.asarray(rs.randn(*lead, 256, 384).astype(np.float32) * 0.1))
    x = jnp.asarray(rs.randn(M, 256).astype(np.float32), jdt)
    q, scale = _t(qt.q), _t(qt.scale)
    if stacked:
        y_ref = q4gemm_stacked(x, qt.q, qt.scale, jnp.int32(1), block_in=128,
                               block_out=128, interpret=True)
        q, scale = q[1], scale[1]
    else:
        y_ref = q4gemm(x, qt.q, qt.scale, block_in=128, block_out=128, interpret=True)
    y = q4matmul.q4_gemv(_t(x), q, scale)
    assert y.dtype == tdt and tuple(y.shape) == (M, 384)
    assert rel_err(to_np(y), y_ref) <= BOUND[dt]


def test_q4_mma_on_cpu_runs_the_plain_version():
    """On CPU tensors q4_mma, q4_wgmma and the q4_gemv entry point compute
    the plain version and count no launch, whatever the route says: at 16
    rows (q4_mma's route) and at 40 (q4_wgmma's)."""
    rs = np.random.RandomState(4)
    q4 = tq.quantize_tensor4(torch.from_numpy(rs.randn(256, 64).astype(np.float32)))
    counted = (q4matmul.q4_gemv, q4matmul.q4_mma, q4matmul.q4_wgmma)
    counts = [fn.launches for fn in counted]
    for M in (16, 40):
        x = torch.from_numpy(rs.randn(M, 256).astype(np.float32)).to(torch.bfloat16)
        ref = q4matmul.q4_gemv_plain(x, q4.q, q4.scale)
        for fn in (q4matmul.q4_mma, q4matmul.q4_wgmma, q4matmul.q4_gemv,
                   q4matmul.q4_gemv_kernel):
            assert torch.equal(fn(x, q4.q, q4.scale), ref)
        for fn in (q4matmul.q4_mma, q4matmul.q4_wgmma):
            with pytest.raises(ValueError):
                fn(x[:, :128], q4.q, q4.scale)
    assert [fn.launches for fn in counted] == counts


def test_q4_mma_is_built_by_name():
    """q4_mma is a kernel of the build: its source and its C signature (x, q,
    scale, out, partial; batch, din, dout, group_size, groups_per_split,
    splits; stream)."""
    from moshi_tpu_torch.ops import build
    assert (build.CSRC / "q4_mma.cu").is_file()
    p, i = build.SIGNATURES["q4_gemv"][0], build.SIGNATURES["q4_gemv"][4]
    assert build.SIGNATURES["q4_mma"] == [p] * 5 + [i] * 6 + [p]
    assert build.library_path("q4_mma").name.startswith("q4_mma-")


def test_q4_wgmma_is_built_by_name():
    """q4_wgmma is a kernel of the build: its source, q4_mma's C signature,
    and a library named for it."""
    from moshi_tpu_torch.ops import build
    assert (build.CSRC / "q4_wgmma.cu").is_file()
    assert build.SIGNATURES["q4_wgmma"] == build.SIGNATURES["q4_mma"]
    assert build.library_path("q4_wgmma").name.startswith("q4_wgmma-")


@pytest.mark.parametrize("batch", [1, 8, 9, 13, 16])
def test_split_plans_fit_the_staging_limit(batch):
    """At every batch the CUDA-core GEMVs take, a plan's shared memory (the
    warps' and the cluster's sums, x f32 [batch, seg_rows] and the warps'
    rings of weight rows) stays within
    what an H100 block may opt in to, its staged x within GEMV_X_BYTES (in
    segments where a block's rows would not fit), and its rows still cover
    din exactly; the launch asks for no workspace (the C entry points take
    x, q, scale and out, and no partial sums)."""
    from moshi_tpu_torch.ops import build
    for kind, din, dout, grain in (("q4", 4096, 12288, 32), ("q4", 11264, 4096, 32),
                                   ("q4", 4096, 32000, 32), ("q4", 192, 100, 32),
                                   ("q4", 32768, 4096, 32), ("int8", 1024, 3072, 1),
                                   ("int8", 2816, 1024, 1), ("int8", 2048, 32001, 1),
                                   ("int8", 1000, 260, 1), ("int8", 65536, 64, 1)):
        most = q4matmul.Q4_MAX_ACC if kind == "q4" else q4matmul.GEMV_MAX_ACC
        cols = (4,) if dout % 8 else (16, 8, 4)
        cols = tuple(c for c in cols if c <= q4matmul.gemv_max_cols(batch, most))
        plan = q4matmul.gemv_plan(kind, din, dout, batch, 132, grain, cols)
        smem, _ = _resident(kind, batch, plan, 132)
        assert smem <= q4matmul.GEMV_SMEM_LIMIT
        assert 4 * batch * plan.seg_rows <= max(q4matmul.GEMV_X_BYTES, 4 * batch * grain)
        assert plan.seg_rows <= plan.rows_per_block
        covered = sorted(r for rows in _warp_rows(plan, din, grain).values() for r in rows)
        assert covered == list(range(din))
    for name, ints in (("q4_gemv", 10), ("int8_gemv", 9)):
        p, i = ctypes.c_void_p, ctypes.c_int
        assert build.SIGNATURES[name] == [p] * 4 + [i] * ints + [p]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run moshi_tpu's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                             interpret=True))


@pytest.mark.parametrize("B", [1, 16, 33, 200])
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


# the int8 linears above 16 rows: the TTS frame's (at 32 model rows; its
# heads of 32001 and 2049 columns keep the 16-row chunks) and the int8
# training forward's (Moshi-7B's temporal linears and text head at B * T =
# 512 rows), beside the depformer's (INT8_MAIN_SHAPES)
TTS_INT8_SHAPES = ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048), (2048, 32001),
                   (1024, 3072), (1024, 1024), (1024, 5632), (2816, 1024), (2048, 1024),
                   (1024, 2049))
TRAIN_INT8_SHAPES = ((4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096), (4096, 32000))
INT8_ROWS = (17, 32, 64, 512)


@pytest.mark.parametrize("M", INT8_ROWS)
def test_int8_route_above_16_rows(M):
    """bf16 x of more than 16 rows at every depformer, TTS and training
    shape goes to one int8_wgmma launch where dout % 64 == 0 and q is
    16-byte aligned; the TTS heads (odd dout), f32 x and a din off 16 keep
    the 16-row chunks (int8_gemv), q off 16 bytes int8_mma's chunks; 16
    rows stay on int8_mma."""
    bf16 = torch.bfloat16
    for din, dout in INT8_MAIN_SHAPES + TTS_INT8_SHAPES + TRAIN_INT8_SHAPES:
        wide = dout % 64 == 0
        assert qmatmul.route(M, bf16, din, dout, True) == ("int8_wgmma" if wide else "int8_gemv")
        assert qmatmul.route(M, bf16, din, dout, False) == ("int8_mma" if wide else "int8_gemv")
        assert qmatmul.route(M, torch.float32, din, dout, True) == "int8_gemv"
        assert qmatmul.route(M, bf16, din + 8, dout, True) == "int8_gemv"
        assert qmatmul.route(16, bf16, din, dout, True) == ("int8_mma" if wide else "int8_gemv")
    assert (2048, 32001) in TTS_INT8_SHAPES and (1024, 2049) in TTS_INT8_SHAPES


@pytest.mark.parametrize("num_sms", [132, 114])
@pytest.mark.parametrize("M", INT8_ROWS)
def test_int8_wgmma_plans(M, num_sms):
    """int8_wgmma's din splits at the depformer's, the TTS frame's and the
    training forward's shapes: whole stages of 64 din rows covering din, at
    least WGMMA_MIN_SPLIT_ROWS a split, the f32 partials [splits, M, dout]
    within MMA_WORKSPACE_BYTES, and a grid that fills WGMMA_WAVE_FILL of the
    SMs unless those limits keep it from it."""
    stage = qmatmul.WGMMA_STAGE_ROWS
    for din, dout in INT8_MAIN_SHAPES + TTS_INT8_SHAPES + TRAIN_INT8_SHAPES + ((1040, 192),):
        if dout % 64:
            continue
        split_rows, splits = qmatmul.int8_wgmma_plan(din, dout, num_sms, M)
        assert split_rows % stage == 0 and (splits - 1) * split_rows < din <= splits * split_rows
        assert splits == 1 or split_rows >= q4matmul.WGMMA_MIN_SPLIT_ROWS
        assert splits == 1 or 4 * splits * M * dout <= q4matmul.MMA_WORKSPACE_BYTES
        tiles = -(-M // q4matmul.WGMMA_ROWS) * -(-dout // q4matmul.WGMMA_COLS)
        stages = -(-din // stage)
        most = min(stages, max(1, din // q4matmul.WGMMA_MIN_SPLIT_ROWS),
                   max(1, q4matmul.MMA_WORKSPACE_BYTES // (4 * M * dout)))
        most = -(-stages // -(-stages // most))  # the most whole-stage splits within the limits
        fill = q4matmul.WGMMA_WAVE_FILL * num_sms
        assert tiles * splits >= fill or tiles * most < fill


def test_int8_wgmma_on_cpu_runs_the_plain_version():
    """On CPU tensors int8_wgmma and the int8_gemv entry point compute the
    plain version and count no launch, at 40 rows (int8_wgmma's route) and
    at 16; int8_wgmma refuses mismatched shapes."""
    rs = np.random.RandomState(6)
    q8 = tq.quantize_tensor(torch.from_numpy(rs.randn(256, 128).astype(np.float32)))
    counted = (qmatmul.int8_gemv, qmatmul.int8_mma, qmatmul.int8_wgmma)
    counts = [fn.launches for fn in counted]
    for M in (16, 40):
        x = torch.from_numpy(rs.randn(M, 256).astype(np.float32)).to(torch.bfloat16)
        ref = qmatmul.int8_gemv_plain(x, q8.q, q8.scale)
        for fn in (qmatmul.int8_wgmma, qmatmul.int8_gemv):
            assert torch.equal(fn(x, q8.q, q8.scale), ref)
        with pytest.raises(ValueError):
            qmatmul.int8_wgmma(x[:, :128], q8.q, q8.scale)
    assert [fn.launches for fn in counted] == counts


def test_int8_wgmma_is_built_by_name():
    """int8_wgmma is a kernel of the build: its source, its C signature (x,
    q, scale, out, partial; M, din, dout, split_rows, splits; stream), a
    library named for it, and the shared wgmma header beside q4_wgmma's."""
    from moshi_tpu_torch.ops import build
    assert (build.CSRC / "int8_wgmma.cu").is_file()
    p, i = build.SIGNATURES["int8_gemv"][0], build.SIGNATURES["int8_gemv"][5]
    assert build.SIGNATURES["int8_wgmma"] == [p] * 5 + [i] * 5 + [p]
    assert build.library_path("int8_wgmma").name.startswith("int8_wgmma-")
    for name in ("int8_wgmma", "q4_wgmma"):
        assert '#include "wgmma_common.cuh"' in (build.CSRC / f"{name}.cu").read_text()


# decode_attention_int8's main-path shapes (B, H, cap): ASR B = 256, Moshi B = 16
K6_MAIN_SHAPES = ((256, 8, 750), (16, 32, 3000))


@pytest.mark.parametrize("B,H,cap", K6_MAIN_SHAPES)
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("num_sms", [132, 114])
def test_int8_attention_plans_fill_the_card(B, H, cap, D, num_sms):
    """plan_splits cuts cap into 1..8 splits of a multiple of SPLIT_GRAIN
    positions that cover it exactly, every split non-empty; its grid has
    at least MIN_FILL of the SMs' worth of blocks and all of them fit on
    the card at once at WARPS_PER_SM warps per SM (no last wave), in
    blocks of a power of two of warps whose shared memory stays within
    48 KB.  At D = 128 both main-path shapes need no split."""
    splits, per, warps = da8.plan_splits(B, H, D, cap, num_sms)
    assert 1 <= splits <= da8.MAX_CLUSTER == 8
    assert per % da8.SPLIT_GRAIN == 0 and per == da8.split_length(cap, splits)
    assert (splits - 1) * per < cap <= splits * per
    blocks = B * -(-H // da8.heads_per_block(D)) * splits
    assert blocks >= da8.MIN_FILL * num_sms
    assert warps & (warps - 1) == 0 and 1 <= warps <= da8.MAX_WARPS
    assert blocks * warps <= da8.WARPS_PER_SM * num_sms < 2 * blocks * warps
    assert da8.smem_bytes(D, warps, splits) <= 48 * 1024
    if D == 128:
        assert splits == 1


@pytest.mark.parametrize("cap", [1, 5, 16, 100, 1001, 3000])
def test_int8_attention_plans_of_small_and_ragged_caps(cap):
    """A cap below a tile, at one grain or no multiple of it still gets
    splits that cover it exactly with none empty, and a grid of few (slot,
    head) pairs is split (at most 8 ways) toward MIN_FILL of the SMs."""
    for B, H, D in ((1, 4, 128), (3, 8, 64), (1, 32, 128), (16, 32, 64)):
        splits, per, warps = da8.plan_splits(B, H, D, cap, 132)
        assert (splits - 1) * per < cap <= splits * per
        assert da8.smem_bytes(D, warps, splits) <= 48 * 1024
        blocks = B * -(-H // da8.heads_per_block(D))
        more = -(-cap // da8.split_length(cap, splits + 1)) == splits + 1  # none empty
        assert blocks * splits >= da8.MIN_FILL * 132 or splits == 8 or not more


def test_decode_attention_int8_is_built_by_name():
    """decode_attention_int8's C signature: q, k_all, v_all, k_scale,
    v_scale, mask, out; layer, B, H, Hkv, D, cap, per_split, splits, warps;
    stream."""
    from moshi_tpu_torch.ops import build
    p, i = build.SIGNATURES["int8_gemv"][0], build.SIGNATURES["int8_gemv"][5]
    assert build.SIGNATURES["decode_attention_int8"] == [p] * 7 + [i] * 9 + [p]
    assert build.library_path("decode_attention_int8").name.startswith("decode_attention_int8-")


# decode_attention_int4's shapes (B, H, Hkv, cap): Moshi's B = 16 int4 frame,
# grouped KV heads, small and ragged caps, two groups of query heads on one
# KV head
K4_SHAPES = ((16, 32, 32, 3000), (16, 32, 16, 3000), (16, 32, 8, 3000), (3, 4, 4, 1001),
             (2, 8, 2, 200), (1, 18, 2, 5))


@pytest.mark.parametrize("B,H,Hkv,cap", K4_SHAPES)
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("num_sms", [132, 114])
def test_int4_attention_plans_fit_the_card(B, H, Hkv, cap, D, num_sms):
    """plan_warps gives 1..8 warps, no more than the cap has chunks, whose
    grid fits on the card at once at WARPS_PER_SM warps per SM (a grid of
    more blocks than that takes one warp each), and whose shared memory
    stays within 48 KB.  Moshi's B = 16 frame runs 512 blocks: 4 warps each
    on 132 SMs, 3 on 114."""
    warps = i4.plan_warps(B, H, Hkv, cap, num_sms)
    blocks = i4.attention_blocks(B, H, Hkv)
    assert 1 <= warps <= i4.MAX_WARPS == 8
    assert warps <= -(-cap // i4.CHUNK)
    assert blocks * warps <= i4.WARPS_PER_SM * num_sms or warps == 1
    assert i4.smem_bytes(D, warps) <= i4.SMEM_LIMIT == 48 * 1024
    if (B, H, Hkv, cap) == (16, 32, 32, 3000):
        assert blocks == 512 and warps == {132: 4, 114: 3}[num_sms]


@pytest.mark.parametrize("cap", [1, 5, 63, 64, 65, 200, 1001, 3000, 3072])
def test_int4_attention_chunks_cover_cap(cap):
    """The kernel's chunks of CHUNK positions cover cap exactly, the last
    one inside the cache's cap_pad (cap rounded up to 128); the warps of a
    block, taking chunks w, w + warps, .., take every chunk once."""
    cap_pad = -(-cap // 128) * 128
    n = -(-cap // i4.CHUNK)
    assert (n - 1) * i4.CHUNK < cap <= n * i4.CHUNK <= cap_pad
    assert cap_pad % i4.CHUNK == 0
    for warps in range(1, i4.MAX_WARPS + 1):
        assert sorted(c for w in range(warps) for c in range(w, n, warps)) == list(range(n))


def test_int4_attention_constants_are_the_kernels():
    """The wrapper's CHUNK, MAX_WARPS and HEADS_PER_BLOCK are the kernel
    source's kChunk (8 * kW), kMaxWarps and kHeads."""
    import re
    src = (i4.build.CSRC / "decode_attention_int4.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert re.search(r"constexpr int kChunk = 8 \* kW;", src)
    assert i4.CHUNK == 8 * const("kW")
    assert i4.MAX_WARPS == const("kMaxWarps")
    assert i4.HEADS_PER_BLOCK == const("kHeads")


def test_decode_attention_int4_is_built_by_name():
    """decode_attention_int4's C signature: q, k_all, v_all, k_scale,
    v_scale, mask, kk, vv, pos, acc, m, l; layer, B, H, Hkv, D, cap,
    cap_pad, warps, kk_stride, vv_stride; stream."""
    from moshi_tpu_torch.ops import build
    p, i = build.SIGNATURES["int8_gemv"][0], build.SIGNATURES["int8_gemv"][5]
    assert build.SIGNATURES["decode_attention_int4"] == [p] * 12 + [i] * 10 + [p]


def test_every_kernel_source_is_built():
    """build.SIGNATURES names exactly the sources in csrc/ (the cache write
    has no source of its own: it runs in decode_attention_int4's launch)."""
    from moshi_tpu_torch.ops import build
    assert set(build.SIGNATURES) == {f.stem for f in build.CSRC.glob("*.cu")}
    assert "cache_write_int4" not in build.SIGNATURES
    assert build.library_path("decode_attention_int4").name.startswith("decode_attention_int4-")
