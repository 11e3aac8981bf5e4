"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from moshi_tpu_torch.modules.transformer import _quant_rows
from moshi_tpu_torch.ops import decode_attention as da8, int4_attention as i4, q4matmul, qmatmul
from moshi_tpu_torch.utils import quantize as tq

pytestmark = pytest.mark.cuda

# max |kernel - plain| / max |plain|: f32 differs by summation order only,
# bf16 by the plain version's bf16 rounding of the dequantized weights
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the q4 entry point (bf16 B >= 2 goes to q4_mma) and the int8_gemv kernel
# on the CUDA cores (int8_mma has its own tests below)
KERNELS = {"q4": (q4matmul.q4_gemv, q4matmul.q4_gemv_plain, tq.quantize_tensor4),
           "int8": (qmatmul.int8_gemv_kernel, qmatmul.int8_gemv_plain, tq.quantize_tensor)}
# the wrapper whose `launches` counts each family's CUDA-core kernel
COUNTED = {"q4": q4matmul.q4_gemv, "int8": qmatmul.int8_gemv}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(y, ref):
    return ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", range(1, 17))
def test_every_batch_size(kernel, dtype, B, gen):
    fn, plain, quant = KERNELS[kernel]
    din, dout = 1024, 1536
    qt = quant(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(B, din, device="cuda", generator=gen).to(dtype)
    y = fn(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (B, dout)
    assert _rel(y, plain(x, qt.q, qt.scale)) <= BOUND[dtype]


RAGGED = [(k, din, dout) for k in sorted(KERNELS)
          for din, dout in ((64, 4), (128, 516), (4160, 8192), (192, 100))]
RAGGED.append(("int8", 1000, 260))


@pytest.mark.parametrize("kernel,din,dout", RAGGED)
def test_ragged_shapes(kernel, din, dout, gen):
    """Column counts that leave a block part-full, a last din split shorter
    than the others (4160 = 130 q4 groups, 1000 int8 rows), one split."""
    fn, plain, quant = KERNELS[kernel]
    qt = quant(torch.randn(din, dout, device="cuda", generator=gen))
    x = torch.randn(3, din, device="cuda", generator=gen)
    y = fn(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert _rel(y, plain(x, qt.q, qt.scale)) <= BOUND[torch.float32]


def test_stacked_member_view(gen):
    """q4_gemv on the view q[l] of a stacked weight reads member l."""
    qt = tq.quantize_tensor4(torch.randn(3, 1, 512, 768, device="cuda", generator=gen))
    x = torch.randn(1, 512, device="cuda", generator=gen)
    for layer in range(3):
        y = q4matmul.q4_gemv(x, qt.q[layer][0], qt.scale[layer][0])
        ref = q4matmul.q4_gemv_plain(x, qt.q[layer][0], qt.scale[layer][0])
        assert _rel(y, ref) <= BOUND[torch.float32]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_deterministic_and_counted(kernel, gen):
    """Two launches give the same bits (no atomics), and each adds one to
    the launch count of the kernel it went to: where q4_gemv routes bf16 at
    B = 2 to q4_mma, the q4_gemv kernel's count stays; the int8_gemv
    kernel's wrapper counts on int8_gemv, never on int8_mma."""
    fn, _, quant = KERNELS[kernel]
    counted = COUNTED[kernel]
    qt = quant(torch.randn(4096, 1024, device="cuda", generator=gen))
    x = torch.randn(2, 4096, device="cuda", generator=gen).to(torch.bfloat16)
    n, m, m8 = counted.launches, q4matmul.q4_mma.launches, qmatmul.int8_mma.launches
    a, b = fn(x, qt.q, qt.scale), fn(x, qt.q, qt.scale)
    assert torch.equal(a, b)
    to_mma = kernel == "q4" and q4matmul.use_mma(2, torch.bfloat16, 32, 1024)
    assert (counted.launches, q4matmul.q4_mma.launches) == ((n, m + 2) if to_mma else (n + 2, m))
    assert qmatmul.int8_mma.launches == m8


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_rejects_what_the_kernel_does_not_take(kernel, gen):
    fn, _, quant = KERNELS[kernel]
    qt = quant(torch.randn(256, 128, device="cuda", generator=gen))
    x = torch.randn(17, 256, device="cuda", generator=gen)
    if kernel == "int8":
        with pytest.raises(ValueError):
            fn(x, qt.q, qt.scale)                  # batch above the kernel's 16
    else:
        with pytest.raises(ValueError):
            fn(x[:0], qt.q, qt.scale)              # no rows (q4 takes any count above)
    with pytest.raises(ValueError):
        fn(x[:2], qt.q.cpu(), qt.scale)            # mixed devices
    with pytest.raises(TypeError):
        fn(x[:2].half(), qt.q, qt.scale)           # fp16 activations
    with pytest.raises(ValueError):
        fn(torch.randn(256, 2, device="cuda").T, qt.q, qt.scale)  # not contiguous


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("B", [9, 16])
def test_batched_main_path_shape(kernel, B, gen):
    """B = 9 and 16 at the widest main-path shape of each kernel, where the
    split planner caps the staged rows at 48 KB of shared memory."""
    fn, plain, quant = KERNELS[kernel]
    din, dout = (11264, 4096) if kernel == "q4" else (2816, 1024)
    qt = quant(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(B, din, device="cuda", generator=gen).to(torch.bfloat16)
    y = fn(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert _rel(y, plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


# q4_mma (tensor cores): bf16 x only, so every check is held to the bf16
# bound; the Moshi-7B shapes (din, dout) of the q4 linears
MMA = q4matmul.q4_mma
Q4_MAIN_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096), (4096, 32000)]


def _mma_case(gen, B, din, dout, group_size=32):
    qt = tq.quantize_tensor4(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5,
                             group_size=group_size)
    x = torch.randn(B, din, device="cuda", generator=gen).to(torch.bfloat16)
    return x, qt


@pytest.mark.parametrize("B", range(2, 17))
def test_q4_mma_every_batch_size(B, gen):
    x, qt = _mma_case(gen, B, 1024, 1536)
    n = MMA.launches
    y = MMA(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert MMA.launches == n + 1
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (B, 1536)
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


@pytest.mark.parametrize("B,din,dout,group_size", [(3, 4160, 8256, 32), (7, 64, 64, 32),
                                                   (16, 256, 192, 64), (5, 2048, 320, 16)])
def test_q4_mma_ragged_shapes(B, din, dout, group_size, gen):
    """A last block with one warp's columns in use, a last din split
    shorter than the others (4160 = 130 groups), one split, other group
    sizes."""
    x, qt = _mma_case(gen, B, din, dout, group_size)
    y = MMA(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


def test_q4_mma_stacked_member_view(gen):
    """q4_mma on the view q[l] of a stacked weight reads member l."""
    qt = tq.quantize_tensor4(torch.randn(3, 1, 512, 768, device="cuda", generator=gen))
    x = torch.randn(16, 512, device="cuda", generator=gen).to(torch.bfloat16)
    for layer in range(3):
        y = MMA(x, qt.q[layer][0], qt.scale[layer][0])
        ref = q4matmul.q4_gemv_plain(x, qt.q[layer][0], qt.scale[layer][0])
        assert _rel(y, ref) <= BOUND[torch.bfloat16]


def test_q4_mma_deterministic_and_counted(gen):
    """Two launches give the same bits (splits added in order, no atomics);
    each adds one to q4_mma's count and none to the q4_gemv kernel's."""
    x, qt = _mma_case(gen, 16, 4096, 4096)
    n, m = q4matmul.q4_gemv.launches, MMA.launches
    a, b = MMA(x, qt.q, qt.scale), MMA(x, qt.q, qt.scale)
    assert torch.equal(a, b)
    assert (q4matmul.q4_gemv.launches, MMA.launches) == (n, m + 2)


@pytest.mark.parametrize("din,dout", Q4_MAIN_SHAPES)
def test_q4_mma_main_path_shapes(din, dout, gen):
    """B = 16 at the Moshi-7B shapes, through the entry point q4_gemv (the
    route the batched frame takes), against the plain version and against
    the q4_gemv kernel on the same operands."""
    x, qt = _mma_case(gen, 16, din, dout)
    assert q4matmul.use_mma(16, torch.bfloat16, 32, dout)
    m = MMA.launches
    y = q4matmul.q4_gemv(x, qt.q, qt.scale)
    simt = q4matmul.q4_gemv_kernel(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert MMA.launches == m + 1
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]
    assert _rel(y, simt) <= BOUND[torch.bfloat16]


def test_q4_mma_rejects_what_the_kernel_does_not_take(gen):
    x, qt = _mma_case(gen, 4, 256, 128)
    with pytest.raises(TypeError):
        MMA(x.float(), qt.q, qt.scale)                   # f32 activations
    with pytest.raises(ValueError):
        MMA(x[:0], qt.q, qt.scale)                       # no rows
    x96, q96 = _mma_case(gen, 4, 256, 96)
    with pytest.raises(ValueError):
        MMA(x96, q96.q, q96.scale)                       # dout not a multiple of 64
    x8, q8 = _mma_case(gen, 4, 256, 128, group_size=8)
    with pytest.raises(ValueError):
        MMA(x8, q8.q, q8.scale)                          # group size not a multiple of 16
    with pytest.raises(ValueError):
        MMA(x, qt.q.cpu(), qt.scale)                     # mixed devices
    with pytest.raises(ValueError):
        MMA(torch.randn(256, 4, device="cuda").to(torch.bfloat16).T, qt.q, qt.scale)
    x17, _ = _mma_case(gen, 17, 256, 128)
    with pytest.raises(ValueError):
        MMA(x17, qt.q, qt.scale)                         # above a decoding batch: q4_wgmma's


@pytest.mark.parametrize("din,dout", [(1024, 1536), (11264, 4096), (4096, 32000)])
@pytest.mark.parametrize("M", [17, 64, 256])
def test_q4_mma_any_row_count(M, din, dout, gen):
    """Above a decoding batch, as the offline forward calls it through the
    entry point: one q4_wgmma launch and none of q4_mma or the q4_gemv
    kernel, against the plain version and equal to q4_wgmma called
    directly (splits added in order)."""
    x, qt = _mma_case(gen, M, din, dout)
    assert q4matmul.route(M, torch.bfloat16, 32, dout) == "q4_wgmma"
    counted = (q4matmul.q4_gemv, MMA, WG)
    n = [fn.launches for fn in counted]
    y = q4matmul.q4_gemv(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert [fn.launches - k for fn, k in zip(counted, n)] == [0, 0, 1]
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (M, dout)
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]
    assert torch.equal(y, WG(x, qt.q, qt.scale))


# q4_wgmma (wgmma over 128-row tiles): bf16 x only, held to the bf16 bound
WG = q4matmul.q4_wgmma


def _wg_check(x, qt):
    """One q4_wgmma call against the plain version: exactly one q4_wgmma
    launch counted and none of q4_mma or the q4_gemv kernel."""
    counted = (q4matmul.q4_gemv, MMA, WG)
    n = [fn.launches for fn in counted]
    y = WG(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert [fn.launches - k for fn, k in zip(counted, n)] == [0, 0, 1]
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (x.shape[0], qt.q.shape[-1])
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]
    return y


@pytest.mark.parametrize("M", [17, 63, 64, 65, 128, 129, 256, 300])
def test_q4_wgmma_every_row_edge(M, gen):
    """The row edges of the 64-row warpgroups and 128-row blocks: a dead
    warpgroup (M <= 64), a part-full one, a second row tile."""
    _wg_check(*_mma_case(gen, M, 1024, 1536))


@pytest.mark.parametrize("M", [64, 256])
@pytest.mark.parametrize("din,dout", Q4_MAIN_SHAPES)
def test_q4_wgmma_main_path_shapes(din, dout, M, gen):
    """The Moshi-7B q4 shapes at the offline forward's M = 256 and at 64,
    split and unsplit as the planner says."""
    _wg_check(*_mma_case(gen, M, din, dout))


# din by group size: a last stage of 32 din (480, 4160 = 65 stages of 64),
# groups of 48 straddling stages, groups of 64 one to a stage
GROUP_DIN = {16: 480, 32: 4160, 48: 480, 64: 1152}


@pytest.mark.parametrize("M", [40, 200])
@pytest.mark.parametrize("group_size", sorted(GROUP_DIN))
def test_q4_wgmma_group_sizes(group_size, M, gen):
    _wg_check(*_mma_case(gen, M, GROUP_DIN[group_size], 640, group_size))


@pytest.mark.parametrize("dout", [64, 192])
def test_q4_wgmma_narrow_dout(dout, gen):
    """Fewer columns than a block's 128 (64) and a last block half full."""
    _wg_check(*_mma_case(gen, 130, 512, dout))


def test_q4_wgmma_stacked_member_view(gen):
    """q4_wgmma on the view q[l] of a stacked weight reads member l."""
    qt = tq.quantize_tensor4(torch.randn(3, 1, 512, 768, device="cuda", generator=gen))
    x = torch.randn(100, 512, device="cuda", generator=gen).to(torch.bfloat16)
    for layer in range(3):
        y = WG(x, qt.q[layer][0], qt.scale[layer][0])
        ref = q4matmul.q4_gemv_plain(x, qt.q[layer][0], qt.scale[layer][0])
        assert _rel(y, ref) <= BOUND[torch.bfloat16]


@pytest.mark.parametrize("M", [17, 256])
def test_q4_wgmma_deterministic_and_counted(M, gen):
    """Two calls give the same bytes (split partials added in order, no
    atomics); each counts one q4_wgmma launch."""
    x, qt = _mma_case(gen, M, 4096, 4096)
    a, b = _wg_check(x, qt), _wg_check(x, qt)
    assert torch.equal(a, b)


def test_q4_wgmma_takes_unaligned_rows(gen):
    """x whose address is off 16 bytes (a view two bytes in) is copied by
    the wrapper, as q4_mma staged it with scalar loads: same result."""
    x, qt = _mma_case(gen, 40, 1024, 256)
    buf = torch.empty(40 * 1024 + 1, dtype=torch.bfloat16, device="cuda")
    xu = buf[1:].view(40, 1024)
    xu.copy_(x)
    assert xu.data_ptr() % 16
    assert torch.equal(_wg_check(xu, qt), WG(x, qt.q, qt.scale))


def test_q4_wgmma_rejects_what_the_kernel_does_not_take(gen):
    x, qt = _mma_case(gen, 40, 256, 128)
    with pytest.raises(TypeError):
        WG(x.float(), qt.q, qt.scale)                    # f32 activations
    with pytest.raises(TypeError):
        WG(x.half(), qt.q, qt.scale)                     # fp16 activations
    with pytest.raises(ValueError):
        WG(x[:0], qt.q, qt.scale)                        # no rows
    q_buf = torch.empty(qt.q.numel() + 8, dtype=torch.int8, device="cuda")
    q_off = q_buf[8:].view(qt.q.shape)
    q_off.copy_(qt.q)
    with pytest.raises(ValueError):
        WG(x, q_off, qt.scale)                           # q 8 bytes off 16
    s_buf = torch.empty(qt.scale.numel() + 1, device="cuda")
    s_off = s_buf[1:].view(qt.scale.shape)
    s_off.copy_(qt.scale)
    with pytest.raises(ValueError):
        WG(x, qt.q, s_off)                               # scale 4 bytes off 16
    x96, q96 = _mma_case(gen, 40, 256, 96)
    with pytest.raises(ValueError):
        WG(x96, q96.q, q96.scale)                        # dout not a multiple of 64
    x8, q8 = _mma_case(gen, 40, 256, 128, group_size=8)
    with pytest.raises(ValueError):
        WG(x8, q8.q, q8.scale)                           # group size not a multiple of 16


def test_q4_f32_route_any_row_count(gen):
    """f32 x of 40 rows goes to the q4_gemv kernel in chunks of 16 rows:
    three launches, against the plain version."""
    qt = tq.quantize_tensor4(torch.randn(4096, 4096, device="cuda", generator=gen) / 64)
    x = torch.randn(40, 4096, device="cuda", generator=gen)
    n, m, w = q4matmul.q4_gemv.launches, MMA.launches, WG.launches
    y = q4matmul.q4_gemv(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert (q4matmul.q4_gemv.launches, MMA.launches, WG.launches) == (n + 3, m, w)
    assert y.dtype == torch.float32 and tuple(y.shape) == (40, 4096)
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.float32]


# int8_mma (tensor cores): bf16 x only; the Moshi-7B depformer's shapes
# (din, dout) of the int8 linears
MMA8 = qmatmul.int8_mma
INT8_MAIN_SHAPES = [(1024, 3072), (1024, 1024), (1024, 5632), (2816, 1024), (1024, 2048),
                    (4096, 1024)]


def _mma8_case(gen, B, din, dout):
    qt = tq.quantize_tensor(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(B, din, device="cuda", generator=gen).to(torch.bfloat16)
    return x, qt


@pytest.mark.parametrize("B", range(1, 17))
def test_int8_mma_every_batch_size(B, gen):
    x, qt = _mma8_case(gen, B, 1024, 1536)
    n = MMA8.launches
    y = MMA8(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert MMA8.launches == n + 1
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (B, 1536)
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


@pytest.mark.parametrize("B,din,dout", [(3, 1008, 192), (9, 2064, 64), (7, 16, 64),
                                        (16, 4160, 8256), (5, 48, 128)])
def test_int8_mma_ragged_shapes(B, din, dout, gen):
    """A last cluster rank shorter than the others (1008 rows in 8 ranks of
    128, 2064 in 8 of 272), one block (din = 16), a wide layer, a cluster of
    3 one-step ranks."""
    x, qt = _mma8_case(gen, B, din, dout)
    y = MMA8(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


def test_int8_mma_stacked_member_view(gen):
    """int8_mma on the view q[l] of a stacked weight reads member l."""
    qt = tq.quantize_tensor(torch.randn(3, 1, 512, 768, device="cuda", generator=gen))
    x = torch.randn(16, 512, device="cuda", generator=gen).to(torch.bfloat16)
    for layer in range(3):
        y = MMA8(x, qt.q[layer][0], qt.scale[layer][0])
        ref = qmatmul.int8_gemv_plain(x, qt.q[layer][0], qt.scale[layer][0])
        assert _rel(y, ref) <= BOUND[torch.bfloat16]


def test_int8_mma_deterministic_and_counted(gen):
    """Two launches give the same bits (the din split added in a fixed
    order, no atomics); each adds one to int8_mma's count and none to the
    int8_gemv kernel's."""
    x, qt = _mma8_case(gen, 16, 4096, 1024)
    n, m = qmatmul.int8_gemv.launches, MMA8.launches
    a, b = MMA8(x, qt.q, qt.scale), MMA8(x, qt.q, qt.scale)
    assert torch.equal(a, b)
    assert (qmatmul.int8_gemv.launches, MMA8.launches) == (n, m + 2)


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("din,dout", INT8_MAIN_SHAPES)
def test_int8_mma_main_path_shapes(din, dout, B, gen):
    """B = 1 and 16 at the depformer's shapes, through the entry point
    int8_gemv (the route both frames take), against the plain version and
    against the int8_gemv kernel on the same operands."""
    x, qt = _mma8_case(gen, B, din, dout)
    assert qmatmul.use_mma(B, torch.bfloat16, din, dout)
    n, m = qmatmul.int8_gemv.launches, MMA8.launches
    y = qmatmul.int8_gemv(x, qt.q, qt.scale)
    assert (qmatmul.int8_gemv.launches, MMA8.launches) == (n, m + 1)
    simt = qmatmul.int8_gemv_kernel(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]
    assert _rel(y, simt) <= BOUND[torch.bfloat16]


# the TTS heads: dout not a multiple of 4 (32001 text columns, 2049 audio
# ones), so rows are not 32-bit aligned and the int8_gemv kernel reads bytes
ODD_DOUT = [(2048, 32001), (1024, 2049), (64, 5), (96, 1), (1000, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("din,dout", ODD_DOUT)
def test_int8_gemv_odd_dout(din, dout, B, dtype, gen):
    """Any dout: the entry point routes it to the int8_gemv kernel (not
    int8_mma), which reads each column once and writes none past dout."""
    qt = tq.quantize_tensor(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(B, din, device="cuda", generator=gen).to(dtype)
    assert not qmatmul.use_mma(B, dtype, din, dout)
    n, m = qmatmul.int8_gemv.launches, MMA8.launches
    y = qmatmul.int8_gemv(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert (qmatmul.int8_gemv.launches, MMA8.launches) == (n + 1, m)
    assert tuple(y.shape) == (B, dout) and bool(torch.isfinite(y).all())
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[dtype]


def test_int8_gemv_unaligned_member_view(gen):
    """Members of a stacked [3, 65, 7] weight start off a 4-byte boundary
    (65 * 7 bytes apart): each view reads its own member."""
    qt = tq.quantize_tensor(torch.randn(3, 65, 7, device="cuda", generator=gen))
    x = torch.randn(16, 65, device="cuda", generator=gen).to(torch.bfloat16)
    assert qt.q[1].data_ptr() % 4
    for layer in range(3):
        y = qmatmul.int8_gemv(x, qt.q[layer], qt.scale[layer])
        ref = qmatmul.int8_gemv_plain(x, qt.q[layer], qt.scale[layer])
        assert _rel(y, ref) <= BOUND[torch.bfloat16]


def test_int8_mma_rejects_what_the_kernel_does_not_take(gen):
    x, qt = _mma8_case(gen, 4, 256, 128)
    with pytest.raises(TypeError):
        MMA8(x.float(), qt.q, qt.scale)                  # f32 activations
    with pytest.raises(ValueError):
        MMA8(torch.cat([x] * 5), qt.q, qt.scale)         # batch above 16
    x96, q96 = _mma8_case(gen, 4, 256, 96)
    with pytest.raises(ValueError):
        MMA8(x96, q96.q, q96.scale)                      # dout not a multiple of 64
    x24, q24 = _mma8_case(gen, 4, 24, 128)
    with pytest.raises(ValueError):
        MMA8(x24, q24.q, q24.scale)                      # din not a multiple of 16
    with pytest.raises(ValueError):
        MMA8(x, qt.q.cpu(), qt.scale)                    # mixed devices
    with pytest.raises(ValueError):
        MMA8(torch.randn(256, 4, device="cuda").to(torch.bfloat16).T, qt.q, qt.scale)
    odd = torch.zeros(4 * 256 + 1, device="cuda", dtype=torch.bfloat16)[1:].view(4, 256)
    with pytest.raises(ValueError):
        MMA8(odd, qt.q, qt.scale)                        # x not 8-byte aligned


def test_int8_mma_c_entry_rejects_what_it_does_not_take(gen):
    """The C entry returns cudaErrorInvalidValue (1) and launches nothing
    for what the wrapper would not pass on."""
    from moshi_tpu_torch.ops import build
    x, qt = _mma8_case(gen, 16, 256, 128)
    out = torch.empty(16, 128, device="cuda", dtype=torch.bfloat16)
    lib = build.load("int8_mma")
    stream = torch.cuda.current_stream().cuda_stream

    def call(batch=16, din=256, dout=128, rows=128, cluster=2, xp=0, qp=0, sp=0):
        return lib.int8_mma(x.data_ptr() + xp, qt.q.data_ptr() + qp, qt.scale.data_ptr() + sp,
                            out.data_ptr(), batch, din, dout, rows, cluster, stream)
    assert call() == 0
    for bad in ({"batch": 0}, {"batch": 17}, {"dout": 96}, {"din": 248}, {"rows": 120},
                {"cluster": 9}, {"cluster": 1}, {"xp": 2}, {"qp": 4}, {"sp": 4}):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()
    assert _rel(out, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


# int8_wgmma (wgmma over 128-row tiles): bf16 x of more than 16 rows, held
# to the bf16 bound; the TTS frame's shapes at 32 model rows and the int8
# training forward's at 512 beside the depformer's
WG8 = qmatmul.int8_wgmma
TTS_WG8_SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048), (2048, 1024)]
TRAIN_WG8_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096), (4096, 32000)]


def _wg8_check(x, qt):
    """One int8_wgmma call against the plain version: exactly one
    int8_wgmma launch counted and none of int8_mma or the int8_gemv
    kernel."""
    counted = (qmatmul.int8_gemv, MMA8, WG8)
    n = [fn.launches for fn in counted]
    y = WG8(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert [fn.launches - k for fn, k in zip(counted, n)] == [0, 0, 1]
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (x.shape[0], qt.q.shape[-1])
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]
    return y


@pytest.mark.parametrize("M", [17, 63, 64, 65, 127, 128, 129, 200, 512])
def test_int8_wgmma_every_row_edge(M, gen):
    """The row edges of the 64-row warpgroups and 128-row blocks: a dead
    warpgroup (M <= 64), a part-full one, a second and a fifth row tile."""
    _wg8_check(*_mma8_case(gen, M, 1024, 1536))


@pytest.mark.parametrize("din,dout,M", [(din, dout, M) for din, dout in INT8_MAIN_SHAPES
                                        for M in (32, 64, 512)]
                         + [(din, dout, 32) for din, dout in TTS_WG8_SHAPES]
                         + [(din, dout, 512) for din, dout in TRAIN_WG8_SHAPES])
def test_int8_wgmma_main_path_shapes(din, dout, M, gen):
    """The main paths' shapes through the entry point int8_gemv: one
    int8_wgmma launch, split and unsplit as the planner says, against the
    plain version and equal to int8_wgmma called directly."""
    x, qt = _mma8_case(gen, M, din, dout)
    assert qmatmul.route(M, torch.bfloat16, din, dout, qt.q.data_ptr() % 16 == 0) == "int8_wgmma"
    counted = (qmatmul.int8_gemv, MMA8, WG8)
    n = [fn.launches for fn in counted]
    y = qmatmul.int8_gemv(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert [fn.launches - k for fn, k in zip(counted, n)] == [0, 0, 1]
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]
    assert torch.equal(y, _wg8_check(x, qt))


@pytest.mark.parametrize("din,dout", [(16, 64), (1040, 192), (80, 128), (4112, 640)])
def test_int8_wgmma_ragged_shapes(din, dout, gen):
    """A din of one k16 step, a last stage short of 64 (1040, 80, 4112),
    a last column tile half full (192, 640), split and unsplit."""
    _wg8_check(*_mma8_case(gen, 100, din, dout))


def test_int8_wgmma_stacked_member_view(gen):
    """int8_wgmma on the view q[l] of a stacked weight reads member l."""
    qt = tq.quantize_tensor(torch.randn(3, 1, 512, 768, device="cuda", generator=gen))
    x = torch.randn(100, 512, device="cuda", generator=gen).to(torch.bfloat16)
    for layer in range(3):
        assert qt.q[layer][0].data_ptr() % 16 == 0
        y = qmatmul.int8_gemv(x, qt.q[layer][0], qt.scale[layer][0])
        ref = qmatmul.int8_gemv_plain(x, qt.q[layer][0], qt.scale[layer][0])
        assert _rel(y, ref) <= BOUND[torch.bfloat16]
        assert torch.equal(y, _wg8_check(x, tq.QTensor(qt.q[layer][0], qt.scale[layer][0])))


@pytest.mark.parametrize("M", [17, 512])
def test_int8_wgmma_deterministic_and_counted(M, gen):
    """Two calls give the same bytes (split partials added in order, no
    atomics); each counts one int8_wgmma launch."""
    x, qt = _mma8_case(gen, M, 1024, 1024)
    assert qmatmul.int8_wgmma_plan(1024, 1024, _num_sms(), M)[1] > 1
    a, b = _wg8_check(x, qt), _wg8_check(x, qt)
    assert torch.equal(a, b)


def test_int8_wgmma_takes_unaligned_rows(gen):
    """x whose address is off 16 bytes (a view two bytes in) is copied by
    the wrapper: same result as the aligned x."""
    x, qt = _mma8_case(gen, 40, 1024, 256)
    buf = torch.empty(40 * 1024 + 1, dtype=torch.bfloat16, device="cuda")
    xu = buf[1:].view(40, 1024)
    xu.copy_(x)
    assert xu.data_ptr() % 16
    assert torch.equal(_wg8_check(xu, qt), WG8(x, qt.q, qt.scale))


def test_int8_wgmma_writes_nothing_past_y(gen):
    """At 200 rows (the second row tile 72 rows full) and a split plan, no
    byte of a guard band of rows before and after y, and after the split
    partials, is written."""
    from moshi_tpu_torch.ops import build
    M, din, dout, G, sentinel = 200, 2048, 1024, 64, 7.0
    x, qt = _mma8_case(gen, M, din, dout)
    split_rows, splits = qmatmul.int8_wgmma_plan(din, dout, _num_sms(), M)
    assert splits > 1
    ybuf = torch.full((M + 2 * G, dout), sentinel, dtype=torch.bfloat16, device="cuda")
    pbuf = torch.full((splits * M + 2 * G, dout), sentinel, dtype=torch.float32, device="cuda")
    y, partial = ybuf[G:G + M], pbuf[G:G + splits * M]
    lib = build.load("int8_wgmma")
    err = lib.int8_wgmma(x.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(), y.data_ptr(),
                         partial.data_ptr(), M, din, dout, split_rows, splits,
                         torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "int8_wgmma")
    torch.cuda.synchronize()
    assert torch.equal(y, _wg8_check(x, qt))
    for band in (ybuf[:G], ybuf[G + M:], pbuf[:G], pbuf[G + splits * M:]):
        assert (band == sentinel).all()


def test_int8_wgmma_rejects_what_the_kernel_does_not_take(gen):
    x, qt = _mma8_case(gen, 40, 256, 128)
    with pytest.raises(TypeError):
        WG8(x.float(), qt.q, qt.scale)                   # f32 activations
    with pytest.raises(TypeError):
        WG8(x.half(), qt.q, qt.scale)                    # fp16 activations
    with pytest.raises(ValueError):
        WG8(x[:0], qt.q, qt.scale)                       # no rows
    x96, q96 = _mma8_case(gen, 40, 256, 96)
    with pytest.raises(ValueError):
        WG8(x96, q96.q, q96.scale)                       # dout not a multiple of 64
    x24, q24 = _mma8_case(gen, 40, 24, 128)
    with pytest.raises(ValueError):
        WG8(x24, q24.q, q24.scale)                       # din not a multiple of 16
    q_buf = torch.empty(qt.q.numel() + 8, dtype=torch.int8, device="cuda")
    q_off = q_buf[8:].view(qt.q.shape)
    q_off.copy_(qt.q)
    with pytest.raises(ValueError):
        WG8(x, q_off, qt.scale)                          # q 8 bytes off 16
    with pytest.raises(ValueError):
        WG8(x, qt.q.cpu(), qt.scale)                     # mixed devices
    # the entry point sends the unaligned q to int8_mma's 16-row chunks instead
    n = MMA8.launches
    y = qmatmul.int8_gemv(x, q_off, qt.scale)
    torch.cuda.synchronize()
    assert MMA8.launches == n + 3
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


def test_int8_wgmma_c_entry_rejects_what_it_does_not_take(gen):
    """The C entry returns cudaErrorInvalidValue (1) and launches nothing
    for what the wrapper would not pass on."""
    from moshi_tpu_torch.ops import build
    x, qt = _mma8_case(gen, 40, 256, 128)
    out = torch.empty(40, 128, device="cuda", dtype=torch.bfloat16)
    partial = torch.empty(2, 40, 128, device="cuda")
    lib = build.load("int8_wgmma")
    stream = torch.cuda.current_stream().cuda_stream

    def call(m=40, din=256, dout=128, split_rows=128, splits=2, xp=0, qp=0, sp=0):
        return lib.int8_wgmma(x.data_ptr() + xp, qt.q.data_ptr() + qp,
                              qt.scale.data_ptr() + sp, out.data_ptr(), partial.data_ptr(), m,
                              din, dout, split_rows, splits, stream)
    assert call() == 0
    for bad in ({"m": 0}, {"din": 248}, {"din": 8}, {"dout": 96}, {"split_rows": 96},
                {"split_rows": 0}, {"splits": 0}, {"splits": 1}, {"splits": 3},
                {"xp": 2}, {"qp": 8}, {"sp": 4}):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()
    assert _rel(out, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


# the CUDA-core GEMVs (csrc/int8_gemv.cu, csrc/q4_gemv.cu), one launch a
# call planned by q4matmul.gemv_plan: a lane's columns, warps over din, a
# cluster of blocks over din added in distributed shared memory
SIMT8, SIMT4 = qmatmul.int8_gemv_kernel, q4matmul.q4_gemv_kernel


def _num_sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _counted(fn, *args):
    """fn(*args) and the launches it added to (q4_gemv, q4_mma, q4_wgmma,
    int8_gemv, int8_mma)."""
    counters = (q4matmul.q4_gemv, MMA, WG, qmatmul.int8_gemv, MMA8)
    before = [c.launches for c in counters]
    y = fn(*args)
    torch.cuda.synchronize()
    return y, tuple(c.launches - b for c, b in zip(counters, before))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rem", range(16))
def test_int8_gemv_every_row_offset(rem, dtype, gen):
    """dout = 16 k + rem for rem = 0..15: the rows of q start at every byte
    offset mod 16 (the kernel's 16-byte, 8-byte and realigned-word paths);
    one int8_gemv launch, against the plain version."""
    din, dout = 200, 16 * 9 + rem
    qt = tq.quantize_tensor(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(3, din, device="cuda", generator=gen).to(dtype)
    y, launched = _counted(SIMT8, x, qt.q, qt.scale)
    assert launched == (0, 0, 0, 1, 0)
    assert tuple(y.shape) == (3, dout) and y.dtype == dtype
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[dtype]


@pytest.mark.parametrize("offset", range(1, 16))
def test_int8_gemv_member_view_at_every_byte_offset(offset, gen):
    """Views that start `offset` bytes past a 16-byte boundary: member 1 of a
    stacked [3, 33, 96 + offset] weight (33 * (96 + offset) = offset mod
    16, rows of odd length) and a [200, 256] weight at that offset of a flat
    buffer (rows of 16-byte length off their alignment); each reads its own
    bytes."""
    qt = tq.quantize_tensor(torch.randn(3, 33, 96 + offset, device="cuda", generator=gen))
    x = torch.randn(16, 33, device="cuda", generator=gen).to(torch.bfloat16)
    assert qt.q[1].data_ptr() % 16 == offset
    for layer in range(3):
        y = SIMT8(x, qt.q[layer], qt.scale[layer])
        ref = qmatmul.int8_gemv_plain(x, qt.q[layer], qt.scale[layer])
        assert _rel(y, ref) <= BOUND[torch.bfloat16]
    w = tq.quantize_tensor(torch.randn(200, 256, device="cuda", generator=gen) / 15)
    flat = torch.empty(offset + w.q.numel(), dtype=torch.int8, device="cuda")
    q = flat[offset:].view(200, 256)
    q.copy_(w.q)
    x = torch.randn(5, 200, device="cuda", generator=gen)
    assert q.data_ptr() % 16 == offset
    y = SIMT8(x, q, w.scale)
    assert _rel(y, qmatmul.int8_gemv_plain(x, w.q, w.scale)) <= BOUND[torch.float32]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", range(1, 17))
@pytest.mark.parametrize("din,dout", [(2048, 32001), (1024, 2049)])
def test_int8_gemv_tts_heads(din, dout, B, dtype, gen):
    """The TTS heads (32001 text columns, 2049 audio ones) at every batch,
    through the entry point int8_gemv (which routes them to the int8_gemv
    kernel: not a multiple of 64 columns), one launch."""
    qt = tq.quantize_tensor(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(B, din, device="cuda", generator=gen).to(dtype)
    y, launched = _counted(qmatmul.int8_gemv, x, qt.q, qt.scale)
    assert launched == (0, 0, 0, 1, 0)
    assert tuple(y.shape) == (B, dout) and bool(torch.isfinite(y).all())
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("din,dout", Q4_MAIN_SHAPES)
def test_q4_gemv_b1_main_path_shapes(din, dout, dtype, gen):
    """One row at each q4 shape of Moshi-7B (the B = 1 frame's 129 linears),
    through the entry point q4_gemv: one q4_gemv launch, none of the
    tensor-core kernels."""
    qt = tq.quantize_tensor4(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(1, din, device="cuda", generator=gen).to(dtype)
    y, launched = _counted(q4matmul.q4_gemv, x, qt.q, qt.scale)
    assert launched == (1, 0, 0, 0, 0)
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[dtype]


@pytest.mark.parametrize("B", range(1, 17))
def test_q4_gemv_f32_every_row_count(B, gen):
    """f32 x of 1..16 rows at Moshi-7B's widest din (11264: above 8 rows a
    block stages x in segments), one q4_gemv launch."""
    qt = tq.quantize_tensor4(torch.randn(11264, 4096, device="cuda", generator=gen) / 106)
    x = torch.randn(B, 11264, device="cuda", generator=gen)
    y, launched = _counted(SIMT4, x, qt.q, qt.scale)
    assert launched == (1, 0, 0, 0, 0)
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.float32]


# (kernel, din, dout, batch, whether the plan takes a cluster on an H100):
# plans with one block a column tile (shallow, or wide and full) and with a
# cluster of several, a segmented x at 32768 x 16 f32
PLAN_CASES = [("q4", 64, 65536, 1, False), ("int8", 16, 65536, 4, False),
              ("int8", 24, 1001, 16, False), ("int8", 2048, 32001, 16, False),
              ("q4", 4096, 4096, 1, True), ("q4", 4096, 22528, 1, True),
              ("int8", 1024, 2049, 16, True), ("q4", 32768, 512, 16, True)]


@pytest.mark.parametrize("kind,din,dout,B,clustered", PLAN_CASES)
def test_gemv_plans_with_and_without_a_cluster(kind, din, dout, B, clustered, gen):
    """The kernels at shapes whose plans take one block a column tile and
    shapes whose plans take a cluster, against the plain version."""
    fn, plain, quant = KERNELS[kind]
    grain, most = (32, q4matmul.Q4_MAX_ACC) if kind == "q4" else (1, q4matmul.GEMV_MAX_ACC)
    cols = tuple(c for c in (16, 8, 4) if c <= q4matmul.gemv_max_cols(B, most)
                 and (kind == "q4" or c == 4 or dout % c == 0))
    plan = q4matmul.gemv_plan(kind, din, dout, B, _num_sms(), grain, cols,
                              q4matmul.gemv_resident(kind, B, False, torch.device("cuda", 0)))
    assert (plan.cluster > 1) == clustered
    qt = quant(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(B, din, device="cuda", generator=gen)
    y = (SIMT4 if kind == "q4" else SIMT8)(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert _rel(y, plain(x, qt.q, qt.scale)) <= BOUND[torch.float32]


@pytest.mark.parametrize("kind,din,dout,B", [("q4", 4096, 12288, 1), ("q4", 11264, 4096, 1),
                                             ("int8", 2048, 32001, 16),
                                             ("int8", 1024, 2049, 16)])
def test_cuda_core_gemvs_deterministic_and_counted(kind, din, dout, B, gen):
    """At the main paths' shapes (bf16), two calls give the same bytes (the
    cluster's sums added in a fixed order), and each is one launch of its
    kernel and none of another."""
    _, plain, quant = KERNELS[kind]
    fn = SIMT4 if kind == "q4" else SIMT8
    qt = quant(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(B, din, device="cuda", generator=gen).to(torch.bfloat16)
    a, first = _counted(fn, x, qt.q, qt.scale)
    b, second = _counted(fn, x, qt.q, qt.scale)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    one = (1, 0, 0, 0, 0) if kind == "q4" else (0, 0, 0, 1, 0)
    assert first == second == one
    assert _rel(a, plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]


def test_cuda_core_gemv_c_entries_reject_what_they_do_not_take(gen):
    """The C entries return cudaErrorInvalidValue (1) and launch nothing for
    a plan or operands they do not take."""
    from moshi_tpu_torch.ops import build
    q8 = tq.quantize_tensor(torch.randn(256, 128, device="cuda", generator=gen) / 16)
    q4 = tq.quantize_tensor4(torch.randn(256, 128, device="cuda", generator=gen) / 16)
    x = torch.randn(4, 256, device="cuda", generator=gen)
    out = torch.empty(4, 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib8, lib4 = build.load("int8_gemv"), build.load("q4_gemv")

    def call8(batch=4, cols=16, warps=8, cluster=2, rows=128, seg=128, qp=0):
        return lib8.int8_gemv(x.data_ptr(), q8.q.data_ptr() + qp, q8.scale.data_ptr(),
                              out.data_ptr(), batch, 256, 128, cols, warps, cluster, rows, seg,
                              0, stream)

    def call4(batch=4, cols=4, warps=8, cluster=2, rows=128, seg=128, gs=32, sp=0):
        return lib4.q4_gemv(x.data_ptr(), q4.q.data_ptr(), q4.scale.data_ptr() + sp,
                            out.data_ptr(), batch, 256, 128, gs, cols, warps, cluster, rows,
                            seg, 0, stream)
    assert call8() == 0 and call4() == 0
    for bad in ({"batch": 0}, {"batch": 17}, {"cols": 2}, {"batch": 5, "cols": 16},
                {"warps": 9}, {"cluster": 9}, {"rows": 100}, {"seg": 0}, {"seg": 256},
                {"cols": 8, "qp": 4}):
        assert call8(**bad) == 1, bad
    for bad in ({"batch": 0}, {"cols": 2}, {"cols": 8}, {"cluster": 9},
                {"rows": 96, "cluster": 2}, {"rows": 112}, {"seg": 48}, {"gs": 3}, {"sp": 4}):
        assert call4(**bad) == 1, bad
    torch.cuda.synchronize()
    assert _rel(out, q4matmul.q4_gemv_plain(x, q4.q, q4.scale)) <= BOUND[torch.float32]


def _int4_cache(gen, L, B, Hkv, D, cap_pad):
    """Random packed caches (every nibble in [-7, 7]) and positive scales."""
    def packed():
        vals = torch.randint(-7, 8, (L, B, Hkv * D, cap_pad), device="cuda",
                             generator=gen, dtype=torch.int8)
        return (vals[:, :, 1::2] << 4) | (vals[:, :, 0::2] & 15)

    def scales():
        return (torch.rand(L, B, Hkv, cap_pad, device="cuda", generator=gen)
                * 0.2 + 0.01).to(torch.bfloat16)
    return packed(), packed(), scales(), scales()


def _stats_err(got, ref):
    """Relative error of acc / l and of m (the kernel takes q in bf16)."""
    (acc, m, l), (racc, rm, rl) = got, ref
    return max(_rel(acc / l, racc / rl), _rel(m, rm))


# (B, H, Hkv, D, cap, layer): the main path's shape, D = 64, capacities that
# are no multiple of the 64-position chunk (1001, 200, 5), grouped KV heads
# (kv_repeat 2, 4, and 9: two groups of query heads on one KV head)
ATTN = [(16, 32, 32, 128, 3000, 5), (16, 32, 32, 64, 3000, 1), (3, 4, 4, 128, 1500, 2),
        (2, 8, 2, 64, 200, 0), (1, 4, 4, 128, 2048, 1), (16, 32, 16, 128, 3000, 1),
        (16, 32, 8, 64, 3000, 2), (3, 4, 4, 128, 1001, 1), (2, 4, 4, 64, 5, 0),
        (2, 18, 2, 128, 333, 1)]


@pytest.mark.parametrize("B,H,Hkv,D,cap,layer", ATTN)
def test_decode_attention_int4(B, H, Hkv, D, cap, layer, gen):
    cap_pad = -(-cap // 128) * 128
    caches = _int4_cache(gen, layer + 1, B, Hkv, D, cap_pad)
    q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.rand(B, cap, device="cuda", generator=gen) < 0.8
    mask[:, -1] = True                         # the last position of a ragged chunk
    n = i4.decode_attention_int4_stats.launches
    got = i4.decode_attention_int4_stats(q, layer, *caches, mask)
    torch.cuda.synchronize()
    assert i4.decode_attention_int4_stats.launches == n + 1
    ref = i4.decode_attention_int4_stats_plain(q, layer, *caches, mask)
    assert all(t.dtype == torch.float32 for t in got)
    assert _stats_err(got, ref) <= BOUND[torch.bfloat16]


@pytest.mark.parametrize("D", [64, 128])
def test_decode_attention_int4_one_lane(D, gen):
    """Every lane masked but one, and every lane masked: the kernel's m, l
    and acc equal the dense version's (lanes past cap do not count)."""
    B, H, cap = 2, 4, 1100
    caches = _int4_cache(gen, 1, B, H, D, 1152)
    q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.zeros(B, cap, dtype=torch.bool, device="cuda")
    mask[0, 1037] = True
    got = i4.decode_attention_int4_stats(q, 0, *caches, mask)
    torch.cuda.synchronize()
    ref = i4.decode_attention_int4_stats_plain(q, 0, *caches, mask)
    assert _stats_err([t[:1] for t in got], [t[:1] for t in ref]) <= BOUND[torch.bfloat16]
    torch.testing.assert_close(got[2][1], ref[2][1])          # l = cap on slot 1
    assert (got[1][1] == -1e30).all()


@pytest.mark.parametrize("D", [128, 64])
def test_decode_attention_int4_main_shape_masks(D, gen):
    """Moshi's B = 16, H = 32 at cap 3000, layer 3: slot 0 with positions
    0..99 only (a ring in its first seconds, so most warps see no position),
    slot 1 with every position masked (m = -1e30, l = cap), the rest
    ragged."""
    B, H, cap = 16, 32, 3000
    caches = _int4_cache(gen, 4, B, H, D, 3072)
    q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.rand(B, cap, device="cuda", generator=gen) < 0.9
    mask[0] = False
    mask[0, :100] = True
    mask[1] = False
    got = i4.decode_attention_int4_stats(q, 3, *caches, mask)
    torch.cuda.synchronize()
    ref = i4.decode_attention_int4_stats_plain(q, 3, *caches, mask)
    live = [0] + list(range(2, B))
    assert _stats_err([t[live] for t in got], [t[live] for t in ref]) <= BOUND[torch.bfloat16]
    assert (got[1][1] == -1e30).all()
    assert (got[2][1] == cap).all()
    assert torch.isfinite(got[0]).all()


def test_decode_attention_int4_deterministic_and_slot_invariant(gen):
    """Two calls give the same bits, and two slots with the same q, cache
    bytes, scales and mask give the same bits (the merge order is fixed and
    depends on nothing but the slot's own data)."""
    B, H, D, cap = 4, 8, 128, 1500
    k, v, ks, vs = _int4_cache(gen, 2, B, H, D, 1536)
    for t in (k, v, ks, vs):
        t[:, 3] = t[:, 1]
    q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    q[3] = q[1]
    mask = torch.rand(B, cap, device="cuda", generator=gen) < 0.7
    mask[3] = mask[1]
    a = i4.decode_attention_int4_stats(q, 1, k, v, ks, vs, mask)
    b = i4.decode_attention_int4_stats(q, 1, k, v, ks, vs, mask)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert torch.equal(x[3], x[1])


def test_decode_attention_int4_c_entry_rejects_what_it_does_not_take(gen):
    """The C entry launches nothing and returns cudaErrorInvalidValue for 0
    or 9 warps, a cap past cap_pad, a cap_pad off the 64-position chunk,
    misaligned caches and a head dim other than 64 and 128; and, for a
    write, missing rows, more than 8 query heads per KV head and row
    strides shorter than a slot's rows."""
    from moshi_tpu_torch.ops import build
    B, H, D, cap, cap_pad = 2, 4, 64, 200, 256
    k, v, ks, vs = _int4_cache(gen, 1, B, H, D, cap_pad)
    q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.ones(B, cap, dtype=torch.bool, device="cuda")
    out = [torch.empty(B, H, D, device="cuda"), torch.empty(B, H, 1, device="cuda"),
           torch.empty(B, H, 1, device="cuda")]
    lib = build.load("decode_attention_int4")
    stream = torch.cuda.current_stream().cuda_stream

    rows = torch.randn(B, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    pos = torch.full((B,), 7, device="cuda")

    def call(kp=k.data_ptr(), D_=D, cap_=cap, cap_pad_=cap_pad, warps=2, kk=None, pp=None,
             H_=H, stride=H * D):
        return lib.decode_attention_int4(q.data_ptr(), kp, v.data_ptr(), ks.data_ptr(),
                                         vs.data_ptr(), mask.data_ptr(), kk, kk, pp,
                                         *(t.data_ptr() for t in out), 0, B, H_, H, D_, cap_,
                                         cap_pad_, warps, stride, stride, stream)
    assert call() == 0
    assert call(kk=rows.data_ptr(), pp=pos.data_ptr()) == 0
    torch.cuda.synchronize()
    for bad in (dict(warps=0), dict(warps=9), dict(cap_=cap_pad + 1), dict(cap_pad_=cap_pad - 32),
                dict(kp=k.data_ptr() + 8), dict(D_=96), dict(pp=pos.data_ptr()),
                dict(kk=rows.data_ptr(), pp=pos.data_ptr(), H_=9 * H),
                dict(kk=rows.data_ptr(), pp=pos.data_ptr(), stride=H * D - 1)):
        assert call(**bad) == 1, bad      # cudaErrorInvalidValue


def _rows(gen, B, Hkv, D):
    """The current rows kk (contiguous) and vv (a view whose slots lie 3 x
    Hkv x D apart, as the qkv projection's slice), bf16 [B, Hkv, D]."""
    kk = torch.randn(B, Hkv, D, device="cuda", generator=gen).to(torch.bfloat16)
    qkv = torch.randn(B, 3 * Hkv * D, device="cuda", generator=gen).to(torch.bfloat16)
    return kk, qkv[:, Hkv * D:2 * Hkv * D].view(B, Hkv, D)


def _edge_positions(B, cap, cap_pad, gen):
    """Write lanes: the chunk edges 0, 63, 64, 127, 128, cap - 1, a pad
    lane (cap_pad - 1, never attended) and -1 (nothing written), then
    random lanes below cap."""
    edges = [p for p in (0, 63, 64, 127, 128, cap - 1, cap_pad - 1, -1) if p < cap or
             p in (cap_pad - 1, -1)]
    rest = torch.randint(0, cap, (max(B - len(edges), 0),), generator=gen,
                         device="cuda").tolist()
    return torch.tensor((edges + rest)[:B], device="cuda")


def _write_mask(gen, B, cap, pos):
    """A ragged mask with each slot's write lane hidden and the last slot
    fully masked."""
    mask = torch.rand(B, cap, device="cuda", generator=gen) < 0.8
    for b, p in enumerate(pos.tolist()):
        if 0 <= p < cap:
            mask[b, p] = False
    mask[-1] = False
    return mask


def _write_plain_on_cpu(q, kk, vv, pos, layer, caches, mask):
    """The fused op's plain version on CPU copies: torch divides a CUDA
    tensor by a Python scalar as a multiply by its reciprocal, which can
    move a scale by one ulp; the CPU divides, as the kernel and the JAX
    package do.  Returns the stats and the written caches."""
    cpu = [t.cpu() for t in caches]
    out = i4.decode_attention_int4_write_plain(q.cpu(), kk.cpu(), vv.cpu(), pos.cpu(), layer,
                                               *cpu, mask.cpu())
    return out, cpu


# (B, H, Hkv, D, cap, layer): Moshi's B = 16 int4 frame and D = 64, grouped
# KV heads (2 and 8 query heads per KV head, the most a writing block
# takes), caps that are no multiple of the 64-position chunk
WRITE = [(16, 32, 32, 128, 3000, 5), (16, 32, 32, 64, 3000, 1), (4, 8, 4, 128, 1001, 2),
         (3, 16, 2, 64, 200, 0), (2, 4, 4, 128, 5, 1)]


@pytest.mark.parametrize("B,H,Hkv,D,cap,layer", WRITE)
def test_decode_attention_int4_write(B, H, Hkv, D, cap, layer, gen):
    """The fused launch against its plain version: every byte of the four
    caches equal (the written lanes of `layer` and every other byte
    unchanged), the stats within the attention's bound, the fully masked
    slot at m = -1e30 and l = cap; one launch, counted by both counters."""
    cap_pad = -(-cap // 128) * 128
    caches = _int4_cache(gen, layer + 1, B, Hkv, D, cap_pad)
    before = [c.clone() for c in caches]
    q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    kk, vv = _rows(gen, B, Hkv, D)
    pos = _edge_positions(B, cap, cap_pad, gen)
    mask = _write_mask(gen, B, cap, pos)
    ref, ref_caches = _write_plain_on_cpu(q, kk, vv, pos, layer, caches, mask)
    n, nw = i4.decode_attention_int4_stats.launches, i4.decode_attention_int4_write.launches
    got = i4.decode_attention_int4_write(q, kk, vv, pos, layer, *caches, mask)
    torch.cuda.synchronize()
    assert i4.decode_attention_int4_stats.launches == n + 1
    assert i4.decode_attention_int4_write.launches == nw + 1
    for c, r, c0 in zip(caches, ref_caches, before):
        assert torch.equal(c.cpu(), r)
        written = [b for b, p in enumerate(pos.tolist()) if 0 <= p < cap_pad]
        assert not torch.equal(c[layer, written], c0[layer, written])
    live = list(range(B - 1))
    assert _stats_err([t[live] for t in got], [t[live].cuda() for t in ref]) <= \
        BOUND[torch.bfloat16]
    assert (got[1][-1] == -1e30).all() and (got[2][-1] == cap).all()


@pytest.mark.parametrize("D", [64, 128])
def test_decode_attention_int4_write_two_steps_and_frozen_slot(D, gen):
    """Two decode steps, as the ring fills: the second launch attends the
    lanes the first one wrote, slot 1 is frozen (its second write lands on
    the lane of its first), and the caches and stats of both steps follow
    the plain version's."""
    B, H, cap, layer = 4, 8, 700, 1
    cap_pad = 768
    caches = _int4_cache(gen, 2, B, H, D, cap_pad)
    cpu_caches = [c.cpu() for c in caches]
    pos = torch.tensor([63, 64, 0, 699], device="cuda")
    lanes = torch.arange(cap, device="cuda")[None]
    for step in range(2):
        if step:
            pos = torch.where(torch.tensor([True, False, True, True], device="cuda"),
                              (pos + 1) % cap, pos)
        mask = (lanes < pos[:, None]) | (lanes > 650)
        mask &= lanes != pos[:, None]
        q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
        kk, vv = _rows(gen, B, H, D)
        got = i4.decode_attention_int4_write(q, kk, vv, pos, layer, *caches, mask)
        torch.cuda.synchronize()
        ref = i4.decode_attention_int4_write_plain(q.cpu(), kk.cpu(), vv.cpu(), pos.cpu(),
                                                   layer, *cpu_caches, mask.cpu())
        for c, r in zip(caches, cpu_caches):
            assert torch.equal(c.cpu(), r), step
        assert _stats_err(got, [t.cuda() for t in ref]) <= BOUND[torch.bfloat16]


def test_decode_attention_int4_write_deterministic(gen):
    """Two calls on copies of the same caches give the same bits, stats and
    caches, the fully masked slot's (which weighs the lane's old bytes)
    included."""
    B, H, D, cap = 4, 32, 128, 3000
    caches = _int4_cache(gen, 2, B, H, D, 3072)
    q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    kk, vv = _rows(gen, B, H, D)
    pos = torch.tensor([5, 64, 2999, 100], device="cuda")
    mask = _write_mask(gen, B, cap, pos)
    runs = []
    for _ in range(2):
        cs = [c.clone() for c in caches]
        runs.append((i4.decode_attention_int4_write(q, kk, vv, pos, 1, *cs, mask), cs))
    torch.cuda.synchronize()
    (a, ca), (b, cb) = runs
    for x, y in zip(a + tuple(ca), b + tuple(cb)):
        assert torch.equal(x, y)
    assert (a[1][-1] == -1e30).all() and (a[2][-1] == cap).all()


def test_decode_attention_int4_write_rejects_what_the_kernel_does_not_take(gen):
    """A write where a KV head has more than 8 query heads (its lane would
    be read by another block while written) raises, while the attention
    alone takes that shape; so do f32 rows and rows whose heads are not D
    apart."""
    B, D, cap = 2, 64, 200
    caches = _int4_cache(gen, 1, B, 2, D, 256)
    q = torch.randn(B, 18, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    kk, vv = _rows(gen, B, 2, D)
    pos = torch.tensor([3, 4], device="cuda")
    mask = torch.ones(B, cap, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        i4.decode_attention_int4_write(q, kk, vv, pos, 0, *caches, mask)    # 9 per KV head
    i4.decode_attention_int4_stats(q, 0, *caches, mask)
    q = q[:, :16].contiguous()
    with pytest.raises(TypeError):
        i4.decode_attention_int4_write(q, kk.float(), vv, pos, 0, *caches, mask)
    wide = torch.randn(B, 2, 2 * D, device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(ValueError):
        i4.decode_attention_int4_write(q, wide[..., :D], vv, pos, 0, *caches, mask)
    torch.cuda.synchronize()


def test_int4_wrappers_reject_what_the_kernels_do_not_take(gen):
    caches = _int4_cache(gen, 2, 2, 4, 96, 256)
    q = torch.randn(2, 4, 1, 96, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.ones(2, 200, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        i4.decode_attention_int4_stats(q, 0, *caches, mask)      # head dim 96
    caches = _int4_cache(gen, 2, 2, 4, 64, 256)
    q = torch.randn(2, 4, 1, 64, device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(ValueError):
        i4.decode_attention_int4_stats(q, 2, *caches, mask)      # layer past L
    with pytest.raises(TypeError):
        i4.decode_attention_int4_stats(q.float(), 0, *caches, mask)   # f32 q


def _int8_cache(gen, L, B, cap, Hkv, D):
    """Random int8 ring caches [L, B, cap, Hkv, D] and positive bf16 row
    scales [L, B, cap, Hkv, 1]."""
    def vals():
        return torch.randint(-127, 128, (L, B, cap, Hkv, D), device="cuda", generator=gen,
                             dtype=torch.int8)

    def scales():
        return (torch.rand(L, B, cap, Hkv, 1, device="cuda", generator=gen)
                * 0.02 + 0.001).to(torch.bfloat16)
    return vals(), vals(), scales(), scales()


# (B, H, Hkv, D, cap, layer): the ASR path's shape (layer 5 of 6), Moshi's,
# D = 64, a capacity that is no multiple of the split grain, grouped KV
# heads, small capacities, grouped heads at Moshi's capacity, a capacity no
# multiple of a warp's tile (8 positions at D = 128) or of a split, and
# capacities below one tile
INT8_ATTN = [(256, 8, 8, 128, 750, 5), (16, 32, 32, 128, 3000, 1), (16, 32, 32, 64, 3000, 0),
             (3, 4, 4, 128, 1500, 2), (2, 8, 2, 64, 200, 0), (1, 4, 4, 128, 100, 1),
             (4, 16, 4, 128, 3000, 0), (3, 4, 4, 128, 1001, 0), (2, 4, 4, 128, 5, 0),
             (2, 4, 2, 64, 7, 1)]


@pytest.mark.parametrize("B,H,Hkv,D,cap,layer", INT8_ATTN)
def test_decode_attention_int8(B, H, Hkv, D, cap, layer, gen):
    """A ragged mask, and slot 0 with every position masked (0, not NaN)."""
    caches = _int8_cache(gen, layer + 1, B, cap, Hkv, D)
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.rand(B, cap, device="cuda", generator=gen) < 0.8
    mask[:, -1] = True                         # the last position of a ragged chunk
    mask[0] = False
    n = da8.decode_attention_int8.launches
    got = da8.decode_attention_int8(q, layer, *caches, mask)
    torch.cuda.synchronize()
    assert da8.decode_attention_int8.launches == n + 1
    ref = da8.decode_attention_int8_plain(q, layer, *caches, mask)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, D)
    assert (got[0] == 0).all() and (ref[0] == 0).all()
    if B > 1:
        assert _rel(got[1:], ref[1:]) <= BOUND[torch.bfloat16]


@pytest.mark.parametrize("D", [64, 128])
def test_decode_attention_int8_one_position(D, gen):
    """One position masked in: the output is that position's dequantized V
    row, whatever its score."""
    B, H, cap = 2, 4, 700
    k, v, ks, vs = _int8_cache(gen, 1, B, cap, H, D)
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.zeros(B, cap, dtype=torch.bool, device="cuda")
    mask[0, 517] = True
    mask[1, 3] = True
    got = da8.decode_attention_int8(q, 0, k, v, ks, vs, mask)
    torch.cuda.synchronize()
    want = torch.stack([v[0, 0, 517] * vs[0, 0, 517].float(), v[0, 1, 3] * vs[0, 1, 3].float()])
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float())


def test_int8_wrapper_rejects_what_the_kernel_does_not_take(gen):
    caches = _int8_cache(gen, 2, 2, 64, 4, 96)
    q = torch.randn(2, 4, 96, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        da8.decode_attention_int8(q, 0, *caches, mask)           # head dim 96
    caches = _int8_cache(gen, 2, 2, 64, 4, 64)
    q = torch.randn(2, 4, 64, device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(ValueError):
        da8.decode_attention_int8(q, 2, *caches, mask)           # layer past L
    with pytest.raises(TypeError):
        da8.decode_attention_int8(q.float(), 0, *caches, mask)   # f32 q


def _k6_at(q, layer, caches, mask, splits, warps=4):
    """The C entry of decode_attention_int8 at a forced split count and
    block size (the wrapper takes plan_splits'); returns out."""
    from moshi_tpu_torch.ops import build
    B, H, D = q.shape
    cap, Hkv = caches[0].shape[2], caches[0].shape[3]
    out = torch.empty(B, H, D, device="cuda", dtype=torch.bfloat16)
    lib = build.load("decode_attention_int8")
    err = lib.decode_attention_int8(q.data_ptr(), *(c.data_ptr() for c in caches),
                                    mask.data_ptr(), out.data_ptr(), layer, B, H, Hkv, D, cap,
                                    da8.split_length(cap, splits), splits, warps,
                                    torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


def _k6_mask(kind, B, cap, splits):
    """[B, cap] masks of a split layout: "first100" (a ring filled from 0:
    every later split empty), "last_split" (positions of the last split
    only), "boundaries" (one position on each side of every split boundary,
    or the two ends at one split); slot 0 attends nothing."""
    per = da8.split_length(cap, splits)
    mask = torch.zeros(B, cap, dtype=torch.bool, device="cuda")
    if kind == "first100":
        mask[:, :100] = True
    elif kind == "last_split":
        mask[:, (splits - 1) * per:] = True
    else:
        for r in range(1, splits):
            mask[:, r * per - 1:r * per + 1] = True
        if splits == 1:
            mask[:, [0, cap - 1]] = True
    mask[0] = False
    return mask


@pytest.mark.parametrize("kind", ["first100", "last_split", "boundaries"])
@pytest.mark.parametrize("splits", range(1, 9))
def test_decode_attention_int8_split_masks(kind, splits, gen):
    """Every split count the kernel takes, on masks that leave whole splits
    empty or put the only positions at their edges, against the plain
    version cut the same way; the fully masked slot gives 0.  Blocks of 1-8
    warps, 6 query heads over 3 KV heads (a block takes 4 at D = 128: the
    second block's last two heads are past H)."""
    B, H, Hkv, D, cap = 3, 6, 3, 128, 3000
    caches = _int8_cache(gen, 1, B, cap, Hkv, D)
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = _k6_mask(kind, B, cap, splits)
    got = _k6_at(q, 0, caches, mask, splits, warps=1 << (splits % 4))
    torch.cuda.synchronize()
    ref = da8.decode_attention_int8_plain(q, 0, *caches, mask, splits=splits)
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    assert _rel(got[1:], ref[1:]) <= BOUND[torch.bfloat16]


@pytest.mark.parametrize("B,H,cap", [(256, 8, 750), (16, 32, 3000)])
def test_decode_attention_int8_first100_main_shapes(B, H, cap, gen):
    """Both main-path shapes through the wrapper and its plan, with only
    positions 0..99 masked in (the ring's first 8 s)."""
    caches = _int8_cache(gen, 2, B, cap, H, 128)
    q = torch.randn(B, H, 128, device="cuda", generator=gen).to(torch.bfloat16)
    mask = _k6_mask("first100", B, cap, 1)
    got = da8.decode_attention_int8(q, 1, *caches, mask)
    torch.cuda.synchronize()
    ref = da8.decode_attention_int8_plain(q, 1, *caches, mask)
    assert (got[0] == 0).all() and _rel(got[1:], ref[1:]) <= BOUND[torch.bfloat16]


def test_decode_attention_int8_deterministic(gen):
    """The splits merge in a fixed order: two calls give the same bits, at
    the plan's split count and at 8."""
    B, H, cap = 16, 32, 3000
    caches = _int8_cache(gen, 1, B, cap, H, 128)
    q = torch.randn(B, H, 128, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.rand(B, cap, device="cuda", generator=gen) < 0.9
    first = da8.decode_attention_int8(q, 0, *caches, mask)
    assert torch.equal(first, da8.decode_attention_int8(q, 0, *caches, mask))
    assert torch.equal(_k6_at(q, 0, caches, mask, 8, 8), _k6_at(q, 0, caches, mask, 8, 8))


def test_decode_attention_int8_c_entry_rejects_what_it_does_not_take(gen):
    """The C entry returns cudaErrorInvalidValue (1) and launches nothing
    for a split layout that leaves a split empty or misses positions, more
    than 8 splits, a head dim or head grouping it does not take, or a
    cache that is not 16-byte aligned."""
    from moshi_tpu_torch.ops import build
    B, H, D, cap = 2, 4, 128, 100
    k, v, ks, vs = _int8_cache(gen, 1, B, cap, H, D)
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.ones(B, cap, dtype=torch.bool, device="cuda")
    out = torch.empty(B, H, D, device="cuda", dtype=torch.bfloat16)
    lib = build.load("decode_attention_int8")
    stream = torch.cuda.current_stream().cuda_stream

    def call(Hkv=H, D=D, per=64, splits=2, warps=4, kp=0):
        return lib.decode_attention_int8(q.data_ptr(), k.data_ptr() + kp, v.data_ptr(),
                                         ks.data_ptr(), vs.data_ptr(), mask.data_ptr(),
                                         out.data_ptr(), 0, B, H, Hkv, D, cap, per, splits,
                                         warps, stream)
    assert call() == 0
    for bad in ({"splits": 0}, {"splits": 9, "per": 16}, {"per": 32}, {"per": 112},
                {"splits": 3, "per": 50}, {"D": 96}, {"Hkv": 3}, {"kp": 8}, {"warps": 0},
                {"warps": 17}, {"warps": 16, "splits": 8, "per": 13}):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()
    ref = da8.decode_attention_int8_plain(q, 0, k, v, ks, vs, mask, splits=2)
    assert _rel(out, ref) <= BOUND[torch.bfloat16]


# ------------------------------------------------ C.7: quantization bytes
def _cpu_rows(gen, shape):
    """Seeded bf16 rows on the CPU, as the step's K/V rows."""
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


def _cpu_weights(gen, shape):
    """A seeded bf16 [din, dout] weight on the CPU, as init_params makes."""
    return (torch.randn(*shape, generator=gen) / shape[0] ** 0.5).to(torch.bfloat16)


# function -> (the function on one tensor, [(input maker, shape)]): the
# chip_smoke.py shapes, i.e. the int8 KV rows of Moshi B = 16 and ASR
# B = 256, the int4 KV rows at D = 128 and 64, the depformer's int8
# weights and the temporal q4 weights
QUANTIZERS = {
    "_quant_rows": (_quant_rows, [(_cpu_rows, (16, 1, 32, 128)),
                                  (_cpu_rows, (256, 1, 8, 128))]),
    "_quant_rows_int4": (i4._quant_rows_int4, [(_cpu_rows, (16, 1, 32, 128)),
                                               (_cpu_rows, (16, 1, 32, 64))]),
    "_quantize8": (tq._quantize8, [(_cpu_weights, (1024, 3072)),
                                   (_cpu_weights, (2816, 1024)),
                                   (_cpu_weights, (4096, 1024))]),
    "_quantize4": (lambda w: tq._quantize4(w, 32), [(_cpu_weights, (4096, 12288)),
                                                    (_cpu_weights, (11264, 4096))]),
}


@pytest.mark.parametrize("name", sorted(QUANTIZERS))
def test_quantization_on_the_card_gives_the_cpus_bytes(name, gen):
    """The same seeded rows and weights quantized on the card and on the
    CPU give equal bytes and equal scales (the CPU's are the JAX package's,
    tests/test_torch_int8_kv.py, tests/test_torch_int4_kv.py): nothing
    divides by a Python scalar, which torch runs on a CUDA tensor as a
    multiply by the reciprocal."""
    fn, cases = QUANTIZERS[name]
    cpu_gen = torch.Generator().manual_seed(7)
    for make, shape in cases:
        x = make(cpu_gen, shape)
        q_cpu, s_cpu = fn(x)
        q_card, s_card = fn(x.cuda())
        assert torch.equal(q_card.cpu(), q_cpu), (name, shape)
        assert torch.equal(s_card.cpu(), s_cpu), (name, shape)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_prefill_write_on_the_card_gives_the_cpus_bytes(kv, gen):
    """A step of T = 64 rows over a quantized cache (the prefill path)
    writes the same bytes on the card as on the CPU for the same seeded
    bf16 rows (C.7), at Moshi's head shape, 2 slots, a ring of 100 that
    wraps inside the chunk; its attention outputs agree within
    BOUND[bf16]."""
    from moshi_tpu_torch.modules.transformer import (StreamingTransformer, TransformerConfig,
                                                     ring_positions)
    B, T, cap = 2, 64, 100
    model = StreamingTransformer(TransformerConfig(d_model=4096, num_heads=32, num_layers=1,
                                                   context=cap, kv_cache_dtype=kv))
    cpu_gen = torch.Generator().manual_seed(11)
    q, kk, vv = (_cpu_rows(cpu_gen, (B, T, 32, 128)) for _ in range(3))
    outs, caches = [], []
    for dev in ("cpu", "cuda"):
        state = model.init_state(B, torch.bfloat16, dev)
        offset = torch.tensor([70, 5], device=dev)
        ar = torch.arange(T, device=dev)
        pos_k, _ = ring_positions(offset, T, cap)
        delta = (offset[:, None] + ar)[:, :, None] - pos_k[:, None, :]
        mask = ((pos_k[:, None, :] >= 0) & (delta >= 0) & (delta < cap))[:, None]
        outs.append(model._quant_ring_attention(
            q.to(dev), kk.to(dev), vv.to(dev), state=state, layer=0,
            write_idx=(offset[:, None] + ar) % cap, mask=mask))
        caches.append({k: v.cpu() for k, v in state.items() if k != "offset"})
    torch.cuda.synchronize()
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(caches[1][name], caches[0][name]), name
    assert _rel(outs[1].cpu(), outs[0]) <= BOUND[torch.bfloat16]


@pytest.mark.parametrize("top_k", [0, 25, 250])
def test_written_out_draw_is_multinomials_on_the_card(top_k, gen):
    """On the card too, sample_token's exponential race draws what
    torch.multinomial draws for the same seeded CUDA generator, with and
    without top-k, over a run of draws from one generator."""
    from moshi_tpu_torch.utils.sampling import sample_token
    ours = torch.Generator(device="cuda").manual_seed(3)
    theirs = torch.Generator(device="cuda").manual_seed(3)
    for V in (64, 2048, 32000):
        logits = 3 * torch.randn(16, V, device="cuda", generator=gen)
        for temp in (0.7, 1.0):
            got = sample_token(ours, logits, use_sampling=True, temp=temp, top_k=top_k)
            if top_k:
                vals, idx = torch.topk(logits, min(top_k, V), dim=-1)
                want = torch.gather(idx, -1, torch.multinomial(
                    torch.softmax(vals / temp, dim=-1), 1, generator=theirs))[..., 0]
            else:
                want = torch.multinomial(torch.softmax(logits / temp, dim=-1), 1,
                                         generator=theirs)[..., 0]
            assert torch.equal(got, want), (V, temp)


# --------------------------------------------- frames as CUDA-graph replays
def _tiny_moshi(kv_cache_dtype="model"):
    """A small Moshi LM (2 layers, dim 256, 2 heads of 128, q4 temporal
    linears and text head, int8 depformer) and a small bf16 Mimi, both
    from a seed on the card: every kernel of the frame path runs."""
    from moshi_tpu_torch.models.lm import LmConfig, LMModel
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.modules.seanet import SEANetConfig
    from moshi_tpu_torch.modules.transformer import TransformerConfig
    from moshi_tpu_torch.quantization.vq import RVQConfig

    cfg = LmConfig(dim=256, num_heads=2, num_layers=2, n_q=4, dep_q=2, card=128,
                   text_card=128, context=12, depformer_dim=64, depformer_num_heads=2,
                   depformer_num_layers=2, depformer_dim_feedforward=192,
                   delays=(0, 0, 1, 0, 2), kv_cache_dtype=kv_cache_dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    lm = LMModel(cfg)
    lm_params = tq.quantize_lm_params(lm.init_params(g, torch.bfloat16, "cuda"),
                                      min_size=1, mode="int4")
    mcfg = MimiConfig(
        sample_rate=1200, seanet=SEANetConfig(dimension=32, n_filters=4, ratios=(4, 3, 2)),
        transformer=TransformerConfig(d_model=32, num_heads=2, num_layers=2,
                                      dim_feedforward=64, context=25, gating="none",
                                      norm="layer_norm", layer_scale=0.01),
        quantizer=RVQConfig(dimension=16, input_dimension=32, output_dimension=32, n_q=8,
                            bins=32),
        num_codebooks=4)
    mimi = MimiModel(mcfg)
    return mimi, mimi.init_params(g, torch.bfloat16, "cuda"), lm, lm_params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _states_equal(a, b):
    """Every state tensor of two engines, byte for byte."""
    for key in ("enc_state", "dec_state", "gen_state"):
        la, lb = list(_leaves(getattr(a, key))), list(_leaves(getattr(b, key)))
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert torch.equal(x, y), key


def _server(graphed, **kw):
    from moshi_tpu_torch.serve.server import ServerState
    state = ServerState(*_tiny_moshi(), device="cuda", graphed=graphed, **kw)
    state.warmup()
    return state


def test_graphed_server_equals_eager_across_a_reset(gen):
    """B = 1, greedy: two sessions with a reset between (the ring of 12
    wraps in 20 frames).  The graphed server's tokens and PCM equal the
    eager server's, and after each session every KV cache and Mimi state
    byte does; reset moves no tensor and each graph is captured once."""
    from moshi_tpu_torch.serve.server import serve_sessions
    graphed, eager = _server(True, use_sampling=False), _server(False, use_sampling=False)
    ptrs = [t.data_ptr() for t in _leaves(graphed.gen_state)]
    for seed in (3, 4):
        (tg, ag, _), = serve_sessions(graphed, [seed], 20)
        (te, ae, _), = serve_sessions(eager, [seed], 20)
        assert len(tg) == 20 - graphed.lm.config.max_delay
        np.testing.assert_array_equal(tg, te)
        assert len(ag) == len(ae) == len(tg)
        for x, y in zip(ag, ae):
            np.testing.assert_array_equal(x, y)
        _states_equal(graphed, eager)
    assert [t.data_ptr() for t in _leaves(graphed.gen_state)] == ptrs
    assert graphed.step.replays == 40 and graphed.decode.replays == 2 * len(tg)


def test_init_state_keeps_the_delays_tensor_a_step_reads(gen):
    """LMGen copies the delays to the card once: a later init_state (a
    reset) on "cuda" returns the "cuda:0" tensor a captured step reads,
    not a new one (the old one freed, the graph would read whatever took
    its memory)."""
    from moshi_tpu_torch.models.lm_gen import LMGen
    _, _, lm, _ = _tiny_moshi()
    lm_gen = LMGen(lm)
    lm_gen.init_state(1, None, torch.bfloat16, torch.device("cuda"))
    first = lm_gen._delays(torch.device("cuda", 0))
    lm_gen.init_state(1, None, torch.bfloat16, torch.device("cuda"))
    lm_gen.init_state(1, None, torch.bfloat16, "cuda:0")
    assert lm_gen._delays(torch.device("cuda")) is first
    assert lm_gen._delays(torch.device("cuda", 0)) is first


def test_graphed_server_sampling_follows_the_session_seed(gen):
    """Sampling on: one seed replays its tokens across a reset, two seeds
    differ, and the graph's draws are the eager server's (the generator is
    registered with the graph, so each replay draws on and manual_seed
    takes effect)."""
    from moshi_tpu_torch.serve.server import serve_sessions
    graphed = serve_sessions(_server(True), [5, 5, 6], 16)
    np.testing.assert_array_equal(graphed[0][0], graphed[1][0])
    assert not np.array_equal(graphed[0][0], graphed[2][0])
    eager = serve_sessions(_server(False), [5, 6], 16)
    np.testing.assert_array_equal(graphed[0][0], eager[0][0])
    np.testing.assert_array_equal(graphed[2][0], eager[1][0])


def _session_messages(state, query, payloads):
    """One session through ServerState.run_session, no socket: the
    messages it sends."""
    import asyncio
    out = []

    async def messages():
        for p in payloads:
            yield p

    async def send(b):
        out.append(b)

    asyncio.run(state.run_session(query, messages(), send))
    return out


def test_graphed_server_sessions_with_overrides_equal_eager(gen, tmp_path):
    """Raw-PCM sessions through the session loop: greedy by default, then
    sampling overrides with one text_seed twice and another once, and an
    override set with the repetition penalty.  Each override set gets its
    own captured step, warmed before its capture; the graphed server sends
    the eager server's messages byte for byte, one seed repeats and two
    differ."""
    import json
    from moshi_tpu_torch.text.spm import SentencePieceTokenizer, spm_model_bytes
    (tmp_path / "t.model").write_bytes(spm_model_bytes(128))
    tok = SentencePieceTokenizer(tmp_path / "t.model")
    servers = [_server(g, text_tokenizer=tok, temp=0.0, temp_text=0.0) for g in (True, False)]
    sampled = {"text_temperature": "0.7", "audio_temperature": "0.8"}
    queries = [{}, {**sampled, "text_seed": "5"}, {**sampled, "text_seed": "5"},
               {**sampled, "text_seed": "6"},
               {"text_temperature": "0.7", "repetition_penalty": "1.3",
                "repetition_penalty_context": "8"}]
    fs = servers[0].frame_size
    pcm = (0.3 * np.random.RandomState(0).randn(16, fs)).astype(np.float32)
    payloads = ([b"\x04" + json.dumps({"raw_pcm": True}).encode()]
                + [b"\x0a" + f.tobytes() for f in pcm] + [b"\x06"])
    got = [[_session_messages(s, q, payloads) for q in queries] for s in servers]
    assert got[0] == got[1]
    graphed = got[0]
    assert graphed[1] == graphed[2] and graphed[1] != graphed[3]
    assert sum(m[0] == 10 for m in graphed[0]) == 16 - 1 - servers[0].lm.config.max_delay
    assert any(m[0] == 2 for m in graphed[0])
    steps = [g.step for g in servers[0]._gens.values()]
    assert len(steps) == 3 and all(s.graph is not None for s in steps)


def _session(state, query, payloads):
    """One session through run_session, in-process; its messages, once
    its snapshot (if any) is on the host."""
    import asyncio
    out = []

    async def messages():
        for p in payloads:
            yield p

    async def send(b):
        out.append(b)

    async def run():
        await state.run_session(query, messages(), send)
        if state._push_task is not None:
            await state._push_task

    asyncio.run(run())
    return out


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_graphed_server_resume_equals_unbroken(kind, gen):
    """A graphed B = 1 server: 1 + 6 frames, a drop, the resume and 6
    more equal an unbroken 13-frame session byte for byte (the restore
    writes the captured buffers in place and sets the generator's seed and
    offset), greedy and sampled."""
    import json
    kw = {"use_sampling": False} if kind == "greedy" else {"temp": 0.8, "temp_text": 0.7}
    state = _server(True, **kw)
    ptrs = [t.data_ptr() for t in _leaves([state.enc_state, state.dec_state, state.gen_state])]
    fs = state.frame_size
    pcm = (0.3 * np.random.RandomState(2).randn(13, fs)).astype(np.float32)
    raw = [b"\x04" + json.dumps({"raw_pcm": True}).encode()]
    frames = [b"\x0a" + f.tobytes() for f in pcm]
    query = {"resume_support": "1", "text_seed": "9"}
    full = _session(state, query, raw + frames)
    first = _session(state, query, raw + frames[:7])
    rid = json.loads(first[1][1:])["resume_id"]
    second = _session(state, {"resume": rid}, raw + frames[7:])
    assert json.loads(second[1][1:])["resumed"] is True
    pcm_of = lambda msgs: [m for m in msgs if m[0] == 10]  # noqa: E731
    assert pcm_of(first) + pcm_of(second) == pcm_of(full)
    assert len(pcm_of(full)) == 12 - state.lm.config.max_delay
    assert [t.data_ptr() for t in _leaves([state.enc_state, state.dec_state,
                                          state.gen_state])] == ptrs


def _tiny_vision():
    """_tiny_moshi's LM with the vision presets' cross-attention: gated by
    a conditional sigmoid, an RMS cross-norm, one shared q4 projection
    set."""
    from dataclasses import replace
    from moshi_tpu_torch.models.lm import LMModel
    mimi, mimi_params, lm, _ = _tiny_moshi()
    cfg = replace(lm.config, cross_attention=True,
                  cross_attention_gating="conditional_gated_sigmoid",
                  cross_attention_norm="rms_norm_f32", shared_cross_attn=True)
    lm = LMModel(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = tq.quantize_lm_params(lm.init_params(g, torch.bfloat16, "cuda"), min_size=1,
                                   mode="int4")
    assert isinstance(params["transformer"]["cross_attn_shared"]["kv_proj"], tq.QTensor4)
    return mimi, mimi_params, lm, params


def test_cross_state_in_place_under_a_captured_step(gen):
    """Images into a graphed server between frames: the second image of the
    same size is written into the first one's K/V tensors, which the step
    captured with the cross block keeps reading (one capture); its rows
    equal precompute_cross's eager ones, and the tokens the eager server's
    over the same frames and images."""
    from moshi_tpu_torch.serve.server import ServerState
    models = _tiny_vision()
    rs = np.random.RandomState(3)
    images = [rs.randn(5, models[2].config.dim).astype(np.float32) for _ in range(2)]
    pcm = (0.3 * rs.randn(18, models[0].frame_size)).astype(np.float32)
    got = {}
    for graphed in (True, False):
        state = ServerState(*models, device="cuda", graphed=graphed, use_sampling=False)
        state.warmup()
        state.capture()
        state.skip_frame(pcm[0])
        seen = []
        for i, f in enumerate(pcm[1:]):
            if i in (3, 9):
                state.set_image_embeddings(images[i == 9])
                k = state.gen_state["transformer"]["k_cross"]
                seen.append((k, k.data_ptr()))
            state.step_frame(f)
        tr = state.gen_state["transformer"]
        src = torch.from_numpy(images[1]).cuda()[None]
        want = models[2].transformer.precompute_cross(models[3]["transformer"], src,
                                                      models[3]["text_emb"]["weight"].dtype)
        for k in ("k_cross", "v_cross"):
            assert torch.equal(tr[k], want[k])
        assert seen[0][0] is seen[1][0] and seen[0][1] == seen[1][1]
        got[graphed] = np.stack(state.session_tokens)
        if graphed:
            assert state._gens[()].step_cross.replays == 17 - 3
    np.testing.assert_array_equal(got[True], got[False])


def test_replication_copy_between_replays_is_the_state_at_its_step(gen):
    """A replication's copy, made on the card between two replays and moved
    to the host on the copy stream after three more replays overwrote the
    live buffers, equals the state of a twin server stopped at that step."""
    from moshi_tpu_torch.serve.server import ServerState
    from moshi_tpu_torch.utils.trees import to_device
    models = _tiny_moshi()
    a = ServerState(*models, device="cuda", graphed=True, temp=0.8)
    b = ServerState(*models, device="cuda", graphed=True, temp=0.8)
    pcm = (0.3 * np.random.RandomState(4).randn(12, a.frame_size)).astype(np.float32)
    for s in (a, b):
        s.warmup()
        s.skip_frame(pcm[0])
    for f in pcm[1:8]:
        a.step_frame(f)
        b.step_frame(f)
    copies, ready = a._state_copy()
    for f in pcm[8:]:
        a.step_frame(f)
    host = a._host(copies, ready)
    want, _ = b._state_copy()
    want = to_device(want, "cpu")
    flat = lambda t: list(_leaves(t))  # noqa: E731
    assert len(flat(host)) == len(flat(want)) > 0
    for x, y in zip(flat(host), flat(want)):
        assert x.device.type == "cpu" and torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert not all(torch.equal(x.view(torch.uint8), y.cpu().view(torch.uint8)) for x, y in
                   zip(flat(host), flat({"enc": a.enc_state, "dec": a.dec_state})))


def _graph_schedule():
    """tick -> {slot: action} at B = 4: the schedule of
    tests/test_torch_batched_server.py (slot 2 joins late, slot 1 freezes
    for two ticks, slot 0 resets at tick 9), with slot 3 joining at tick 1,
    frozen at ticks 6-7 and reset at tick 12."""
    ticks = ([{0: "join", 1: "join"}] + [{0: "send", 1: "send"}] * 3
             + [{0: "send", 1: "send", 2: "join"}, {0: "send", 1: "send", 2: "send"}]
             + [{0: "send", 2: "send"}] * 2 + [{0: "send", 1: "send", 2: "send"}]
             + [{0: "join", 1: "send", 2: "send"}] + [{0: "send", 1: "send", 2: "send"}] * 2
             + [{0: "send", 1: "send"}] + [{0: "send", 1: "send", 2: "send"}] * 5)
    ticks = [dict(t) for t in ticks]
    for i, tick in enumerate(ticks):
        if i in (1, 12):
            tick[3] = "join"
        elif i > 1 and i not in (6, 7):
            tick[3] = "send"
    return ticks


GRAPH_SCHEDULE = _graph_schedule()


@pytest.mark.parametrize("kv", ["int4", "int8"])
def test_graphed_batched_frames_equal_eager(kv, gen):
    """B = 4, greedy, over joins, freezes and resets: the graphed engine's
    tokens and PCM equal the eager engine's session by session, and every
    KV cache and Mimi state byte does at the end; the frame is captured
    once and replayed at every frame (the first tick, two joins whose
    frames are dropped, runs none)."""
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState, serve_batched
    models = _tiny_moshi(kv)
    rs = np.random.RandomState(0)
    frames = {s: rs.randn(len(GRAPH_SCHEDULE), models[0].frame_size).astype(np.float32)
              for s in range(4)}
    runs = []
    for graphed in (True, False):
        state = BatchedMoshiState(*models, 4, device="cuda", graphed=graphed,
                                  use_sampling=False)
        state.warmup()
        runs.append((state, *serve_batched(state, GRAPH_SCHEDULE, frames)))
    (g, sg, msg), (e, se, _) = runs
    assert g.step.replays == len(msg) == len(GRAPH_SCHEDULE) - 1
    for s in range(4):
        assert len(sg[s]) == len(se[s]) == (2 if s in (0, 3) else 1)
        for (tg, ag), (te, ae) in zip(sg[s], se[s]):
            assert len(tg) > 0
            np.testing.assert_array_equal(tg, te)
            for x, y in zip(ag, ae):
                np.testing.assert_array_equal(x, y)
    _states_equal(g, e)


def test_graphed_frame_counts_its_launches_once(gen):
    """The kernels' counters tick when the capture records a launch: after
    warm-up, three graphed frames count what one eager frame counts."""
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState
    counted = [q4matmul.q4_gemv, q4matmul.q4_mma, qmatmul.int8_gemv, qmatmul.int8_mma,
               i4.decode_attention_int4_stats, i4.decode_attention_int4_write,
               da8.decode_attention_int8]
    models = _tiny_moshi("int4")
    pcm = np.zeros((4, 1, models[0].frame_size), np.float32)
    counts = []
    for graphed, frames in ((False, 1), (True, 3)):
        state = BatchedMoshiState(*models, 4, device="cuda", graphed=graphed)
        state.warmup()
        for fn in counted:
            fn.launches = 0
        for _ in range(frames):
            state.frame(pcm, np.ones(4, bool))
        torch.cuda.synchronize()
        counts.append([fn.launches for fn in counted])
    assert counts[0] == counts[1] and sum(counts[0]) > 0
    assert counts[0][4] == counts[0][5] == 2  # a fused K4 write per layer


def test_graphed_step_refuses_what_it_cannot_replay(gen):
    """A graphed step raises before its warm-up call, and when called with
    other tensors than those it was captured with."""
    from moshi_tpu_torch.utils.graphs import GraphedStep
    step = GraphedStep(lambda x: x * 2, graphed=True)
    x = torch.arange(4.0, device="cuda")
    with pytest.raises(RuntimeError):
        step(x)
    step.warm_up(x)
    assert torch.equal(step(x), 2 * x)
    x.add_(1)
    assert torch.equal(step(x), 2 * x) and step.replays == 2
    with pytest.raises(ValueError):
        step(x.clone())


# ---------------------------------------- the ASR frame as CUDA-graph replays
def _tiny_asr_models():
    """A small speech-to-text LM (dep_q = 0, 2 layers, dim 256, 2 heads of
    128, int8 KV cache over a ring of 12, two extra heads) in bf16, the
    small bf16 Mimi of _tiny_moshi and a `delay`-like sum condition, all
    from a seed on the card."""
    from moshi_tpu_torch.models.lm import LmConfig, LMModel
    mimi, mimi_params, _, _ = _tiny_moshi()
    cfg = LmConfig(dim=256, num_heads=2, num_layers=2, n_q=4, dep_q=0, card=128,
                   text_card=128, context=12, delays=(0,) * 5, kv_cache_dtype="int8",
                   extra_heads_num_heads=2, extra_heads_dim=2)
    g = torch.Generator(device="cuda").manual_seed(1)
    lm = LMModel(cfg)
    cond = 0.1 * torch.randn((1, 1, cfg.dim), generator=g, device="cuda")
    return mimi, mimi_params, lm, lm.init_params(g, torch.bfloat16, "cuda"), cond


def test_graphed_lm_gen_without_depformer_equals_eager(gen):
    """LMGen.step of a dep_q = 0 LM (the speech-to-text path of
    run_inference) captured by GraphedStep gives the eager step's greedy
    text frames [B, 1, 1] over 12 frames."""
    from moshi_tpu_torch.models.lm_gen import LMGen, LMGenConfig
    from moshi_tpu_torch.utils.graphs import GraphedStep
    _, _, lm, lm_params, _ = _tiny_asr_models()
    B = 2
    tokens = torch.randint(0, 128, (12, B, 4, 1), generator=gen, device="cuda")
    outs = {}
    for graphed in (False, True):
        lm_gen = LMGen(lm, LMGenConfig(use_sampling=False))
        state = lm_gen.init_state(B, None, torch.bfloat16, "cuda")
        tokens_in = tokens[0].clone()
        step = GraphedStep(lambda x: lm_gen.step(lm_params, state, x)[0], graphed=graphed)
        frames = [step.warm_up(tokens_in).clone()]
        for f in range(1, len(tokens)):
            tokens_in.copy_(tokens[f])
            frames.append(step(tokens_in).clone())
        outs[graphed] = torch.stack(frames).cpu()
        assert step.replays == (len(tokens) - 1 if graphed else 0)
    assert outs[True].shape == (12, B, 1, 1)
    assert torch.equal(outs[True], outs[False])


def _asr_engine(models, batch, graphed, **kw):
    from moshi_tpu_torch.models.asr import StreamingASR
    from moshi_tpu_torch.serve.batched_asr import BatchedAsrState
    mimi, mimi_params, lm, lm_params, cond = models
    asr = StreamingASR(mimi, lm, batch, asr_delay_in_tokens=2, mimi_dtype=torch.bfloat16,
                       sum_condition=cond, device="cuda", graphed=graphed, **kw)
    state = BatchedAsrState(asr, mimi_params, lm_params)
    state.warmup()
    return state


def _asr_schedule(batch):
    """GRAPH_SCHEDULE's joins, freezes and resets on slots 0-3, with slot
    3's session leaving at tick 6 (a new tenant on slot 3 at tick 7) and
    resuming on slot 1 at tick 10; slots 4.. join at tick 0 and send at
    every tick."""
    ticks = [dict(t) for t in GRAPH_SCHEDULE]
    ticks[6][3] = "leave"
    ticks[7][3] = "join"
    ticks[10][1] = ("resume", 3)
    for i, tick in enumerate(ticks):
        tick.update(dict.fromkeys(range(4, batch), "join" if i == 0 else "send"))
    return ticks


def _asr_leaves(state):
    return list(_leaves({k: state.state[k] for k in ("mimi", "transformer")}))


def _same_bytes(a, b):
    """Equal bit for bit, NaN included: a slot frozen at offset 0 writes
    NaN rows into Mimi's KV cache, as the JAX package's does."""
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("batch", [4, 256])
def test_graphed_asr_equals_eager(batch, gen):
    """Greedy, over joins, freezes, resets and one resume: the graphed
    engine's text tokens and messages equal the eager engine's session by
    session, and so does every state byte at the end; resets and the
    restore move no state tensor, each graph is captured once and replayed
    at every frame, and the capture counted one frame's K6 launches."""
    from moshi_tpu_torch.serve.batched_asr import serve_asr
    models = _tiny_asr_models()
    schedule = _asr_schedule(batch)
    rs = np.random.RandomState(0)
    frames = {s: rs.randn(len(schedule), models[0].frame_size).astype(np.float32)
              for s in range(batch)}
    runs = []
    for graphed in (True, False):
        state = _asr_engine(models, batch, graphed)
        ptrs = [t.data_ptr() for t in _asr_leaves(state)]
        da8.decode_attention_int8.launches = 0
        sessions, ms = serve_asr(state, schedule, frames)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in _asr_leaves(state)] == ptrs
        runs.append((state, sessions, ms, da8.decode_attention_int8.launches))
    (g, sg, msg, kg), (e, se, mse, ke) = runs
    layers = models[2].config.num_layers
    assert len(msg) == len(mse) == len(schedule)
    assert g.asr.encode.replays == g.asr.step.replays == len(msg)
    assert kg == layers and ke == layers * len(mse)
    assert g.slot_resumed[1] and g.asr.items[1].step_idx == e.asr.items[1].step_idx
    for s in range(batch):
        assert len(sg[s]) == len(se[s]) > 0
        for (tg, mg), (te, me) in zip(sg[s], se[s]):
            np.testing.assert_array_equal(tg, te)
            assert mg == me
    for a, b in zip(_asr_leaves(g), _asr_leaves(e)):
        assert _same_bytes(a, b)


def test_graphed_asr_sampling_draws_as_eager(gen):
    """Temperature 0.8: the graphed engine draws from its own generator,
    registered with the step's graph, the eager engine's draws from the
    same seed; another seed draws otherwise."""
    from moshi_tpu_torch.serve.batched_asr import serve_asr
    models = _tiny_asr_models()
    schedule = [dict.fromkeys(range(4), "join")] + [dict.fromkeys(range(4), "send")] * 11
    rs = np.random.RandomState(1)
    frames = {s: rs.randn(12, models[0].frame_size).astype(np.float32) for s in range(4)}
    tokens = []
    for graphed, seed in ((True, 5), (False, 5), (True, 6)):
        state = _asr_engine(models, 4, graphed, temperature=0.8, rng_seed=seed)
        sessions, _ = serve_asr(state, schedule, frames)
        tokens.append(np.stack([sessions[s][0][0] for s in range(4)]))
    np.testing.assert_array_equal(tokens[0], tokens[1])
    assert not np.array_equal(tokens[0], tokens[2])


# ---------------------------------------- the TTS frame as CUDA-graph replays
class _Tok:
    def encode(self, word):
        return [7 + len(word) % 13]


def _tiny_tts(kv):
    """A small TTS LM (2 layers, dim 128, 2 heads of 64 as in tts_v0_1,
    cross-attention, a 129-column text head and 129-entry audio tables, int8
    weights, `kv` cache over a ring of 12), the small bf16 Mimi of
    _tiny_moshi, a speaker_wavs tensor condition (cross) and a `cfg` LUT
    (sum), all from a seed on the card."""
    from moshi_tpu_torch.conditioners import (ConditionFuser, ConditionProvider,
                                              LUTConditioner, TensorConditioner)
    from moshi_tpu_torch.models.lm import LmConfig, LMModel
    from moshi_tpu_torch.models.tts import StateMachine, TokenIds, TTSModel
    mimi, mimi_params, _, _ = _tiny_moshi()
    cfg = LmConfig(dim=128, num_heads=2, num_layers=2, n_q=4, dep_q=4, card=129,
                   text_card=128, text_card_out=129, context=12, depformer_dim=64,
                   depformer_num_heads=2, depformer_num_layers=2,
                   depformer_dim_feedforward=192, gating="none", norm="layer_norm",
                   hidden_scale=4.0, cross_attention=True, delays=(0, 0, 2, 2, 2),
                   kv_cache_dtype=kv)
    g = torch.Generator(device="cuda").manual_seed(2)
    lm = LMModel(cfg)
    lm_params = tq.quantize_lm_params(lm.init_params(g, torch.bfloat16, "cuda"), min_size=1)
    provider = ConditionProvider({
        "speaker_wavs": TensorConditioner(output_dim=cfg.dim, dim=16),
        "cfg": LUTConditioner(output_dim=cfg.dim, n_bins=3, dim=8,
                              possible_values=["1.0", "2.0", "3.0"])})
    tts = TTSModel(lm, mimi, _Tok(), StateMachine(TokenIds(card=cfg.text_card + 1),
                                                  max_padding=3, initial_padding=1),
                   delay_steps=2, condition_provider=provider,
                   fuser=ConditionFuser({"cross": ["speaker_wavs"], "sum": ["cfg"]}),
                   max_speakers=2, temp=0.0, n_q=cfg.dep_q, final_padding=2)
    return tts, lm_params, mimi_params, provider.init_params(g, torch.float32, "cuda")


def _tts_engine(models, batch, graphed):
    from moshi_tpu_torch.serve.batched_tts import BatchedTTSState
    tts, lm_params, mimi_params, cp = models
    state = BatchedTTSState(tts, lm_params, mimi_params, batch, condition_params=cp,
                            voice_frames=5, device="cuda", graphed=graphed)
    state.warmup()
    return state


def _tts_schedule(batch):
    """30 ticks: slot 1 alone and voiceless first (the unconditioned mode),
    slot 0 with voice A starving 3 ticks before its last words, slot 2 with
    voice B taking voice C at tick 14, slot 0 reset at tick 20, slot 3
    leaving at tick 22; slots 4.. join at tick 4 with voices of their own."""
    rs = np.random.RandomState(7)
    voice = [rs.randn(5, 16).astype(np.float32) for _ in range(batch + 3)]
    sched = [{} for _ in range(30)]
    sched[0] = {1: [("join", None), ("words", ["alpha beta gamma delta epsilon zeta"])]}
    sched[2] = {0: [("join", voice[0]), ("words", ["one two"]),
                    ("refill", 3, ["three four five six"], True)],
                3: [("join", voice[3]), ("words", ["over there somewhere far"])]}
    sched[4] = {s: [("join", voice[s]), ("words", ["words of slot", str(s)])]
                for s in range(4, batch)}
    sched[6] = {2: [("join", voice[1]), ("words", ["hello world again"]), "eos"]}
    sched[14] = {2: [("voice", voice[2])]}
    sched[20] = {0: [("join", voice[0]), ("words", ["one two three"]), "eos"]}
    sched[22] = {3: ["leave"]}
    return sched


def _tts_leaves(state):
    return list(_leaves([state.gen_state_cross, state.dec_state, state.cond_sum]))


@pytest.mark.parametrize("kv", ["int4", "int8"])
@pytest.mark.parametrize("batch", [4, 16, 32])
def test_graphed_tts_equals_eager(batch, kv, gen):
    """Greedy, over a voiceless start, joins, a starve, a voice change, a
    reset and a leave: the graphed engine's output frames, Text events and
    PCM equal the eager engine's session by session, and every state byte
    (the cross K/V and the summed condition too) does at the end; no op
    between frames moves a state tensor; graph 1 is captured once in each
    mode, graph 2 once, and the captures counted one frame's K4 or K6
    launches per mode.  At 32 slots the int8 linears take 32 rows: one
    int8_wgmma launch each where dout is a multiple of 64, 16-row chunks
    of the int8_gemv kernel otherwise."""
    from moshi_tpu_torch.serve.batched_tts import serve_tts
    models = _tiny_tts(kv)
    schedule = _tts_schedule(batch)
    attn = i4.decode_attention_int4_stats if kv == "int4" else da8.decode_attention_int8
    runs = []
    for graphed in (True, False):
        state = _tts_engine(models, batch, graphed)
        ptrs = [t.data_ptr() for t in _tts_leaves(state)]
        attn.launches = 0
        sessions, ticks = serve_tts(state, schedule)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in _tts_leaves(state)] == ptrs
        runs.append((state, sessions, ticks, attn.launches))
    (g, sg, tg, kg), (e, se, te, ke) = runs
    layers = models[0].lm.config.num_layers
    assert len(tg) == len(te) == 30
    assert g.main[False].replays == 2 and g.main[True].replays == 28
    assert g.depth.replays == 30
    assert kg == 2 * layers and ke == 30 * layers
    pcm = 0
    for s in range(batch):
        assert len(sg[s]) == len(se[s]) > 0
        for a, b in zip(sg[s], se[s]):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            assert a["events"] == b["events"] and a["eos"] == b["eos"]
            assert len(a["pcm"]) == len(b["pcm"])
            for x, y in zip(a["pcm"], b["pcm"]):
                np.testing.assert_array_equal(x, y)
            pcm += len(a["pcm"])
    assert pcm > 0 and sg[2][0]["eos"]
    for a, b in zip(_tts_leaves(g), _tts_leaves(e)):
        assert _same_bytes(a, b)


def _engine_bytes(leaves):
    return sum(t.numel() * t.element_size() for t in leaves)


@pytest.mark.parametrize("engine", ["asr", "server", "batched", "tts"])
def test_dropped_engine_frees_its_memory_without_the_cycle_collector(engine, gen):
    """A graphed engine and its GraphedSteps form no reference cycle: with
    the cycle collector off, `del` frees the engine's state on the card."""
    import gc
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState
    gc.collect()
    gc.disable()
    try:
        if engine == "asr":
            state = _asr_engine(_tiny_asr_models(), 16, True)
            for s in range(16):
                state.open_slot(s)
                state.feed_pcm(s, np.zeros(2 * state.frame_size, np.float32))
            for _ in range(2):
                state.tick()
            held = _engine_bytes(_asr_leaves(state))
        elif engine == "server":
            state = _server(True)
            for _ in range(2):
                state.step_frame(np.zeros(state.frame_size, np.float32))
            held = _engine_bytes(_leaves([state.enc_state, state.dec_state, state.gen_state]))
        elif engine == "tts":
            state = _tts_engine(_tiny_tts("int4"), 16, True)
            for s in range(16):
                state.open_slot(s)
                state.set_slot_voice(s, np.ones((5, 16), np.float32))
                state.feed_words(s, ["some words"])
            for _ in range(2):
                state.tick()
            held = _engine_bytes(_tts_leaves(state))
        else:
            state = BatchedMoshiState(*_tiny_moshi("int8"), 16, device="cuda", graphed=True)
            state.warmup()
            for _ in range(2):
                state.frame(np.zeros((16, 1, state.frame_size), np.float32), np.ones(16, bool))
            held = _engine_bytes(_leaves([state.enc_state, state.dec_state, state.gen_state]))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        del state
        after = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    assert held > 0 and before - after >= held


# int8 above a decoding batch: int8_gemv (the entry int8_linear calls) runs
# bf16 x as one int8_wgmma launch, f32 x as chunks of at most 16 rows, one
# launch each, into one output
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [33, 512])
def test_int8_chunked_rows(M, dtype, gen):
    """M = 33 (two whole chunks and one row) and 512 (the training
    forward's B * T) at a depformer shape, bf16 on one int8_wgmma launch and
    f32 on the int8_gemv kernel in ceil(M / 16) launches, against the plain
    version; the per-launch kernels still refuse more than 16 rows."""
    din, dout = 1024, 3072
    qt = tq.quantize_tensor(torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5)
    x = torch.randn(M, din, device="cuda", generator=gen).to(dtype)
    counted = (qmatmul.int8_gemv, qmatmul.int8_mma, qmatmul.int8_wgmma)
    n = [fn.launches for fn in counted]
    y = qmatmul.int8_gemv(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert [fn.launches - k for fn, k in zip(counted, n)] == (
        [0, 0, 1] if dtype == torch.bfloat16 else [-(-M // 16), 0, 0])
    assert y.dtype == dtype and tuple(y.shape) == (M, dout)
    assert _rel(y, qmatmul.int8_gemv_plain(x, qt.q, qt.scale)) <= BOUND[dtype]
    with pytest.raises(ValueError):
        qmatmul.int8_mma(x[:17].to(torch.bfloat16), qt.q, qt.scale)
    with pytest.raises(ValueError):
        qmatmul.int8_gemv_kernel(x[:17], qt.q, qt.scale)


@pytest.mark.parametrize("kind", ["q4", "int8"])
def test_frozen_linear_dx_on_the_card(kind, gen):
    """Under autograd the kernel runs forward (its launch counted) and dX
    equals the plain path's, autograd through the plain version's torch
    ops, at the training forward's 512 rows; the weight gets no grad."""
    din, dout = 4096, 1024
    w = torch.randn(din, dout, device="cuda", generator=gen) / din ** 0.5
    if kind == "q4":
        qt, linear, plain = tq.quantize_tensor4(w), q4matmul.q4_linear, q4matmul.q4_gemv_plain
        counted = q4matmul.q4_wgmma
    else:
        qt, linear, plain = tq.quantize_tensor(w), qmatmul.int8_linear, qmatmul.int8_gemv_plain
        counted = qmatmul.int8_wgmma
    x = torch.randn(2, 256, din, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(2, 256, dout, device="cuda", generator=gen).to(torch.bfloat16)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    n = counted.launches
    y = linear(xk, qt.q, qt.scale)
    assert counted.launches > n and type(y.grad_fn).__name__ == "FrozenLinearBackward"
    yp = plain(xp.reshape(-1, din), qt.q, qt.scale).reshape(2, 256, dout)
    assert _rel(y, yp) <= BOUND[torch.bfloat16]
    (dxk,) = torch.autograd.grad(y, xk, dy)
    (dxp,) = torch.autograd.grad(yp, xp, dy)
    assert _rel(dxk, dxp) <= BOUND[torch.bfloat16]
    assert qt.q.grad is None and qt.scale.grad is None


# ------------------------------------------ Helium: run_helium and its prefill
@pytest.mark.parametrize("din,dout", [(2560, 7680), (7040, 2560), (2560, 48000)])
def test_q4_wgmma_prefill_rows_write_nothing_past_y(din, dout, gen):
    """Helium-1 2B's 203-row prefill on q4_wgmma (its second 128-row tile
    75 rows full) at three of its shapes: within the bf16 bound of the
    plain version, equal to the wrapper's result, and no byte of a guard
    band of rows before and after y, and after the split partials,
    written."""
    from moshi_tpu_torch.ops import build
    M, G, sentinel = 203, 64, 7.0
    x, qt = _mma_case(gen, M, din, dout)
    gs = din // qt.scale.shape[0]
    gps, splits = q4matmul.wgmma_plan_splits(din, dout, gs, q4matmul._num_sms(0), M)
    ybuf = torch.full((M + 2 * G, dout), sentinel, dtype=torch.bfloat16, device="cuda")
    pbuf = torch.full((splits * M + 2 * G, dout), sentinel, dtype=torch.float32, device="cuda")
    y, partial = ybuf[G:G + M], pbuf[G:G + splits * M]
    lib = build.load("q4_wgmma")
    err = lib.q4_wgmma(x.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(), y.data_ptr(),
                       (partial if splits > 1 else y).data_ptr(), M, din, dout, gs, gps, splits,
                       torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "q4_wgmma")
    torch.cuda.synchronize()
    assert _rel(y, q4matmul.q4_gemv_plain(x, qt.q, qt.scale)) <= BOUND[torch.bfloat16]
    assert torch.equal(y, _wg_check(x, qt))
    for band in (ybuf[:G], ybuf[G + M:], pbuf[:G], pbuf[G + splits * M:]):
        assert (band == sentinel).all()


def _tiny_helium():
    """A small text-only LM (n_q = dep_q = 0, 2 layers of dim 256, q4 on
    every linear and the head) from a seed on the card."""
    from moshi_tpu_torch.models.lm import LmConfig, LMModel
    cfg = LmConfig(dim=256, num_heads=2, num_layers=2, n_q=0, dep_q=0, card=0, text_card=128,
                   context=64, delays=(0,))
    lm = LMModel(cfg)
    g = torch.Generator(device="cuda").manual_seed(3)
    return lm, tq.quantize_lm_params(lm.init_params(g, torch.bfloat16, "cuda"), min_size=1,
                                     mode="int4")


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_graphed_helium_step_equals_eager(temp, gen):
    """run_helium.generate_text graphed (the first step the warm-up, the
    second captured, replays after) gives the eager run's tokens, greedy
    and sampled from one seed; the prefill of 37 rows runs q4_wgmma, each
    step's linears the q4_gemv kernel, graphed twice only."""
    from moshi_tpu_torch.run_helium import generate_text
    lm, params = _tiny_helium()
    prompt = torch.randint(0, 128, (37,), generator=gen, device="cuda").tolist()
    counted = (q4matmul.q4_gemv, MMA, WG)
    per_step = 2 * 4 + 1
    runs = {}
    for graphed, decode_calls in ((False, 23), (True, 2)):
        n = [fn.launches for fn in counted]
        runs[graphed] = generate_text(lm, params, prompt, 24,
                                      torch.Generator(device="cuda").manual_seed(5), temp=temp,
                                      graphed=graphed)
        torch.cuda.synchronize()
        assert ([fn.launches - k for fn, k in zip(counted, n)]
                == [decode_calls * per_step, 0, per_step])
    assert runs[True] == runs[False] and len(runs[True]) == 24
