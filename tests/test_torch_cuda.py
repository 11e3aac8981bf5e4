"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from moshi_tpu_torch.ops import q4matmul, qmatmul
from moshi_tpu_torch.utils import quantize as tq

pytestmark = pytest.mark.cuda

# max |kernel - plain| / max |plain|: f32 differs by summation order only,
# bf16 by the plain version's bf16 rounding of the dequantized weights
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
KERNELS = {"q4": (q4matmul.q4_gemv, q4matmul.q4_gemv_plain, tq.quantize_tensor4),
           "int8": (qmatmul.int8_gemv, qmatmul.int8_gemv_plain, tq.quantize_tensor)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(y, ref):
    return ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", range(1, 9))
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
    the wrapper's launch count."""
    fn, _, quant = KERNELS[kernel]
    qt = quant(torch.randn(4096, 1024, device="cuda", generator=gen))
    x = torch.randn(2, 4096, device="cuda", generator=gen).to(torch.bfloat16)
    n = fn.launches
    a, b = fn(x, qt.q, qt.scale), fn(x, qt.q, qt.scale)
    assert torch.equal(a, b)
    assert fn.launches == n + 2


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_rejects_what_the_kernel_does_not_take(kernel, gen):
    fn, _, quant = KERNELS[kernel]
    qt = quant(torch.randn(256, 128, device="cuda", generator=gen))
    x = torch.randn(9, 256, device="cuda", generator=gen)
    with pytest.raises(ValueError):
        fn(x, qt.q, qt.scale)                      # batch above the kernel's 8
    with pytest.raises(ValueError):
        fn(x[:2], qt.q.cpu(), qt.scale)            # mixed devices
    with pytest.raises(TypeError):
        fn(x[:2].half(), qt.q, qt.scale)           # fp16 activations
    with pytest.raises(ValueError):
        fn(torch.randn(256, 2, device="cuda").T, qt.q, qt.scale)  # not contiguous
