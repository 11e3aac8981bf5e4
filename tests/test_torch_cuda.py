"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

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
    with pytest.raises(ValueError):
        fn(x, qt.q, qt.scale)                      # batch above the kernel's 16
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
        MMA(torch.cat([x] * 5), qt.q, qt.scale)          # batch above 16
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


# (B, H, Hkv, D, cap, layer): the main path's shape, D = 64, a capacity
# that is no multiple of the 1024-lane chunk, grouped KV heads
ATTN = [(16, 32, 32, 128, 3000, 5), (16, 32, 32, 64, 3000, 1), (3, 4, 4, 128, 1500, 2),
        (2, 8, 2, 64, 200, 0), (1, 4, 4, 128, 2048, 1)]


@pytest.mark.parametrize("B,H,Hkv,D,cap,layer", ATTN)
def test_decode_attention_int4(B, H, Hkv, D, cap, layer, gen):
    cap_pad = -(-cap // 128) * 128
    caches = _int4_cache(gen, layer + 1, B, Hkv, D, cap_pad)
    q = torch.randn(B, H, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.rand(B, cap, device="cuda", generator=gen) < 0.8
    mask[:, -1] = True                         # the last lane of a ragged chunk
    got = i4.decode_attention_int4_stats(q, layer, *caches, mask)
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_cache_write_int4(kv_repeat, gen):
    """Byte for byte the plain version's writes, for every slot: slot 1 is
    the frozen one, at a lane it wrote before."""
    L, B, H, D, cap_pad = 3, 4, 8, 128, 384
    Hkv = H // kv_repeat
    caches = _int4_cache(gen, L, B, Hkv, D, cap_pad)
    cols = [torch.randint(-128, 128, (L, B, Hkv * D // 2), device="cuda", generator=gen,
                          dtype=torch.int8) for _ in range(2)]
    scols = [torch.randn(L, B, Hkv, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2)]
    pos = torch.tensor([0, 7, 383, 200], device="cuda")
    ref = i4.cache_write_int4_plain(pos, *cols, *scols, *(c.clone() for c in caches))
    n = i4.cache_write_int4.launches
    got = i4.cache_write_int4(pos, *cols, *scols, *caches)
    torch.cuda.synchronize()
    assert i4.cache_write_int4.launches == n + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


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
# D = 64, a capacity that is no multiple of the 256-position chunk, grouped
# KV heads, a capacity below one chunk
INT8_ATTN = [(256, 8, 8, 128, 750, 5), (16, 32, 32, 128, 3000, 1), (16, 32, 32, 64, 3000, 0),
             (3, 4, 4, 128, 1500, 2), (2, 8, 2, 64, 200, 0), (1, 4, 4, 128, 100, 1)]


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
