"""Group-wise 4-bit weight-only matrix product: the wrappers of the CUDA
kernels `csrc/q4_gemv.cu`, `csrc/q4_mma.cu` and `csrc/q4_wgmma.cu` and
their plain PyTorch version.

Counterpart of moshi_tpu/ops/q4matmul.py (`q4gemm`, `q4gemm_stacked`),
which take x of any row count M.  A member of a stacked weight is a view
here, so one entry point covers both.  `q4_gemv` is the entry point: on a
CPU tensor it runs `q4_gemv_plain`; on a CUDA tensor, by M and dtype
(`route`):
- bf16 x of more than TILE_ROWS rows (the offline forward's B * T) ->
  `q4_wgmma`: wgmma over 128-row tiles, each weight unpacked once per tile
  into shared memory, one launch per call (its din-split reduce, where
  `wgmma_plan_splits` splits, is a second kernel of the same call);
- bf16 x of MMA_MIN_BATCH..TILE_ROWS rows (the decoding batch) -> `q4_mma`
  on the tensor cores (mma.sync), one launch per call, split as
  `mma_plan_splits` says;
- f32 x, bf16 x of one row, and shapes the tensor-core kernels do not take
  (`use_mma`) -> the `q4_gemv` kernel on the CUDA cores, one launch per
  MAX_BATCH rows: the wrapper loops over chunks of at most 16 rows,
  ceil(M / 16) launches a call (f32 is the parity dtype; no main path runs
  it on the card).
Either way a CUDA tensor launches a kernel or raises.
"""

import functools
import math

import torch

from ..utils.quantize import dequantize4
from . import build

MAX_BATCH = 16        # gemv::kMaxBatch: rows of one q4_gemv (and int8) launch
TILE_ROWS = MAX_BATCH  # q4_mma.cu kTileRows: the most rows of x q4_mma takes
BLOCK_COLS = 4 * 128  # gemv::kCols * gemv::kThreads
MAX_SPLIT_ROWS = 1024  # din rows a block stages in shared memory
STAGE_FLOATS = 48 * 1024 // 4  # gemv::kStageFloats: f32 [batch, rows] staged x
# q4_mma takes bf16 calls of MMA_MIN_BATCH rows and more: from B = 2 it is
# over twice as fast as the q4_gemv kernel on the H100; B = 1 stays on the
# q4_gemv kernel, within 3% of q4_mma there (PERF.md, the crossover table).
MMA_MIN_BATCH = 2
MMA_WARP_COLS = 64    # q4_mma.cu kWarpCols: eight n8 tiles
MMA_BLOCK_COLS = 4 * MMA_WARP_COLS  # q4_mma.cu kBlockCols: 4 warps
WGMMA_ROWS = 128      # q4_wgmma.cu kRows: the rows of x a block takes
WGMMA_COLS = 128      # q4_wgmma.cu kCols: the columns of y a block takes
WGMMA_MIN_SPLIT_ROWS = 256  # din rows of a q4_wgmma split, at least: four stages
# the split planner's model of q4_wgmma on the card: the flop/s its blocks
# reach together (on an H100 at M = 256, ~27% of the dense bf16 peak,
# PERF.md), the device memory bytes/s of an H100 SXM (NVIDIA's data sheet),
# and a launch's seconds
WGMMA_MODEL = (270e12, 3.35e12, 2e-6)
WGMMA_WAVE_FILL = 0.9  # the share of the SMs a plan's first wave must fill
# the most f32 partial sums [splits, M, dout] a q4_wgmma plan asks for;
# q4_mma's plans stay under it too (the 7B's widest at 16 rows: 8.2 MB)
MMA_WORKSPACE_BYTES = 32 * 2 ** 20


def max_split_rows(batch: int) -> int:
    """din rows per block: MAX_SPLIT_ROWS, or fewer where the staged x of
    `batch` rows would pass the 48 KB a launch gets without opting in."""
    return min(MAX_SPLIT_ROWS, STAGE_FLOATS // batch)


def q4_gemv_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize to x.dtype, then matmul: the order of the JAX package's
    CPU path (`dot(x, QTensor4.astype(x.dtype))`)."""
    return torch.matmul(x, dequantize4(q, scale, x.dtype))


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _split(din: int, group_size: int, want: int, max_rows: int) -> tuple[int, int]:
    """(groups_per_split, splits): din cut into about `want` splits of whole
    groups, at least as many as keep a split within max_rows rows."""
    groups = din // group_size
    want = max(want, 1, -(-din // max_rows))
    gps = max(1, -(-groups // min(want, groups)))
    gps = min(gps, max(1, max_rows // group_size))
    return gps, -(-groups // gps)


def plan_splits(din: int, dout: int, group_size: int, num_sms: int,
                batch: int = 1) -> tuple[int, int]:
    """(groups_per_split, splits) of the q4_gemv kernel: split din so the
    grid has about four blocks per SM, with at most max_split_rows(batch)
    rows per block."""
    col_blocks = -(-dout // BLOCK_COLS)
    return _split(din, group_size, -(-4 * num_sms // col_blocks), max_split_rows(batch))


def mma_plan_splits(din: int, dout: int, group_size: int, num_sms: int) -> tuple[int, int]:
    """(groups_per_split, splits) of q4_mma (x of at most TILE_ROWS rows,
    one row tile): as many blocks of MMA_BLOCK_COLS columns as fit four to
    an SM (one wave: q4_mma's registers let four blocks share an SM, and a
    fifth block per SM would wait for a second wave), at most
    MAX_SPLIT_ROWS rows per block (bf16 [16, rows + 8] of staged x stays
    within 48 KB)."""
    col_blocks = -(-dout // MMA_BLOCK_COLS)
    return _split(din, group_size, 4 * num_sms // col_blocks, MAX_SPLIT_ROWS)


def wgmma_plan_splits(din: int, dout: int, group_size: int, num_sms: int,
                      rows: int) -> tuple[int, int]:
    """(groups_per_split, splits) of q4_wgmma for x of `rows` rows.  A block
    takes WGMMA_ROWS x WGMMA_COLS of y and has an SM to itself, so the
    blocks run in waves of num_sms.  Where the tiles are under one wave, din
    is split into whole groups until the grid fills one (at least
    WGMMA_WAVE_FILL of the SMs, as far as the limits below allow); of the
    plans that do, the plan takes the fewest splits of the least modelled
    time (WGMMA_MODEL): a block's time is the larger of its flops (the rows
    of its live warpgroups) at an SM's share of the kernel's rate and its
    packed weights and scales at its share of the device memory rate, times
    the waves; a split adds the reduce's pass over the f32 partial sums
    (written and read) and a launch.  Each split has at least WGMMA_MIN_SPLIT_ROWS din rows, and the
    partials [splits, rows, dout] stay within MMA_WORKSPACE_BYTES."""
    flops_per_s, bytes_per_s, launch_s = WGMMA_MODEL
    tiles = -(-rows // WGMMA_ROWS) * -(-dout // WGMMA_COLS)
    live = min(WGMMA_ROWS, -(-rows // 64) * 64)
    groups = din // group_size
    most = min(groups, max(1, din // WGMMA_MIN_SPLIT_ROWS),
               max(1, MMA_WORKSPACE_BYTES // (4 * rows * dout)))
    plans = []
    for want in range(1, most + 1):
        gps = -(-groups // want)
        splits = -(-groups // gps)
        k, blocks = gps * group_size, tiles * splits
        block_s = max(2 * live * WGMMA_COLS * k / (flops_per_s / num_sms),
                      k * WGMMA_COLS * (0.5 + 4 / group_size)
                      / (bytes_per_s / min(blocks, num_sms)))
        t = -(-blocks // num_sms) * block_s
        if splits > 1:
            t += (8 * splits + 2) * rows * dout / bytes_per_s + launch_s
        plans.append((blocks < WGMMA_WAVE_FILL * num_sms, t, splits, gps))
    _, _, splits, gps = min(plans)
    return gps, splits


def use_mma(batch: int, dtype: torch.dtype, group_size: int, dout: int) -> bool:
    """Whether a CUDA call of q4_gemv goes to a tensor-core kernel (q4_mma
    or q4_wgmma): bf16 x of at least MMA_MIN_BATCH rows (no upper limit), a
    group size that is a multiple of 16 (at most MAX_SPLIT_ROWS) and dout a
    multiple of MMA_WARP_COLS."""
    return (dtype == torch.bfloat16 and batch >= MMA_MIN_BATCH
            and group_size % 16 == 0 and group_size <= MAX_SPLIT_ROWS
            and dout % MMA_WARP_COLS == 0)


def route(batch: int, dtype: torch.dtype, group_size: int, dout: int) -> str:
    """The kernel a CUDA call of q4_gemv launches: "q4_wgmma" for what
    use_mma admits above TILE_ROWS rows, "q4_mma" for what it admits up to
    TILE_ROWS, else "q4_gemv"."""
    if not use_mma(batch, dtype, group_size, dout):
        return "q4_gemv"
    return "q4_wgmma" if batch > TILE_ROWS else "q4_mma"


def _check(x, q, scale):
    if not (x.device == q.device == scale.device):
        raise ValueError(f"q4_gemv: tensors on {x.device}, {q.device}, {scale.device}")
    if x.ndim != 2 or q.ndim != 2 or scale.ndim != 3 or scale.shape[1] != 1:
        raise ValueError(f"q4_gemv: shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    B, din = x.shape
    p2, dout = q.shape
    G = scale.shape[0]
    if 2 * p2 != din or scale.shape[2] != dout or din % G:
        raise ValueError(f"q4_gemv: x {tuple(x.shape)} does not match q "
                         f"{tuple(q.shape)} / scale {tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"q4_gemv: q {q.dtype}, scale {scale.dtype}")


def _check_cuda(name, x, q, scale, q_align):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if q.data_ptr() % q_align or scale.data_ptr() % 16:
        raise ValueError(f"{name}: q must be {q_align}-byte and scale 16-byte aligned")


def q4_gemv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [B, din] bf16/f32; q [din/2, dout] int8; scale [din/gs, 1, dout]
    f32 -> [B, dout] in x.dtype.  The `q4_gemv` kernel's launches are
    counted in `q4_gemv.launches`, q4_mma's in `q4_mma.launches`,
    q4_wgmma's in `q4_wgmma.launches`."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    kernel = route(x.shape[0], x.dtype, x.shape[1] // scale.shape[0], q.shape[1])
    return {"q4_wgmma": q4_wgmma, "q4_mma": q4_mma, "q4_gemv": q4_gemv_kernel}[kernel](
        x, q, scale)


def q4_gemv_kernel(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q4_gemv's function through the `q4_gemv` kernel (CUDA cores), whatever
    `use_mma` says: one launch per chunk of at most MAX_BATCH rows of x,
    ceil(M / MAX_BATCH) a call; on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    _check_cuda("q4_gemv", x, q, scale, 4)
    M, din = x.shape
    dout = q.shape[1]
    gs = din // scale.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q4_gemv: x dtype {x.dtype}")
    if M < 1:
        raise ValueError(f"q4_gemv: {M} rows")
    B = min(M, MAX_BATCH)
    if gs % 2 or dout % 4 or gs > max_split_rows(B):
        raise ValueError(f"q4_gemv: group size {gs} must be even and at most "
                         f"{max_split_rows(B)}, dout {dout} a multiple of 4")
    gps, splits = plan_splits(din, dout, gs, _num_sms(x.device.index or 0), B)
    out = torch.empty((M, dout), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, B, dout), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = build.load("q4_gemv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r0 in range(0, M, MAX_BATCH):
        rows = min(MAX_BATCH, M - r0)
        xc, oc = x[r0:r0 + rows], out[r0:r0 + rows]
        err = lib.q4_gemv(xc.data_ptr(), q.data_ptr(), scale.data_ptr(), oc.data_ptr(),
                          (oc if partial is None else partial).data_ptr(), rows, din, dout,
                          gs, gps, splits, int(x.dtype == torch.bfloat16), stream)
        build.check(lib, err, "q4_gemv")
        q4_gemv.launches += 1
    return out


def q4_mma(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q4_gemv's function through the `q4_mma` kernel (tensor cores), one
    launch per call: x bf16 of 1..TILE_ROWS rows, gs a multiple of 16, dout
    a multiple of MMA_WARP_COLS; on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    _check_cuda("q4_mma", x, q, scale, 8)
    B, din = x.shape
    dout = q.shape[1]
    gs = din // scale.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"q4_mma: x dtype {x.dtype}, not bfloat16")
    if not 1 <= B <= TILE_ROWS:
        raise ValueError(f"q4_mma: {B} rows, not 1..{TILE_ROWS} (q4_wgmma takes more)")
    if gs % 16 or gs > MAX_SPLIT_ROWS or dout % MMA_WARP_COLS:
        raise ValueError(f"q4_mma: group size {gs} must be a multiple of 16 and at most "
                         f"{MAX_SPLIT_ROWS}, dout {dout} a multiple of {MMA_WARP_COLS}")
    gps, splits = mma_plan_splits(din, dout, gs, _num_sms(x.device.index or 0))
    out = torch.empty((B, dout), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, B, dout), dtype=torch.float32, device=x.device)
               if splits > 1 else out)
    lib = build.load("q4_mma")
    err = lib.q4_mma(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                     partial.data_ptr(), B, din, dout, gs, gps, splits,
                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "q4_mma")
    q4_mma.launches += 1
    return out


def q4_wgmma(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q4_gemv's function through the `q4_wgmma` kernel (wgmma over 128-row
    tiles), one launch per call: x bf16 of any row count, gs a multiple of
    16, dout a multiple of MMA_WARP_COLS, q and scale 16-byte aligned (x is
    copied where its rows are not); on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    _check_cuda("q4_wgmma", x, q, scale, 16)
    M, din = x.shape
    dout = q.shape[1]
    gs = din // scale.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"q4_wgmma: x dtype {x.dtype}, not bfloat16")
    if M < 1:
        raise ValueError(f"q4_wgmma: {M} rows")
    if gs % 16 or gs > MAX_SPLIT_ROWS or dout % MMA_WARP_COLS:
        raise ValueError(f"q4_wgmma: group size {gs} must be a multiple of 16 and at most "
                         f"{MAX_SPLIT_ROWS}, dout {dout} a multiple of {MMA_WARP_COLS}")
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel copies x 16 bytes at a time; a new tensor is aligned
    gps, splits = wgmma_plan_splits(din, dout, gs, _num_sms(x.device.index or 0), M)
    out = torch.empty((M, dout), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, M, dout), dtype=torch.float32, device=x.device)
               if splits > 1 else out)
    lib = build.load("q4_wgmma")
    err = lib.q4_wgmma(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                       partial.data_ptr(), M, din, dout, gs, gps, splits,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "q4_wgmma")
    q4_wgmma.launches += 1
    return out


q4_gemv.launches = 0
q4_mma.launches = 0
q4_wgmma.launches = 0


def q4_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., din] @ a QTensor4 [din, dout] through q4_gemv."""
    lead = x.shape[:-1]
    y = q4_gemv(x.reshape(math.prod(lead), x.shape[-1]).contiguous(), q, scale)
    return y.reshape(*lead, q.shape[-1])
