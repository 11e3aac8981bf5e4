"""Group-wise 4-bit weight-only matrix product: the wrappers of the CUDA
kernels `csrc/q4_gemv.cu` and `csrc/q4_mma.cu` and their plain PyTorch
version.

Counterpart of moshi_tpu/ops/q4matmul.py (`q4gemm`, `q4gemm_stacked`),
which take x of any row count M.  A member of a stacked weight is a view
here, so one entry point covers both.  `q4_gemv` is the entry point: on a
CPU tensor it runs `q4_gemv_plain`; on a CUDA tensor, by M and dtype:
- bf16 x of M >= MMA_MIN_BATCH rows (any M above: the decoding batch, 2..16,
  and the offline forward's B * T) -> `q4_mma` on the tensor cores, one
  launch per call (its din-split reduce, where the plan splits, is a second
  kernel of the same call).  A block takes one 16-row tile of x, so each
  tile reads the packed weights again; from M > 16 the din split is planned
  by M, within MMA_WORKSPACE_BYTES of f32 partial sums, and a large M runs
  unsplit;
- f32 x, bf16 x of one row, and shapes q4_mma does not take -> the
  `q4_gemv` kernel on the CUDA cores, one launch per TILE_ROWS rows: the
  wrapper loops over chunks of at most 16 rows, ceil(M / 16) launches a
  call (f32 is the parity dtype; no main path runs it on the card).
Either way a CUDA tensor launches a kernel or raises.
"""

import functools
import math

import torch

from ..utils.quantize import dequantize4
from . import build

MAX_BATCH = 16        # gemv::kMaxBatch: rows of one q4_gemv (and int8) launch
TILE_ROWS = MAX_BATCH  # q4_mma.cu kTileRows: the rows of x one block takes
BLOCK_COLS = 4 * 128  # gemv::kCols * gemv::kThreads
MAX_SPLIT_ROWS = 1024  # din rows a block stages in shared memory
STAGE_FLOATS = 48 * 1024 // 4  # gemv::kStageFloats: f32 [batch, rows] staged x
# q4_mma takes bf16 calls of MMA_MIN_BATCH rows and more: from B = 2 it is
# over twice as fast as the q4_gemv kernel on the H100; B = 1 stays on the
# q4_gemv kernel, within 3% of q4_mma there (PERF.md, the crossover table).
MMA_MIN_BATCH = 2
MMA_WARP_COLS = 64    # q4_mma.cu kWarpCols: eight n8 tiles
MMA_BLOCK_COLS = 4 * MMA_WARP_COLS  # q4_mma.cu kBlockCols: 4 warps
# the most f32 partial sums [splits, M, dout] a q4_mma plan of M > 16 rows
# asks for; M <= 16 plans stay under it too (the 7B's widest: 8.2 MB)
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


def mma_plan_splits(din: int, dout: int, group_size: int, num_sms: int,
                    batch: int = TILE_ROWS) -> tuple[int, int]:
    """(groups_per_split, splits) of q4_mma for x of `batch` rows.  Up to
    TILE_ROWS rows (one row tile): as many blocks of MMA_BLOCK_COLS columns
    as fit four to an SM (one wave: q4_mma's registers let four blocks
    share an SM, and a fifth block per SM would wait for a second wave), at
    most MAX_SPLIT_ROWS rows per block (bf16 [16, rows + 8] of staged x
    stays within 48 KB).  Above: the column blocks times the row tiles are
    the grid, split only as far as it takes to reach four blocks per SM and
    the f32 partial sums stay within MMA_WORKSPACE_BYTES (a block then
    stages its split's x MAX_SPLIT_ROWS rows at a time)."""
    col_blocks = -(-dout // MMA_BLOCK_COLS)
    if batch <= TILE_ROWS:
        return _split(din, group_size, 4 * num_sms // col_blocks, MAX_SPLIT_ROWS)
    groups = din // group_size
    tiles = -(-batch // TILE_ROWS)
    want = min(-(-4 * num_sms // (col_blocks * tiles)),
               MMA_WORKSPACE_BYTES // (4 * batch * dout), groups)
    if want <= 1:
        return groups, 1
    gps = -(-groups // want)
    return gps, -(-groups // gps)


def use_mma(batch: int, dtype: torch.dtype, group_size: int, dout: int) -> bool:
    """Whether a CUDA call of q4_gemv goes to q4_mma: bf16 x of at least
    MMA_MIN_BATCH rows (no upper limit), a group size that is a multiple
    of 16 (at most MAX_SPLIT_ROWS) and dout a multiple of MMA_WARP_COLS."""
    return (dtype == torch.bfloat16 and batch >= MMA_MIN_BATCH
            and group_size % 16 == 0 and group_size <= MAX_SPLIT_ROWS
            and dout % MMA_WARP_COLS == 0)


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
    counted in `q4_gemv.launches`, q4_mma's in `q4_mma.launches`."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    if use_mma(x.shape[0], x.dtype, x.shape[1] // scale.shape[0], q.shape[1]):
        return q4_mma(x, q, scale)
    return q4_gemv_kernel(x, q, scale)


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
    launch per call: x bf16 of any row count, gs a multiple of 16, dout a
    multiple of MMA_WARP_COLS; on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    _check_cuda("q4_mma", x, q, scale, 8)
    B, din = x.shape
    dout = q.shape[1]
    gs = din // scale.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"q4_mma: x dtype {x.dtype}, not bfloat16")
    if B < 1:
        raise ValueError(f"q4_mma: {B} rows")
    if gs % 16 or gs > MAX_SPLIT_ROWS or dout % MMA_WARP_COLS:
        raise ValueError(f"q4_mma: group size {gs} must be a multiple of 16 and at most "
                         f"{MAX_SPLIT_ROWS}, dout {dout} a multiple of {MMA_WARP_COLS}")
    gps, splits = mma_plan_splits(din, dout, gs, _num_sms(x.device.index or 0), B)
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


q4_gemv.launches = 0
q4_mma.launches = 0


def q4_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., din] @ a QTensor4 [din, dout] through q4_gemv."""
    lead = x.shape[:-1]
    y = q4_gemv(x.reshape(math.prod(lead), x.shape[-1]).contiguous(), q, scale)
    return y.reshape(*lead, q.shape[-1])
