"""int8 weight-only GEMV: the wrappers of the CUDA kernels
`csrc/int8_gemv.cu` and `csrc/int8_mma.cu` and their plain PyTorch version.

Counterpart of moshi_tpu/ops/qmatmul.py (`qgemv`) and of what `wdot` does
for a `QTensor` (moshi_tpu/utils/matmul.py:83).  `int8_gemv` is the entry
point: on a CPU tensor it runs `int8_gemv_plain`; on a CUDA tensor it
launches `int8_mma` (tensor cores) where `use_mma` says so and the
`int8_gemv` kernel (CUDA cores) otherwise, or raises.  The `int8_gemv`
kernel takes any dout and a view at any byte offset, one launch a call
planned by `int8_gemv_plan` (q4matmul.gemv_plan, shared with the q4_gemv
kernel).
"""

import math

import torch

from ..utils.quantize import dequantize
from . import build
from .q4matmul import (MAX_BATCH, MMA_WARP_COLS, GemvPlan, _check_cuda, _num_sms,
                       gemv_max_cols, gemv_plan, gemv_resident)

# int8_mma takes bf16 calls of MMA_MIN_BATCH..MAX_BATCH rows
MMA_MIN_BATCH = 1
MMA_BLOCK_COLS = MMA_WARP_COLS  # int8_mma.cu kBlockCols: one warp's 64 columns
MMA_MAX_CLUSTER = 8             # int8_mma.cu kMaxCluster: the portable cluster size
MMA_BLOCKS_PER_SM = 2           # int8_mma_plan fills about this many blocks per SM


def int8_gemv_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize to x.dtype, then matmul: the order of the JAX package's
    CPU path (`dot(x, QTensor.astype(x.dtype))`)."""
    return torch.matmul(x, dequantize(q, scale, x.dtype))


def int8_gemv_plan(batch: int, din: int, q: torch.Tensor, bf16: bool,
                   device: torch.device) -> GemvPlan:
    """The plan of an int8_gemv kernel launch of `batch` rows on q: a lane's
    16 or 8 bytes where dout and q are aligned to them (and gemv_max_cols
    allows), else 4 (the kernel realigns rows at any byte offset); the
    blocks the card holds at once from the kernel itself."""
    dout = q.shape[-1]
    cols = tuple(c for c in (16, 8) if c <= gemv_max_cols(batch) and dout % c == 0
                 and q.data_ptr() % c == 0) + (4,)
    return gemv_plan("int8", din, dout, batch, _num_sms(device.index or 0), 1, cols,
                     gemv_resident("int8", batch, bf16, device))


def int8_mma_plan(din: int, dout: int, num_sms: int) -> tuple[int, int]:
    """(cluster, rows_per_block) of int8_mma: each MMA_BLOCK_COLS-column
    tile is a cluster of blocks that split din, as many as bring the grid to
    about MMA_BLOCKS_PER_SM blocks per SM, at most MMA_MAX_CLUSTER and at
    most one per k16 step; rows_per_block is a multiple of 16 and the last
    rank is the only short one."""
    col_blocks = -(-dout // MMA_BLOCK_COLS)
    steps = din // 16
    cluster = max(1, min(-(-MMA_BLOCKS_PER_SM * num_sms // col_blocks), MMA_MAX_CLUSTER, steps))
    rows = -(-steps // cluster) * 16
    return -(-din // rows), rows


def use_mma(batch: int, dtype: torch.dtype, din: int, dout: int) -> bool:
    """Whether a CUDA call of int8_gemv goes to int8_mma: bf16 x of
    MMA_MIN_BATCH..MAX_BATCH rows, din a multiple of 16, dout a multiple of
    MMA_WARP_COLS."""
    return (dtype == torch.bfloat16 and MMA_MIN_BATCH <= batch <= MAX_BATCH
            and din % 16 == 0 and dout % MMA_WARP_COLS == 0)


def _check(x, q, scale):
    if not (x.device == q.device == scale.device):
        raise ValueError(f"int8_gemv: tensors on {x.device}, {q.device}, {scale.device}")
    if (x.ndim != 2 or q.ndim != 2 or tuple(scale.shape) != (1, q.shape[1])
            or x.shape[1] != q.shape[0]):
        raise ValueError(f"int8_gemv: shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_gemv: q {q.dtype}, scale {scale.dtype}")


def int8_gemv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [B, din] bf16/f32; q [din, dout] int8; scale [1, dout] f32 ->
    [B, dout] in x.dtype.  The `int8_gemv` kernel's launches are counted in
    `int8_gemv.launches`, int8_mma's in `int8_mma.launches`."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return int8_gemv_plain(x, q, scale)
    if use_mma(x.shape[0], x.dtype, x.shape[1], q.shape[1]):
        return int8_mma(x, q, scale)
    return int8_gemv_kernel(x, q, scale)


def int8_gemv_kernel(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8_gemv's function through the `int8_gemv` kernel (CUDA cores),
    whatever `use_mma` says; on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return int8_gemv_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemv: unsupported device {x.device}")
    B, din = x.shape
    dout = q.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_gemv: x dtype {x.dtype}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"int8_gemv: batch {B} outside 1..{MAX_BATCH}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_gemv: operands must be contiguous")
    plan = int8_gemv_plan(B, din, q, x.dtype == torch.bfloat16, x.device)
    out = torch.empty((B, dout), dtype=x.dtype, device=x.device)
    lib = build.load("int8_gemv")
    err = lib.int8_gemv(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), B, din,
                        dout, *plan, int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "int8_gemv")
    int8_gemv.launches += 1
    return out


def int8_mma(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8_gemv's function through the `int8_mma` kernel (tensor cores): x
    bf16 of 1..MAX_BATCH rows, 8-byte aligned, din a multiple of 16, dout a
    multiple of MMA_WARP_COLS; on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return int8_gemv_plain(x, q, scale)
    _check_cuda("int8_mma", x, q, scale, 8)
    B, din = x.shape
    dout = q.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8_mma: x dtype {x.dtype}, not bfloat16")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"int8_mma: batch {B} outside 1..{MAX_BATCH}")
    if din % 16 or dout % MMA_WARP_COLS:
        raise ValueError(f"int8_mma: din {din} must be a multiple of 16, dout {dout} a "
                         f"multiple of {MMA_WARP_COLS}")
    if x.data_ptr() % 8:
        raise ValueError("int8_mma: x must be 8-byte aligned")
    cluster, rows = int8_mma_plan(din, dout, _num_sms(x.device.index or 0))
    out = torch.empty((B, dout), dtype=torch.bfloat16, device=x.device)
    lib = build.load("int8_mma")
    err = lib.int8_mma(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), B, din,
                       dout, rows, cluster, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "int8_mma")
    int8_mma.launches += 1
    return out


int8_gemv.launches = 0
int8_mma.launches = 0


def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., din] @ a QTensor [din, dout] through int8_gemv."""
    lead = x.shape[:-1]
    y = int8_gemv(x.reshape(math.prod(lead), x.shape[-1]).contiguous(), q, scale)
    return y.reshape(*lead, q.shape[-1])
