"""int8 weight-only GEMV: the wrapper of the CUDA kernel `csrc/int8_gemv.cu`
and its plain PyTorch version.

Counterpart of moshi_tpu/ops/qmatmul.py (`qgemv`) and of what `wdot` does
for a `QTensor` (moshi_tpu/utils/matmul.py:83).  On a CPU tensor
`int8_gemv` runs `int8_gemv_plain`; on a CUDA tensor it launches the kernel
or raises.
"""

import math

import torch

from ..utils.quantize import dequantize
from . import build
from .q4matmul import BLOCK_COLS, MAX_BATCH, MAX_SPLIT_ROWS, _num_sms

ROW_GRAIN = 32  # din rows per split are a multiple of this


def int8_gemv_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize to x.dtype, then matmul: the order of the JAX package's
    CPU path (`dot(x, QTensor.astype(x.dtype))`)."""
    return torch.matmul(x, dequantize(q, scale, x.dtype))


def plan_splits(din: int, dout: int, num_sms: int) -> tuple[int, int]:
    """(rows_per_split, splits): split din so the grid has about four blocks
    per SM, with ROW_GRAIN..MAX_SPLIT_ROWS rows per block."""
    col_blocks = -(-dout // BLOCK_COLS)
    want = max(1, -(-4 * num_sms // col_blocks))
    rows = -(-din // want)
    rows = -(-rows // ROW_GRAIN) * ROW_GRAIN
    rows = min(max(rows, ROW_GRAIN), MAX_SPLIT_ROWS)
    return rows, -(-din // rows)


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
    [B, dout] in x.dtype."""
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
    if dout % 4:
        raise ValueError(f"int8_gemv: dout {dout} must be a multiple of 4")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_gemv: operands must be contiguous")
    if q.data_ptr() % 4:
        raise ValueError("int8_gemv: q must be 4-byte aligned")
    rows, splits = plan_splits(din, dout, _num_sms(x.device.index or 0))
    out = torch.empty((B, dout), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, B, dout), dtype=torch.float32, device=x.device)
               if splits > 1 else out)
    lib = build.load("int8_gemv")
    err = lib.int8_gemv(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        partial.data_ptr(), B, din, dout, rows, splits,
                        int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "int8_gemv")
    int8_gemv.launches += 1
    return out


int8_gemv.launches = 0


def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., din] @ a QTensor [din, dout] through int8_gemv."""
    lead = x.shape[:-1]
    y = int8_gemv(x.reshape(math.prod(lead), x.shape[-1]).contiguous(), q, scale)
    return y.reshape(*lead, q.shape[-1])
