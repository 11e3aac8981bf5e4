"""Group-wise 4-bit weight-only GEMV: the wrapper of the CUDA kernel
`csrc/q4_gemv.cu` and its plain PyTorch version.

Counterpart of moshi_tpu/ops/q4matmul.py (`q4gemm`, `q4gemm_stacked`).  A
member of a stacked weight is a view here, so one entry point covers both.
On a CPU tensor `q4_gemv` runs `q4_gemv_plain`; on a CUDA tensor it launches
the kernel or raises.
"""

import functools
import math

import torch

from ..utils.quantize import dequantize4
from . import build

MAX_BATCH = 16        # gemv::kMaxBatch
BLOCK_COLS = 4 * 128  # gemv::kCols * gemv::kThreads
MAX_SPLIT_ROWS = 1024  # din rows a block stages in shared memory
STAGE_FLOATS = 48 * 1024 // 4  # gemv::kStageFloats: f32 [batch, rows] staged x


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


def plan_splits(din: int, dout: int, group_size: int, num_sms: int,
                batch: int = 1) -> tuple[int, int]:
    """(groups_per_split, splits): split din so the grid has about four
    blocks per SM, with at most max_split_rows(batch) rows per block."""
    groups = din // group_size
    col_blocks = -(-dout // BLOCK_COLS)
    max_rows = max_split_rows(batch)
    want = max(-(-4 * num_sms // col_blocks), -(-din // max_rows))
    gps = max(1, -(-groups // min(want, groups)))
    gps = min(gps, max(1, max_rows // group_size))
    return gps, -(-groups // gps)


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


def q4_gemv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [B, din] bf16/f32; q [din/2, dout] int8; scale [din/gs, 1, dout]
    f32 -> [B, dout] in x.dtype."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"q4_gemv: unsupported device {x.device}")
    B, din = x.shape
    dout = q.shape[1]
    gs = din // scale.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q4_gemv: x dtype {x.dtype}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"q4_gemv: batch {B} outside 1..{MAX_BATCH}")
    if gs % 2 or dout % 4 or gs > max_split_rows(B):
        raise ValueError(f"q4_gemv: group size {gs} must be even and at most "
                         f"{max_split_rows(B)}, dout {dout} a multiple of 4")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q4_gemv: operands must be contiguous")
    if q.data_ptr() % 4 or scale.data_ptr() % 16:
        raise ValueError("q4_gemv: q must be 4-byte and scale 16-byte aligned")
    gps, splits = plan_splits(din, dout, gs, _num_sms(x.device.index or 0), B)
    out = torch.empty((B, dout), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, B, dout), dtype=torch.float32, device=x.device)
               if splits > 1 else out)
    lib = build.load("q4_gemv")
    err = lib.q4_gemv(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                      partial.data_ptr(), B, din, dout, gs, gps, splits,
                      int(x.dtype == torch.bfloat16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "q4_gemv")
    q4_gemv.launches += 1
    return out


q4_gemv.launches = 0


def q4_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., din] @ a QTensor4 [din, dout] through q4_gemv."""
    lead = x.shape[:-1]
    y = q4_gemv(x.reshape(math.prod(lead), x.shape[-1]).contiguous(), q, scale)
    return y.reshape(*lead, q.shape[-1])
