"""Matmul helpers (counterpart of moshi_tpu/utils/matmul.py).

f32 products are full f32: moshi_tpu_torch/__init__.py turns TF32 off for
cuBLAS and cuDNN, which is what Precision.HIGHEST does in the JAX package.
`wdot` sends quantized weights to the hand-written GEMV kernels.
"""

import torch

from ..models.lora import LoRAWeight
from ..ops.q4matmul import q4_linear
from ..ops.qmatmul import int8_linear
from .quantize import QTensor, QTensor4


def wdot(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., din] @ w [din, dout], where w may be a QTensor4 (q4_gemv), a
    QTensor (int8_gemv), a plain tensor (torch.matmul in x's dtype) or a
    LoRAWeight: wdot(x, base) with the base detached, plus scaling * (x @
    a) @ b in x's dtype (moshi_tpu/utils/matmul.py:47-52)."""
    if isinstance(w, LoRAWeight):
        base = w.base.detach() if isinstance(w.base, torch.Tensor) else w.base
        y = wdot(x, base)
        delta = torch.matmul(torch.matmul(x, w.a.to(x.dtype)), w.b.to(x.dtype))
        return y + (w.scaling * delta).to(y.dtype)
    if isinstance(w, QTensor4):
        return q4_linear(x, w.q, w.scale)
    if isinstance(w, QTensor):
        return int8_linear(x, w.q, w.scale)
    return torch.matmul(x, w.to(x.dtype))
