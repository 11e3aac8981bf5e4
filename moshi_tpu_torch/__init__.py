"""moshi_tpu_torch: the PyTorch/CUDA port of moshi_tpu, for an NVIDIA H100.

The package mirrors moshi_tpu's layout (modules/, models/, quantization/,
utils/, ops/, serve/) and its parameter layout, and is held against it on
the CPU by the tests in tests/test_torch_*.py.  Every Pallas kernel on the
ported path is a hand-written CUDA kernel under csrc/, built with nvcc at
first use (ops/build.py).  Nothing here imports jax.
"""

import torch

# f32 products stay full f32 on the card: cuDNN runs f32 convolutions in
# TF32 by default, and Mimi's f32 RVQ argmin stops being token-exact once
# products are truncated (moshi_tpu/utils/matmul.py:1-9).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
