"""Token sampling (counterpart of moshi_tpu/utils/sampling.py).

Temperature then top-k, drawn with an explicit `torch.Generator`; argmax
when not sampling.  torch's generator and jax.random give different bits,
so only greedy decoding is compared token for token with the JAX package.
"""

import torch


def sample_top_k(generator: torch.Generator, logits: torch.Tensor, k: int,
                 temp: float) -> torch.Tensor:
    """logits [B, V] -> samples [B] from the renormalised top-k."""
    k = min(k, logits.shape[-1])
    vals, idx = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(vals / temp, dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return torch.gather(idx, -1, choice)[..., 0]


def sample_token(generator: torch.Generator | None, logits: torch.Tensor, *,
                 use_sampling: bool = True, temp: float = 1.0,
                 top_k: int = 0) -> torch.Tensor:
    """logits [B, V] -> int64 tokens [B]."""
    logits = logits.float()
    if not use_sampling or temp <= 0.0:
        return torch.argmax(logits, dim=-1)
    if top_k > 0:
        return sample_top_k(generator, logits, top_k, temp)
    probs = torch.softmax(logits / temp, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]
