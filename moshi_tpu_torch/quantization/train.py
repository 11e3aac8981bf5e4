"""RVQ training: EMA codebooks, k-means init, expired-code replacement
(counterpart of moshi_tpu/quantization/train.py).

As there, after the reference's `quantization/core_vq.py`:
- EMA: `cluster_usage` and `embedding_sum` are decayed running sums and the
  codebook is their ratio (`embedding_from_state`);
- k-means init of layer 0 on the first training batch;
- expired-code replacement: codes whose usage falls below
  `threshold_usage_ratio` times the mean are resampled from the batch;
- the straight-through estimator and the commit loss.
A function of (params, state, x, generator) -> (outputs, new state), the
state a dict of tensors.  Random draws come from an explicit
`torch.Generator` on x's device: the same sequence of draws as the JAX
package's keys has no counterpart, so only the deterministic part (an
initialized state, no expired code) equals the JAX package's outputs.  The
codebook statistics carry no gradient; the gradient reaches the encoder
through the commit loss and the straight-through estimator.

Over several workers there are two semantics.  `group` is the JAX
package's `axis_name`: each worker quantizes its own rows and the batch
statistics are averaged over the group (an all_reduce divided by its size,
lax.pmean's counterpart).  `rows` is the mesh trainer's: x holds the global
batch (every worker's rows, only its own carrying gradient), the
statistics, k-means and the replacement draws are taken over all of it,
as one device would, and the outputs are of the worker's rows alone.
"""

import math
from dataclasses import dataclass

import torch

from ..parallel import collectives
from .vq import RVQConfig, nearest_codebook


@dataclass(frozen=True)
class RVQTrainConfig:
    decay: float = 0.99
    epsilon: float = 1e-5
    threshold_usage_ratio: float = 0.1
    replaced_usage_ratio: float = 1.0
    kmeans_iters: int = 50


def init_train_state(config: RVQConfig, device=None) -> dict:
    return {
        "initialized": torch.zeros((), dtype=torch.float32, device=device),
        "cluster_usage": torch.ones((config.n_q, config.bins), dtype=torch.float32,
                                    device=device),
        "embedding_sum": torch.zeros((config.n_q, config.bins, config.dimension),
                                     dtype=torch.float32, device=device),
    }


def embedding_from_state(state: dict, epsilon: float = 1e-5) -> torch.Tensor:
    return state["embedding_sum"] / state["cluster_usage"].clamp(min=epsilon)[..., None]


def _counts(codes: torch.Tensor, bins: int) -> torch.Tensor:
    return torch.bincount(codes, minlength=bins).to(torch.float32)


def _sums(codes: torch.Tensor, rows: torch.Tensor, bins: int) -> torch.Tensor:
    return torch.zeros((bins, rows.shape[-1]), dtype=torch.float32,
                       device=rows.device).index_add_(0, codes, rows)


def kmeans(generator: torch.Generator, samples: torch.Tensor, num_clusters: int,
           num_iters: int = 50) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means of samples [N, D] -> (means [C, D], bins [C]); an
    empty cluster takes a resampled vector each iteration."""
    N = samples.shape[0]

    def sample_vectors(num):
        if N >= num:
            idx = torch.randperm(N, generator=generator, device=samples.device)[:num]
        else:
            idx = torch.randint(0, N, (num,), generator=generator, device=samples.device)
        return samples[idx]

    means = sample_vectors(num_clusters)
    bins = torch.ones(num_clusters, dtype=torch.float32, device=samples.device)
    for _ in range(num_iters):
        buckets = nearest_codebook(samples, means)
        bins = _counts(buckets, num_clusters)
        new_means = _sums(buckets, samples, num_clusters) / bins.clamp(min=1.0)[:, None]
        means = torch.where((bins == 0)[:, None], sample_vectors(num_clusters), new_means)
    return means, bins


def rvq_train_forward(config: RVQConfig, tcfg: RVQTrainConfig, params: dict, state: dict,
                      x: torch.Tensor, generator: torch.Generator, group=None,
                      rows: tuple[int, int] | None = None) -> tuple[dict, dict]:
    """One training forward of a (non-split) RVQ over x [B, T, Cin].
    Returns (outputs, new_state); outputs hold `quantized` (the
    straight-through value, [B, T, Cout]), `codes` [B, K, T],
    `commit_loss`, `entropy` and `expired_frac`.  `group`: a process group
    whose workers' batch statistics are averaged; `rows` (start, stop): the
    outputs are of x's rows [start, stop) only, the statistics of all."""
    n_q, bins, dim = config.n_q, config.bins, config.dimension
    decay, eps = tcfg.decay, tcfg.epsilon

    x_in = x
    if "input_proj" in params:
        x_in = torch.matmul(x, params["input_proj"].to(x.dtype))
    flat = x_in.detach().reshape(-1, dim).float()

    # k-means init of layer 0 on the first batch (the later layers start at
    # zero and take batch vectors as their codes expire)
    if not bool(state["initialized"] > 0):
        means, usage = kmeans(generator, flat, bins, tcfg.kmeans_iters)
        embedding_sum = state["embedding_sum"].clone()
        cluster_usage = state["cluster_usage"].clone()
        embedding_sum[0] = means * usage[:, None]
        cluster_usage[0] = usage
        state = {"initialized": torch.ones_like(state["initialized"]),
                 "cluster_usage": cluster_usage, "embedding_sum": embedding_sum}

    embedding = embedding_from_state(state, eps)
    residual, quantized = flat, torch.zeros_like(flat)
    codes, usage_new, sums_new = [], [], []
    for k in range(n_q):
        c = nearest_codebook(residual, embedding[k])
        quant = embedding[k][c]
        codes.append(c)
        usage_new.append(_counts(c, bins))
        sums_new.append(_sums(c, residual, bins))
        residual, quantized = residual - quant, quantized + quant

    usage_new, sums_new = torch.stack(usage_new), torch.stack(sums_new)
    if group is not None:
        n = collectives.size(group)
        usage_new = collectives.all_reduce(usage_new, group) / n
        sums_new = collectives.all_reduce(sums_new, group) / n
    cluster_usage = state["cluster_usage"] * decay + usage_new * (1 - decay)
    embedding_sum = state["embedding_sum"] * decay + sums_new * (1 - decay)

    # expired-code replacement: a draw every step, whether or not a code expired
    total = cluster_usage.sum(dim=1, keepdim=True)
    expired = cluster_usage < tcfg.threshold_usage_ratio * total / bins
    replace_usage = tcfg.replaced_usage_ratio * total / bins
    ridx = torch.randint(0, flat.shape[0], (n_q, bins), generator=generator,
                         device=flat.device)
    embedding_sum = torch.where(expired[..., None], replace_usage[..., None] * flat[ridx],
                                embedding_sum)
    cluster_usage = torch.where(expired, replace_usage, cluster_usage)

    # straight-through estimator and commit loss
    quantized = quantized.reshape(x_in.shape[:-1] + (dim,)).to(x_in.dtype)
    codes = torch.stack(codes).reshape(n_q, *x_in.shape[:-1]).movedim(0, 1)
    if rows is not None:
        x_in, quantized, codes = (t[rows[0]:rows[1]] for t in (x_in, quantized, codes))
    commit_loss = torch.mean(torch.square(x_in.float() - quantized.float()))
    quantized = x_in + (quantized - x_in).detach()
    if "output_proj" in params:
        quantized = torch.matmul(quantized, params["output_proj"].to(quantized.dtype))

    proba = cluster_usage / cluster_usage.sum(dim=1, keepdim=True)
    plogp = torch.where(proba == 0, torch.zeros_like(proba), proba * torch.log(proba))
    entropy = -plogp.sum(dim=1) / math.log(bins)

    new_state = {"initialized": torch.ones_like(state["initialized"]),
                 "cluster_usage": cluster_usage, "embedding_sum": embedding_sum}
    outputs = {"quantized": quantized,
               "codes": codes,
               "commit_loss": commit_loss, "entropy": entropy.mean(),
               "expired_frac": expired.float().mean()}
    return outputs, new_state
