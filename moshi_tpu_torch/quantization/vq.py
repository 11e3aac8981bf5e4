"""Residual vector quantization, inference path (counterpart of
moshi_tpu/quantization/vq.py).

The nearest-codeword search is the JAX package's formula in f32,
argmin(0.5 * ||e||^2 - x . e), so that ties and near-ties resolve the same
way; torch.argmin, like jnp.argmin, returns the first minimum.
"""

from dataclasses import dataclass

import torch

from ..utils.params import normal


@dataclass(frozen=True)
class RVQConfig:
    dimension: int = 256
    input_dimension: int = 512
    output_dimension: int = 512
    n_q: int = 8
    bins: int = 2048


def nearest_codebook(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """x [..., D]; embedding [bins, D] -> int64 codes [...]."""
    xf = x.float()
    ef = embedding.float()
    scores = 0.5 * (ef * ef).sum(dim=-1) - torch.matmul(xf, ef.T)
    return scores.argmin(dim=-1)


class ResidualVectorQuantizer:
    """Params: {"input_proj": [Cin, D], "output_proj": [D, Cout],
    "embedding": [n_q, bins, D]} (Mimi always has both projections)."""

    def __init__(self, config: RVQConfig):
        self.config = config
        self.n_q = config.n_q

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        c = self.config
        return {
            "embedding": normal(generator, (c.n_q, c.bins, c.dimension), dtype, device),
            "input_proj": normal(generator, (c.input_dimension, c.dimension),
                                 dtype, device) / c.input_dimension ** 0.5,
            "output_proj": normal(generator, (c.dimension, c.output_dimension),
                                  dtype, device) / c.dimension ** 0.5,
        }

    def encode(self, params: dict, x: torch.Tensor, n_q: int | None = None) -> torch.Tensor:
        """x [B, T, Cin] -> codes [B, K, T]."""
        n_q = self.n_q if n_q is None else n_q
        x = torch.matmul(x, params["input_proj"].to(x.dtype))
        codes = []
        for e in params["embedding"][:n_q]:
            c = nearest_codebook(x, e)
            x = x - e[c].to(x.dtype)
            codes.append(c)
        return torch.stack(codes, dim=1)

    def decode(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] -> [B, T, Cout].  Out-of-range codes are clamped,
        as in the JAX package (a hostile client must not poison the state)."""
        emb = params["embedding"]
        quant = torch.stack([emb[k][codes[:, k].clamp(0, emb.shape[1] - 1)]
                             for k in range(codes.shape[1])]).sum(dim=0)
        return torch.matmul(quant, params["output_proj"].to(quant.dtype))


class SplitResidualVectorQuantizer:
    """1 semantic RVQ + (n_q - 1) acoustic RVQ over the same input."""

    def __init__(self, config: RVQConfig, n_q_semantic: int = 1):
        self.config = config
        self.n_q_semantic = n_q_semantic
        self.rvq_first = ResidualVectorQuantizer(
            RVQConfig(config.dimension, config.input_dimension,
                      config.output_dimension, n_q_semantic, config.bins))
        self.rvq_rest = ResidualVectorQuantizer(
            RVQConfig(config.dimension, config.input_dimension,
                      config.output_dimension, config.n_q - n_q_semantic,
                      config.bins))
        self.n_q = config.n_q

    def set_num_codebooks(self, n: int):
        if not self.n_q_semantic <= n <= self.config.n_q:
            raise ValueError(n)
        self.n_q = n
        self.rvq_rest.n_q = n - self.n_q_semantic

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        return {"rvq_first": self.rvq_first.init_params(generator, dtype, device),
                "rvq_rest": self.rvq_rest.init_params(generator, dtype, device)}

    def encode(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        codes = self.rvq_first.encode(params["rvq_first"], x)
        if self.n_q > self.n_q_semantic:
            rest = self.rvq_rest.encode(params["rvq_rest"], x,
                                        n_q=self.n_q - self.n_q_semantic)
            codes = torch.cat([codes, rest], dim=1)
        return codes

    def decode(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        quant = self.rvq_first.decode(params["rvq_first"], codes[:, :self.n_q_semantic])
        if codes.shape[1] > self.n_q_semantic:
            quant = quant + self.rvq_rest.decode(params["rvq_rest"],
                                                 codes[:, self.n_q_semantic:])
        return quant

    @property
    def cardinality(self) -> int:
        return self.config.bins
