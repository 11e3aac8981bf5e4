"""Mimi: streaming neural audio codec, 24 kHz mono <-> 12.5 Hz RVQ tokens
(counterpart of moshi_tpu/models/mimi.py, streaming path).

Public shapes are the JAX package's: audio [B, C, T], codes [B, K, T].
Streaming state is one tree of preallocated tensors that `encode_step` and
`decode_step` update in place.  The encoder and decoder transformers run at
the SEANet width, so the JAX package's ProjectedTransformer projections are
identities here (its `output_projs` entries are empty) and are not ported.
"""

from dataclasses import dataclass, field

import torch

from ..modules.conv import conv_from_jax, convtr_from_jax
from ..modules.resample import ConvDownsample1d, ConvTrUpsample1d
from ..modules.seanet import SEANetConfig, SEANetDecoder, SEANetEncoder
from ..modules.transformer import StreamingTransformer, TransformerConfig
from ..quantization.vq import RVQConfig, SplitResidualVectorQuantizer


@dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24_000
    channels: int = 1
    frame_rate: float = 12.5
    seanet: SEANetConfig = field(default_factory=SEANetConfig)
    transformer: TransformerConfig = field(default_factory=lambda: TransformerConfig(
        d_model=512, num_heads=8, num_layers=8, dim_feedforward=2048,
        context=250, positional_embedding="rope",
        max_period=10_000.0, gating="none", norm="layer_norm", layer_scale=0.01))
    quantizer: RVQConfig = field(default_factory=lambda: RVQConfig(
        dimension=256, input_dimension=512, output_dimension=512, n_q=32, bins=2048))
    num_codebooks: int = 8

    @property
    def encoder_frame_rate(self) -> float:
        return self.sample_rate / self.seanet.hop_length

    @property
    def frame_size(self) -> int:
        return int(self.sample_rate / self.frame_rate)

    @property
    def downsample_stride(self) -> int:
        s = self.encoder_frame_rate / self.frame_rate
        if s != int(s):
            raise ValueError(f"encoder rate / frame rate = {s} is not an integer")
        return int(s)


def mimi_v0_1_config(num_codebooks: int = 8) -> MimiConfig:
    """The released Mimi checkpoint configuration."""
    return MimiConfig(num_codebooks=num_codebooks)


class MimiModel:
    def __init__(self, config: MimiConfig):
        self.config = c = config
        if c.transformer.d_model != c.seanet.dimension:
            raise NotImplementedError("transformer projections are not ported")
        self.encoder = SEANetEncoder(c.seanet)
        self.decoder = SEANetDecoder(c.seanet)
        self.encoder_transformer = StreamingTransformer(c.transformer)
        self.decoder_transformer = StreamingTransformer(c.transformer)
        self.downsample = ConvDownsample1d(c.downsample_stride, c.seanet.dimension)
        self.upsample = ConvTrUpsample1d(c.downsample_stride, c.seanet.dimension,
                                         channel_wise=True)
        self.quantizer = SplitResidualVectorQuantizer(c.quantizer)
        self.quantizer.set_num_codebooks(c.num_codebooks)

    @property
    def frame_size(self) -> int:
        return self.config.frame_size

    @property
    def num_codebooks(self) -> int:
        return self.quantizer.n_q

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        return {
            "encoder": self.encoder.init_params(generator, dtype, device),
            "decoder": self.decoder.init_params(generator, dtype, device),
            "encoder_transformer": self.encoder_transformer.init_params(generator, dtype, device),
            "decoder_transformer": self.decoder_transformer.init_params(generator, dtype, device),
            "downsample": self.downsample.init_params(generator, dtype, device),
            "upsample": self.upsample.init_params(generator, dtype, device),
            "quantizer": self.quantizer.init_params(generator, dtype, device),
        }

    def relayout_jax_convs(self, params: dict) -> None:
        """Convert, in the tree, every conv weight from the JAX package's
        [K, Cin/g, Cout] to PyTorch's layout (utils/params.from_jax)."""
        def conv(p):
            p["weight"] = conv_from_jax(p["weight"])

        for seanet, key in ((self.encoder, "encoder"), (self.decoder, "decoder")):
            for (kind, mod, _), p in zip(seanet.items, params[key]["model"]):
                if kind == "block":
                    for cp in p["block"]:
                        conv(cp)
                elif kind == "convtr":
                    p["weight"] = convtr_from_jax(p["weight"], mod.groups)
                else:
                    conv(p)
        conv(params["downsample"])
        params["upsample"]["weight"] = convtr_from_jax(params["upsample"]["weight"],
                                                       self.upsample.convtr.groups)

    def init_encode_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        return {
            "encoder": self.encoder.init_state(batch_size, dtype, device),
            "transformer": self.encoder_transformer.init_state(batch_size, dtype, device),
            "downsample": self.downsample.init_state(batch_size, dtype, device),
        }

    def init_decode_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        return {
            "decoder": self.decoder.init_state(batch_size, dtype, device),
            "transformer": self.decoder_transformer.init_state(batch_size, dtype, device),
            "upsample": self.upsample.init_state(batch_size, dtype, device),
        }

    def encode_step(self, params: dict, state: dict, x: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """x [B, C, n * frame_size] -> (codes [B, K, n], state)."""
        emb, _ = self.encoder.step(params["encoder"], state["encoder"], x.transpose(1, 2))
        emb, _ = self.encoder_transformer.step(params["encoder_transformer"],
                                               state["transformer"], emb)
        emb, _ = self.downsample.step(params["downsample"], state["downsample"], emb)
        return self.quantizer.encode(params["quantizer"], emb), state

    def decode_step(self, params: dict, state: dict, codes: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """codes [B, K, n] -> (audio [B, C, n * frame_size], state)."""
        emb = self.quantizer.decode(params["quantizer"], codes)
        emb, _ = self.upsample.step(params["upsample"], state["upsample"], emb)
        emb, _ = self.decoder_transformer.step(params["decoder_transformer"],
                                               state["transformer"], emb)
        out, _ = self.decoder.step(params["decoder"], state["decoder"], emb)
        return out.transpose(1, 2), state
