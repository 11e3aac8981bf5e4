"""Mimi: streaming neural audio codec, 24 kHz mono <-> 12.5 Hz RVQ tokens
(counterpart of moshi_tpu/models/mimi.py).

Public shapes are the JAX package's: audio [B, C, T], codes [B, K, T].
The offline path (`encode`, `decode`, `decode_latent`, `encode_to_latent`)
runs each module's `apply` over the whole input, which equals streaming it
from a fresh state; `encode` right-pads the audio with zeros to a whole
frame.  Streaming state is one tree of preallocated tensors that
`encode_step` and `decode_step` update in place.  The encoder and decoder
transformers are ProjectedTransformers: where the transformer's width
differs from the SEANet's, an input projection and an output projection
surround it; at equal widths both are identities (an empty `output_projs`
entry), as in the JAX package's tree.
"""

from dataclasses import dataclass, field

import torch

from ..modules.conv import conv_from_jax, conv_to_jax, convtr_from_jax, convtr_to_jax
from ..modules.resample import ConvDownsample1d, ConvTrUpsample1d
from ..modules.seanet import SEANetConfig, SEANetDecoder, SEANetEncoder
from ..modules.transformer import ProjectedTransformer, TransformerConfig
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
        self.encoder = SEANetEncoder(c.seanet)
        self.decoder = SEANetDecoder(c.seanet)
        dims = (c.seanet.dimension,)
        self.encoder_transformer = ProjectedTransformer(c.transformer, c.seanet.dimension, dims)
        self.decoder_transformer = ProjectedTransformer(c.transformer, c.seanet.dimension, dims)
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

    @property
    def cardinality(self) -> int:
        """Entries of each codebook."""
        return self.config.quantizer.bins

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
        return {
            "encoder": self.encoder.init_params(generator, dtype, device),
            "decoder": self.decoder.init_params(generator, dtype, device),
            "encoder_transformer": self.encoder_transformer.init_params(
                generator, dtype, device),
            "decoder_transformer": self.decoder_transformer.init_params(
                generator, dtype, device),
            "downsample": self.downsample.init_params(generator, dtype, device),
            "upsample": self.upsample.init_params(generator, dtype, device),
            "quantizer": self.quantizer.init_params(generator, dtype, device),
        }

    def relayout_jax_convs(self, params: dict, to_jax: bool = False) -> None:
        """Convert, in the tree, every conv weight from the JAX package's
        [K, Cin/g, Cout] to PyTorch's layout (utils/params.from_jax), or
        back with `to_jax` (native checkpoints hold the JAX layout)."""
        conv = conv_to_jax if to_jax else conv_from_jax
        convtr = convtr_to_jax if to_jax else convtr_from_jax

        def put(p, groups=None):
            p["weight"] = conv(p["weight"]) if groups is None else convtr(p["weight"], groups)

        for seanet, key in ((self.encoder, "encoder"), (self.decoder, "decoder")):
            for (kind, mod, _), p in zip(seanet.items, params[key]["model"]):
                if kind == "block":
                    for cp in p["block"] + ([p["shortcut"]] if "shortcut" in p else []):
                        put(cp)
                else:
                    put(p, mod.groups if kind == "convtr" else None)
        put(params["downsample"])
        put(params["upsample"], self.upsample.convtr.groups)

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

    # ---------------------------------------------------------------- offline
    def _latent(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Audio [B, C, T] -> the 12.5 Hz latent [B, T_frames, dim] before
        quantization, T zero-padded on the right to a whole frame."""
        pad = -x.shape[-1] % self.frame_size
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        emb = self.encoder.apply(params["encoder"], x.transpose(1, 2))
        (emb,) = self.encoder_transformer.apply(params["encoder_transformer"], emb)
        return self.downsample.apply(params["downsample"], emb)

    def encode(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Audio [B, C, T] -> codes [B, K, ceil(T / frame_size)]."""
        return self.quantizer.encode(params["quantizer"], self._latent(params, x))

    def decode(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """Codes [B, K, T_frames] -> audio [B, C, T_frames * frame_size]."""
        emb = self.quantizer.decode(params["quantizer"], codes)
        emb = self.upsample.apply(params["upsample"], emb)
        (emb,) = self.decoder_transformer.apply(params["decoder_transformer"], emb)
        return self.decoder.apply(params["decoder"], emb).transpose(1, 2)

    def decode_latent(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """Codes [B, K, T_frames] -> the quantizer's latent [B, T_frames,
        dim], before the upsample."""
        return self.quantizer.decode(params["quantizer"], codes)

    def encode_to_latent(self, params: dict, x: torch.Tensor,
                         quantize: bool = True) -> torch.Tensor:
        """Audio [B, C, T] -> the 12.5 Hz latent [B, T_frames, dim]: the
        quantized one (encode, then decode_latent) or, with quantize=False,
        the encoder's output (moshi_tpu mimi.py:148-167; TTS voice
        embeddings are made from it)."""
        emb = self._latent(params, x)
        if not quantize:
            return emb
        q = params["quantizer"]
        return self.quantizer.decode(q, self.quantizer.encode(q, emb))

    # --------------------------------------------------------------- streaming
    def encode_step(self, params: dict, state: dict, x: torch.Tensor,
                    exec_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """x [B, C, n * frame_size] -> (codes [B, K, n], state).  exec_mask
        [B] bool: the slots whose streaming state advances (all by
        default); a frozen slot's codes are computed and meaningless."""
        emb, _ = self.encoder.step(params["encoder"], state["encoder"], x.transpose(1, 2),
                                   exec_mask)
        (emb,), _ = self.encoder_transformer.step(params["encoder_transformer"],
                                                  state["transformer"], emb,
                                                  exec_mask=exec_mask)
        emb, _ = self.downsample.step(params["downsample"], state["downsample"], emb,
                                      exec_mask)
        return self.quantizer.encode(params["quantizer"], emb), state

    def decode_step(self, params: dict, state: dict, codes: torch.Tensor,
                    exec_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """codes [B, K, n] -> (audio [B, C, n * frame_size], state);
        exec_mask as in encode_step."""
        emb = self.quantizer.decode(params["quantizer"], codes)
        emb, _ = self.upsample.step(params["upsample"], state["upsample"], emb, exec_mask)
        (emb,), _ = self.decoder_transformer.step(params["decoder_transformer"],
                                                  state["transformer"], emb,
                                                  exec_mask=exec_mask)
        out, _ = self.decoder.step(params["decoder"], state["decoder"], emb, exec_mask)
        return out.transpose(1, 2), state
