"""Moshi RQ-Transformer language model, inference half (counterpart of
moshi_tpu/models/lm.py): token embeddings, the temporal transformer and its
text head, and the depformer that samples the audio codebooks of a frame.

Not ported yet: the training forward, low-rank and demuxed embeddings,
extra heads, cross-attention and CFG in the depformer.
"""

from dataclasses import dataclass

import torch

from ..modules.norm import make_norm
from ..modules.transformer import StreamingTransformer, TransformerConfig
from ..utils.matmul import wdot
from ..utils.params import trunc_normal
from ..utils.sampling import sample_token

ZERO_TOKEN = -1         # embeds to exactly 0
UNGENERATED_TOKEN = -2  # "to be predicted" marker


@dataclass(frozen=True)
class LmConfig:
    dim: int = 128
    num_heads: int = 8
    num_layers: int = 2
    hidden_scale: float = 4.125
    n_q: int = 8
    dep_q: int = 8
    card: int = 1024
    text_card: int = 32000
    norm: str = "rms_norm_f32"
    context: int | None = 100
    max_period: float = 10_000.0
    gating: str = "silu"
    positional_embedding: str = "rope"
    layer_scale: float | None = None
    kv_repeat: int = 1
    delays: tuple[int, ...] = (0,) * 9
    existing_text_padding_id: int = 3
    depformer_dim: int = 256
    depformer_num_heads: int = 8
    depformer_num_layers: int = 2
    depformer_dim_feedforward: int | None = None
    depformer_gating: str = "silu"
    depformer_norm: str | None = None  # None -> same as `norm`
    depformer_kv_repeat: int = 1
    depformer_pos_emb: str = "none"
    depformer_max_period: float = 10_000.0
    depformer_layer_scale: float | None = None

    @property
    def num_codebooks(self) -> int:
        return self.n_q + 1

    @property
    def audio_offset(self) -> int:
        return 1

    @property
    def initial_token_id(self) -> int:
        return self.card

    @property
    def text_initial_token_id(self) -> int:
        return self.text_card

    @property
    def max_delay(self) -> int:
        return max(self.delays)

    @property
    def transformer_config(self) -> TransformerConfig:
        return TransformerConfig(
            d_model=self.dim, num_heads=self.num_heads, num_layers=self.num_layers,
            dim_feedforward=int(self.hidden_scale * self.dim), context=self.context,
            positional_embedding=self.positional_embedding, max_period=self.max_period,
            gating=self.gating, norm=self.norm, layer_scale=self.layer_scale,
            kv_repeat=self.kv_repeat)

    @property
    def depformer_config(self) -> TransformerConfig:
        ff = self.depformer_dim_feedforward
        if ff is None:
            ff = int(self.hidden_scale * self.depformer_dim)
        return TransformerConfig(
            d_model=self.depformer_dim, num_heads=self.depformer_num_heads,
            num_layers=self.depformer_num_layers, dim_feedforward=ff, context=None,
            positional_embedding=self.depformer_pos_emb,
            max_period=self.depformer_max_period, gating=self.depformer_gating,
            norm=self.depformer_norm or self.norm,
            kv_repeat=self.depformer_kv_repeat,
            layer_scale=self.depformer_layer_scale, weights_per_step=self.dep_q)


def lm_config_v0_1() -> LmConfig:
    """The Moshi-7B configuration (moshi_tpu/models/loaders.py)."""
    return LmConfig(
        dim=4096, text_card=32000, existing_text_padding_id=3, n_q=16, dep_q=8,
        card=2048, num_heads=32, num_layers=32, hidden_scale=4.125, layer_scale=None,
        context=3000, max_period=10_000.0, gating="silu", norm="rms_norm_f32",
        positional_embedding="rope", depformer_dim=1024,
        depformer_dim_feedforward=int(4.125 * 1024), depformer_num_heads=16,
        depformer_num_layers=6, depformer_layer_scale=None,
        depformer_max_period=10_000.0, depformer_gating="silu",
        depformer_pos_emb="none",
        delays=(0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1))


def embed(table_params: dict, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """ScaledEmbedding lookup: ZERO_TOKEN embeds to exactly zero, and every
    other id is clamped into the table.  Clients can send any id; an
    unclamped index on CUDA fires a device-side assert that poisons the
    context."""
    if set(table_params) != {"weight"}:
        raise NotImplementedError(f"embedding parts {sorted(table_params)}")
    w = table_params["weight"]
    y = w[tokens.clamp(0, w.shape[0] - 1)]
    y = y.masked_fill((tokens == ZERO_TOKEN)[..., None], 0)
    return y if dtype is None else y.to(dtype)


class LMModel:
    def __init__(self, config: LmConfig):
        self.config = config
        self.transformer = StreamingTransformer(config.transformer_config)
        self.depformer = StreamingTransformer(config.depformer_config) if config.dep_q > 0 else None
        self._out_norm = make_norm(config.norm, config.dim)

    def init_params(self, generator: torch.Generator, dtype=torch.bfloat16,
                    device=None) -> dict:
        c = self.config

        def trunc(shape, fan_in):
            return trunc_normal(generator, shape, fan_in, dtype, device)

        p = {
            "text_emb": {"weight": trunc((c.text_card + 1, c.dim), c.dim)},
            "emb": {"weight": trunc((c.n_q, c.card + 1, c.dim), c.dim)},
            "transformer": self.transformer.init_params(generator, dtype, device),
            "out_norm": {k: v.float() for k, v in
                         self._out_norm.init_params(dtype, device).items()},
            "text_linear": {"weight": trunc((c.dim, c.text_card), c.dim)},
        }
        if self.depformer is not None:
            dd = c.depformer_dim
            p.update({
                "depformer_in": {"weight": trunc((c.dep_q, c.dim, dd), c.dim)},
                "depformer_text_emb": {"weight": trunc((c.text_card + 1, dd), dd)},
                "depformer_emb": {"weight": trunc((c.dep_q - 1, c.card + 1, dd), dd)},
                "depformer": self.depformer.init_params(generator, dtype, device),
                "linears": {"weight": trunc((c.dep_q, dd, c.card), dd)},
            })
        return p

    def embed_inputs(self, params: dict, sequence: torch.Tensor) -> torch.Tensor:
        """sequence [B, K = 1 + n_q, T] token ids -> summed embeddings
        [B, T, dim]."""
        c = self.config
        w = params["emb"]["weight"]
        audio = torch.stack([embed({"weight": w[k]}, sequence[:, c.audio_offset + k])
                             for k in range(c.n_q)])
        return audio.sum(dim=0) + embed(params["text_emb"], sequence[:, 0])

    def _text_head(self, params: dict, h: torch.Tensor):
        h = self._out_norm.apply(params["out_norm"], h)
        return h, wdot(h, params["text_linear"]["weight"])

    def forward_text_step(self, params: dict, tr_state: dict, sequence: torch.Tensor):
        """Temporal forward of one step.  sequence [B, K, 1] -> (h [B, 1, dim],
        text_logits [B, 1, 1, text_card], tr_state)."""
        x = self.embed_inputs(params, sequence)
        h, tr_state = self.transformer.step(params["transformer"], tr_state, x)
        h, text_logits = self._text_head(params, h)
        return h, text_logits[:, None], tr_state

    def depformer_step(self, params: dict, generator: torch.Generator | None,
                       text_token: torch.Tensor, h: torch.Tensor, *,
                       use_sampling: bool = True, temp: float = 0.8,
                       top_k: int = 250) -> torch.Tensor:
        """Sample the dep_q audio codebooks of one frame: text_token [B], h
        [B, 1, dim] -> [B, dep_q].  A fresh depformer state each frame, the
        per-step weights of step k, and depformer_in[k] applied to h per
        codebook (an int8 GEMV each, instead of dequantizing the whole
        stack as the JAX package does)."""
        c = self.config
        B = text_token.shape[0]
        win = params["depformer_in"]["weight"]
        demb = params["depformer_emb"]["weight"]
        dep_state = self.depformer.init_state(B, dtype=h.dtype, device=h.device)
        prev = embed(params["depformer_text_emb"], text_token, h.dtype)
        tokens = []
        for k in range(c.dep_q):
            x = (wdot(h[:, 0], win[k]) + prev)[:, None]
            y, dep_state = self.depformer.step(params["depformer"], dep_state, x,
                                               steps=(k,))
            logits = wdot(y[:, 0], params["linears"]["weight"][k])
            token = sample_token(generator, logits, use_sampling=use_sampling,
                                 temp=temp, top_k=top_k)
            tokens.append(token)
            if k < c.dep_q - 1:
                prev = embed({"weight": demb[k]}, token, h.dtype)
        return torch.stack(tokens, dim=1)

    def _initial_token(self, B: int, device=None) -> torch.Tensor:
        """[B, K] initial tokens: text_card for text, card for audio."""
        c = self.config
        t = torch.full((B, c.num_codebooks), c.initial_token_id, dtype=torch.long,
                       device=device)
        t[:, 0] = c.text_initial_token_id
        return t
