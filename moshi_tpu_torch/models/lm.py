"""Moshi RQ-Transformer language model, inference half (counterpart of
moshi_tpu/models/lm.py): token embeddings, the temporal transformer and its
text head, the extra heads of the speech-to-text models, and the depformer
that samples the audio codebooks of a frame (none when dep_q = 0, as in
the ASR presets).

`kv_cache_dtype` ("model", "int8" or "int4") sets the temporal
transformer's KV cache; the depformer, whose cache lives one frame, keeps
the model dtype (moshi_tpu lm.py:153).  The TTS and vision presets add
cross-attention to the temporal transformer (modules/transformer.py), and
the TTS ones a text head of `text_card_out` columns; CFG runs through the
depformer on a doubled batch (`depformer_step`'s `cfg_coef`).

Not ported yet: the training forward, low-rank and demuxed embeddings.
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
    text_card_out: int | None = None  # the text head's width (None: text_card)
    norm: str = "rms_norm_f32"
    context: int | None = 100
    max_period: float = 10_000.0
    gating: str = "silu"
    positional_embedding: str = "rope"
    layer_scale: float | None = None
    kv_repeat: int = 1
    cross_attention: bool = False
    cross_attention_gating: str = "normal"
    cross_attention_norm: str = "layer_norm"
    cross_attention_kv_dim: int | None = None
    shared_cross_attn: bool = False
    delays: tuple[int, ...] = (0,) * 9
    existing_text_padding_id: int = 3
    existing_text_end_padding_id: int = 0
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
    kv_cache_dtype: str = "model"  # model | int8 | int4 (temporal transformer only)
    attention_int8_qk: bool = False  # XLA-only in the JAX package; refused here
    extra_heads_num_heads: int = 0
    extra_heads_dim: int = 6

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
    def text_out_card(self) -> int:
        return self.text_card if self.text_card_out is None else self.text_card_out

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
            kv_repeat=self.kv_repeat, kv_cache_dtype=self.kv_cache_dtype,
            attention_int8_qk=self.attention_int8_qk, cross_attention=self.cross_attention,
            cross_attention_gating=self.cross_attention_gating,
            cross_attention_norm=self.cross_attention_norm,
            cross_attention_kv_dim=self.cross_attention_kv_dim,
            shared_cross_attn=self.shared_cross_attn)

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


def lm_config_asr_v0_1_1b() -> LmConfig:
    """Streaming ASR 1B, no depformer (moshi_tpu/models/loaders.py)."""
    return LmConfig(
        dim=2048, num_heads=16, num_layers=16, hidden_scale=4.125,
        context=750, max_period=100_000.0, gating="silu", norm="rms_norm_f32",
        positional_embedding="rope", layer_scale=None,
        card=2048, text_card=48000, n_q=8, dep_q=0, delays=(0,) * 9)


def lm_config_asr_300m_202501() -> LmConfig:
    """The 300M streaming ASR model, 32 codebooks, no depformer
    (moshi_tpu/models/loaders.py)."""
    return LmConfig(
        dim=1024, num_heads=8, num_layers=16, hidden_scale=4.125,
        context=750, max_period=100_000.0, gating="silu", norm="rms_norm_f32",
        positional_embedding="rope", layer_scale=None,
        card=2048, text_card=48000, n_q=32, dep_q=0, delays=(0,) * 33)


def _depformer_kwargs(num_slices: int) -> dict:
    """The depformer every preset below shares (moshi_tpu/models/loaders.py
    `_depformer_kwargs`): d 1024, 16 heads, 6 layers, SiLU-gated, one
    weight set per codebook, dep_q = num_slices."""
    return dict(dep_q=num_slices, depformer_dim=1024, depformer_num_heads=16,
                depformer_num_layers=6, depformer_dim_feedforward=int(4.125 * 1024),
                depformer_gating="silu", depformer_pos_emb="none",
                depformer_max_period=10_000.0, depformer_layer_scale=None)


def _acoustic_delays(n_q: int, dep_q: int, delay: int) -> tuple[int, ...]:
    """Text 0; for each stream its semantic codebook 0 and its acoustic
    codebooks `delay` (moshi_tpu/models/loaders.py `_acoustic_delays`)."""
    out = [0, 0] + [delay] * (dep_q - 1)
    rest = n_q - dep_q
    while rest > 0:
        k = min(rest, dep_q)
        out += [0] + [delay] * (k - 1)
        rest -= k
    return tuple(out)


def lm_config_tts_v0_1() -> LmConfig:
    """DSM TTS 1.6B (moshi_tpu/models/loaders.py): ungated LayerNorm
    cross-attention over voice embeddings, plain GELU MLP, 32 heads of 64, a
    32001-column text head and 2049-entry audio tables."""
    return LmConfig(
        dim=2048, num_heads=32, num_layers=48, hidden_scale=4.0,
        context=4096, max_period=10_000.0, gating="none", norm="layer_norm",
        positional_embedding="rope", layer_scale=None,
        card=2049, text_card=32000, text_card_out=32001, n_q=16,
        cross_attention=True, cross_attention_gating="normal",
        cross_attention_norm="layer_norm",
        delays=_acoustic_delays(16, 16, 2), **_depformer_kwargs(16))


def lm_config_tts_202501() -> LmConfig:
    """DSM TTS 2025-01 with 32 codebooks (moshi_tpu/models/loaders.py)."""
    return LmConfig(
        dim=2048, num_heads=32, num_layers=48, hidden_scale=4.125,
        context=500, max_period=10_000.0, gating="silu", norm="rms_norm_f32",
        positional_embedding="rope", layer_scale=None,
        card=2048, text_card=8000, n_q=32,
        cross_attention=True, cross_attention_gating="normal",
        cross_attention_norm="layer_norm",
        delays=_acoustic_delays(32, 32, 2), **_depformer_kwargs(32))


def lm_config_v0_1_vision(num_slices: int = 8, streaming: bool = False) -> LmConfig:
    """Moshi-7B with gated cross-attention for vision conditioning
    (moshi_tpu/models/loaders.py): conditional sigmoid gates, an RMS
    cross-norm, one projection set shared by every layer."""
    n_q = 16 if streaming else 8
    return LmConfig(
        dim=4096, num_heads=32, num_layers=32, hidden_scale=4.125,
        context=3000, max_period=10_000.0, gating="silu", norm="rms_norm_f32",
        positional_embedding="rope", layer_scale=None,
        card=2048, text_card=32000, n_q=n_q,
        cross_attention=True, cross_attention_gating="conditional_gated_sigmoid",
        cross_attention_norm="rms_norm_f32", shared_cross_attn=True,
        delays=_acoustic_delays(n_q, num_slices, 1), **_depformer_kwargs(num_slices))


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
            "text_linear": {"weight": trunc((c.dim, c.text_out_card), c.dim)},
        }
        if c.extra_heads_num_heads:
            p["extra_heads"] = {"weight": trunc(
                (c.extra_heads_num_heads, c.dim, c.extra_heads_dim), c.dim)}
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

    def forward_text_step(self, params: dict, tr_state: dict, sequence: torch.Tensor,
                          sum_condition: torch.Tensor | None = None,
                          exec_mask: torch.Tensor | None = None):
        """Temporal forward of one step.  sequence [B, K, 1] -> (h [B, 1, dim],
        text_logits [B, 1, 1, text_card], tr_state); sum_condition [1, 1,
        dim] is added to the input embeddings (the conditioners' AddToInput
        sum); exec_mask [B] bool: the slots whose KV offsets advance (all by
        default)."""
        x = self.embed_inputs(params, sequence)
        if sum_condition is not None:
            x = x + sum_condition.to(x.dtype)
        h, tr_state = self.transformer.step(params["transformer"], tr_state, x,
                                            exec_mask=exec_mask)
        h, text_logits = self._text_head(params, h)
        return h, text_logits[:, None], tr_state

    def extra_head_probs(self, params: dict, h: torch.Tensor) -> torch.Tensor | None:
        """Softmax of each extra head over h [B, T, dim]: [n_heads, B, T,
        extra_heads_dim] f32, or None for a model without extra heads."""
        if "extra_heads" not in params:
            return None
        logits = torch.einsum("btd,ndo->nbto", h, params["extra_heads"]["weight"].to(h.dtype))
        return torch.softmax(logits.float(), dim=-1)

    def depformer_step(self, params: dict, generator: torch.Generator | None,
                       text_token: torch.Tensor, h: torch.Tensor, *,
                       use_sampling: bool = True, temp: float = 0.8,
                       top_k: int = 250, cfg_coef: float = 1.0) -> torch.Tensor:
        """Sample the dep_q audio codebooks of one frame: text_token [B], h
        [B_model, 1, dim] -> [B, dep_q].  A fresh depformer state each
        frame, the per-step weights of step k, and depformer_in[k] applied
        to h per codebook (an int8 GEMV each, instead of dequantizing the
        whole stack as the JAX package does).  With cfg_coef != 1, h holds
        the conditioned rows then the unconditioned ones (B_model = 2B):
        both run, each step's previous-token embedding is shared by the
        pair, and the logits combine as uncond + (cond - uncond) *
        cfg_coef."""
        c = self.config
        B, B_model = text_token.shape[0], h.shape[0]
        if B_model != (2 * B if cfg_coef != 1.0 else B):
            raise ValueError(f"h has {B_model} rows for {B} tokens at cfg_coef {cfg_coef}")
        win = params["depformer_in"]["weight"]
        demb = params["depformer_emb"]["weight"]
        dep_state = self.depformer.init_state(B_model, dtype=h.dtype, device=h.device)
        prev = embed(params["depformer_text_emb"], text_token, h.dtype)
        tokens = []
        for k in range(c.dep_q):
            if cfg_coef != 1.0:
                prev = prev.repeat(2, 1)
            x = (wdot(h[:, 0], win[k]) + prev)[:, None]
            y, dep_state = self.depformer.step(params["depformer"], dep_state, x,
                                               steps=(k,))
            logits = wdot(y[:, 0], params["linears"]["weight"][k])
            if cfg_coef != 1.0:
                cond, uncond = logits.chunk(2, dim=0)
                logits = uncond + (cond - uncond) * cfg_coef
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
