"""Moshi RQ-Transformer language model (counterpart of
moshi_tpu/models/lm.py): token embeddings, the temporal transformer and its
text head, the extra heads of the speech-to-text models, and the depformer
that samples the audio codebooks of a frame (none when dep_q = 0, as in
the ASR presets).

The offline half: `forward_text` runs the temporal transformer's `apply`
over a whole sequence, and `forward` is the teacher-forced forward of
training and scoring (moshi_tpu lm.py:319-403): `delay_sequence`, the
temporal pass, one depformer pass over all B * T frames with per-step
weights (`forward_depformer_training`), then `undelay_logits` with NaN
tails and validity masks.  With q4 temporal weights the temporal pass runs
the q4 kernels at M = B * T rows; depformer_in, the depformer's per-step
linears and the output heads are gathered, cast einsums there, as in the
JAX package (no Pallas kernel).

`kv_cache_dtype` ("model", "int8" or "int4") sets the temporal
transformer's KV cache; the depformer, whose cache lives one frame, keeps
the model dtype (moshi_tpu lm.py:153).  The TTS and vision presets add
cross-attention to the temporal transformer (modules/transformer.py), and
the TTS ones a text head of `text_card_out` columns; CFG runs through the
depformer on a doubled batch (`depformer_step`'s `cfg_coef`).

The speech-to-speech (Hibiki) checkpoints add, as in the JAX package: a
schedule of the depformer's per-step weights
(`depformer_weights_per_step_schedule`: step k runs weight set
schedule[k] and reads depformer_in member `depformer_in_index(k)`), one
depformer_in for all steps (`depformer_multi_linear` false), low-rank
depformer embeddings (a table of rank `depformer_low_rank_embeddings`
times a [rank, depformer_dim] expansion) and a demuxed second text stream
(`out1` / `out2`).

Training (train.py) differentiates `forward` with autograd: `remat`
recomputes each temporal layer in the backward, and `cross_entropy` is the
per-codebook masked CE.  `causal: false` goes to both transformers: their
offline `apply` attends every position, their streaming steps keep the
ring mask (moshi_tpu lm.py:51, 144, 165).
"""

from dataclasses import dataclass

import torch

from ..modules.norm import make_norm
from ..modules.transformer import StreamingTransformer, TransformerConfig, dense
from ..utils.matmul import wdot
from ..utils.params import trunc_normal
from ..utils.sampling import sample_token

ZERO_TOKEN = -1         # embeds to exactly 0
UNGENERATED_TOKEN = -2  # "to be predicted" marker

# config.json keys that CheckpointInfo reads, and deprecated ones
_CHECKPOINT_KEYS = ("moshi_name", "mimi_name", "mimi_config_name", "tokenizer_name",
                    "lora_name", "model_type", "lm_gen_config", "tts_config",
                    "stt_config", "model_id", "depformer_causal", "lora", "lora_rank",
                    "lora_scaling", "quantize", "conditioners", "fuser",
                    "depformer_context")


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
    causal: bool = True   # False: the offline forward attends every position
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
    demux_second_text_stream: bool = False
    depformer_multi_linear: bool = True  # False: one depformer_in for every step
    depformer_weights_per_step: bool = True
    # step k runs weight set schedule[k] (None: set k)
    depformer_weights_per_step_schedule: tuple[int, ...] | None = None
    depformer_low_rank_embeddings: int | None = None
    # layer-wise recomputation in the temporal transformer's training
    # forward (modules/transformer.py TransformerConfig.remat)
    remat: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "LmConfig":
        """Build from the reference `config.json` schema (moshi_tpu lm.py
        `LmConfig.from_dict`)."""
        d = dict(d)
        for k in _CHECKPOINT_KEYS:
            d.pop(k, None)
        if "demux_second_stream" in d:
            d["demux_second_text_stream"] = d.pop("demux_second_stream")
        unknown = sorted(set(d) - set(cls.__dataclass_fields__))
        if unknown:
            raise ValueError(f"unknown LM config keys: {unknown}")
        if "delays" in d:
            d["delays"] = tuple(d["delays"])
        if d.get("depformer_weights_per_step_schedule") is not None:
            d["depformer_weights_per_step_schedule"] = tuple(
                d["depformer_weights_per_step_schedule"])
        return cls(**d)

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
            dim_feedforward=int(self.hidden_scale * self.dim), causal=self.causal,
            context=self.context,
            positional_embedding=self.positional_embedding, max_period=self.max_period,
            gating=self.gating, norm=self.norm, layer_scale=self.layer_scale,
            kv_repeat=self.kv_repeat, kv_cache_dtype=self.kv_cache_dtype,
            attention_int8_qk=self.attention_int8_qk, cross_attention=self.cross_attention,
            cross_attention_gating=self.cross_attention_gating,
            cross_attention_norm=self.cross_attention_norm,
            cross_attention_kv_dim=self.cross_attention_kv_dim,
            shared_cross_attn=self.shared_cross_attn, remat=self.remat)

    @property
    def depformer_config(self) -> TransformerConfig:
        ff = self.depformer_dim_feedforward
        if ff is None:
            ff = int(self.hidden_scale * self.depformer_dim)
        return TransformerConfig(
            d_model=self.depformer_dim, num_heads=self.depformer_num_heads,
            num_layers=self.depformer_num_layers, dim_feedforward=ff, causal=self.causal,
            context=None,
            positional_embedding=self.depformer_pos_emb,
            max_period=self.depformer_max_period, gating=self.depformer_gating,
            norm=self.depformer_norm or self.norm,
            kv_repeat=self.depformer_kv_repeat,
            layer_scale=self.depformer_layer_scale,
            weights_per_step=self.dep_q if self.depformer_weights_per_step else 0,
            weights_per_step_schedule=self.depformer_weights_per_step_schedule)

    @property
    def num_depformer_in(self) -> int:
        """Members of the depformer_in stack."""
        if not self.depformer_multi_linear:
            return 1
        if self.depformer_weights_per_step_schedule is not None:
            return max(self.depformer_weights_per_step_schedule) + 1
        return self.dep_q

    def depformer_in_index(self, k: int) -> int:
        """The depformer_in member that codebook step k reads."""
        if not self.depformer_multi_linear:
            return 0
        if self.depformer_weights_per_step_schedule is not None:
            return self.depformer_weights_per_step_schedule[k]
        return k


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


def lm_config_s2s_v0_1(num_slices: int = 16) -> LmConfig:
    """Speech-to-speech 1B (moshi_tpu/models/loaders.py)."""
    return LmConfig(
        dim=2048, num_heads=16, num_layers=16, hidden_scale=4.125,
        context=3000, max_period=10_000.0, gating="silu", norm="rms_norm_f32",
        positional_embedding="rope", layer_scale=None, card=2048, text_card=48000,
        n_q=16, delays=_acoustic_delays(16, num_slices, 2), **_depformer_kwargs(num_slices))


def lm_config_s2s_2b_16rvq_202501() -> LmConfig:
    """Speech-to-speech 2.6B, 16 generated and 16 input codebooks
    (moshi_tpu/models/loaders.py)."""
    return LmConfig(
        dim=2560, num_heads=20, num_layers=24, hidden_scale=4.125,
        context=3000, max_period=100_000.0, gating="silu", norm="rms_norm_f32",
        positional_embedding="rope", layer_scale=None, card=2048, text_card=48000,
        n_q=32, delays=_acoustic_delays(32, 16, 2), **_depformer_kwargs(16))


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
    context.  A `low_rank` [rank, dim] part expands the looked-up rows; an
    `out1` / `out2` pair demuxes a muxed id (tok2 + 1) * card + tok1 into
    table[tok1] @ out1 + table[tok2] @ out2, the second term zero where
    tok2 < 0."""
    w = table_params["weight"]
    card = w.shape[0]
    is_zero = (tokens == ZERO_TOKEN)[..., None]
    tokens = tokens.clamp(min=0)
    if "out1" in table_params:
        right = tokens // card - 1
        y = torch.matmul(w[tokens % card], table_params["out1"].to(w.dtype))
        second = torch.matmul(w[right.clamp(0, card - 1)], table_params["out2"].to(w.dtype))
        y = y + second.masked_fill((right < 0)[..., None], 0)
    else:
        y = w[tokens.clamp(max=card - 1)]
        if "low_rank" in table_params:
            y = torch.matmul(y, table_params["low_rank"])
    y = y.masked_fill(is_zero, 0)
    return y if dtype is None else y.to(dtype)


def delay_sequence(delays: tuple[int, ...], tokens: torch.Tensor,
                   initial: torch.Tensor) -> torch.Tensor:
    """tokens [B, K, T]: each codebook k rolled right by delays[k], its first
    delays[k] steps set to initial[:, k] ([B, K])."""
    if len(delays) != tokens.shape[1]:
        raise ValueError(f"{len(delays)} delays for {tokens.shape[1]} codebooks")
    outs = []
    for k, d in enumerate(delays):
        line = torch.roll(tokens[:, k], d, dims=1)
        if d > 0:
            line[:, :d] = initial[:, k, None]
        outs.append(line)
    return torch.stack(outs, dim=1)


def undelay_logits(delays: tuple[int, ...], logits: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, K, T, card]: each codebook k rolled left by delays[k], its
    last delays[k] steps NaN; and the validity mask [B, K, T] bool."""
    B, K, T = logits.shape[:3]
    if len(delays) != K:
        raise ValueError(f"{len(delays)} delays for {K} codebooks")
    mask = torch.ones((B, K, T), dtype=torch.bool, device=logits.device)
    outs = []
    for k, d in enumerate(delays):
        line = torch.roll(logits[:, k], -d, dims=1)
        if d > 0:
            line[:, T - d:] = float("nan")
            mask[:, k, T - d:] = False
        outs.append(line)
    return torch.stack(outs, dim=1), mask


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                  count: torch.Tensor | None = None) -> torch.Tensor:
    """Masked cross entropy in f32 over every position where `mask` holds,
    summed and divided by `count`, by default the number of them (moshi_tpu
    lm.py:477-483): logits [..., card], targets and mask [...].  A
    data-parallel rank passes the global batch's count, so the ranks' losses
    sum to the global mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    ll = torch.where(mask, ll, torch.zeros_like(ll))
    return -ll.sum() / (mask.sum() if count is None else count).clamp(min=1)


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
            dd, lr = c.depformer_dim, c.depformer_low_rank_embeddings
            p.update({
                "depformer_in": {"weight": trunc((c.num_depformer_in, c.dim, dd), c.dim)},
                "depformer_text_emb": {"weight": trunc((c.text_card + 1, lr or dd), lr or dd)},
                "depformer_emb": {"weight": trunc((c.dep_q - 1, c.card + 1, lr or dd),
                                                  lr or dd)},
                "depformer": self.depformer.init_params(generator, dtype, device),
                "linears": {"weight": trunc((c.dep_q, dd, c.card), dd)},
            })
            if lr is not None:
                p["depformer_text_emb"]["low_rank"] = trunc((lr, dd), lr)
                p["depformer_emb"]["low_rank"] = trunc((c.dep_q - 1, lr, dd), lr)
        return p

    def embed_inputs(self, params: dict, sequence: torch.Tensor) -> torch.Tensor:
        """sequence [B, K = 1 + n_q, T] token ids -> summed embeddings
        [B, T, dim].  A text-only LM (n_q == 0, Helium) embeds the text
        alone."""
        c = self.config
        text = embed(params["text_emb"], sequence[:, 0])
        if c.n_q == 0:
            return text
        w = params["emb"]["weight"]
        audio = torch.stack([embed({"weight": w[k]}, sequence[:, c.audio_offset + k])
                             for k in range(c.n_q)])
        return audio.sum(dim=0) + text

    def _text_head(self, params: dict, h: torch.Tensor):
        h = self._out_norm.apply(params["out_norm"], h)
        return h, wdot(h, params["text_linear"]["weight"])

    def forward_text(self, params: dict, sequence: torch.Tensor,
                     sum_condition: torch.Tensor | None = None,
                     cross_src: torch.Tensor | None = None):
        """Offline temporal forward: sequence [B, K, T] -> (h [B, T, dim],
        text_logits [B, 1, T, text_out_card]); sum_condition is added to the
        input embeddings, cross_src [B, Ts, kv_dim] is the cross-attention
        source."""
        x = self.embed_inputs(params, sequence)
        if sum_condition is not None:
            x = x + sum_condition.to(x.dtype)
        h = self.transformer.apply(params["transformer"], x, cross_src=cross_src)
        h, text_logits = self._text_head(params, h)
        return h, text_logits[:, None]

    def forward(self, params: dict, codes: torch.Tensor,
                sum_condition: torch.Tensor | None = None,
                cross_src: torch.Tensor | None = None) -> dict:
        """Teacher-forced forward of codes [B, K = 1 + n_q, T] (the text
        stream first): {"logits" [B, dep_q, T, card], "mask" [B, dep_q, T],
        "text_logits" [B, 1, T, text_out_card], "text_mask" [B, 1, T]}, all
        aligned with the input codes; a mask is False where the delays
        leave no prediction or the code is ZERO_TOKEN."""
        c = self.config
        B, K, T = codes.shape
        if K != c.num_codebooks:
            raise ValueError(f"{K} codebooks, the model has {c.num_codebooks}")
        initial = self._initial_token(B, codes.device)
        delayed = delay_sequence(c.delays, codes, initial)
        delayed = torch.cat([initial[:, :, None], delayed], dim=2)
        h, text_logits = self.forward_text(params, delayed[:, :, :-1], sum_condition,
                                           cross_src)
        logits = self.forward_depformer_training(params, delayed[:, :, 1:], h)
        audio = slice(c.audio_offset, c.audio_offset + c.dep_q)
        logits, mask = undelay_logits(c.delays[audio], logits)
        mask &= codes[:, audio] != ZERO_TOKEN
        text_logits, text_mask = undelay_logits(c.delays[:1], text_logits)
        text_mask &= codes[:, :1] != ZERO_TOKEN
        return {"logits": logits, "mask": mask,
                "text_logits": text_logits, "text_mask": text_mask}

    def forward_depformer_training(self, params: dict, delayed: torch.Tensor,
                                   h: torch.Tensor) -> torch.Tensor:
        """One depformer pass over all B * T frames: delayed [B, K, T] the
        shifted target tokens, h [B, T, dim] the temporal output ->
        logits [B, dep_q, T, card].  Each frame is a sequence of dep_q
        positions with the per-step weights of steps 0..dep_q-1."""
        c = self.config
        B, _, T = delayed.shape
        dd = c.depformer_dim
        win = dense(params["depformer_in"]["weight"], h.dtype)       # [num_in, dim, dd]
        win = win[[c.depformer_in_index(k) for k in range(c.dep_q)]]  # [dep_q, dim, dd]
        tr_in = torch.einsum("btd,kde->bkte", h, win)                 # [B, dep_q, T, dd]
        demb = params["depformer_emb"]
        tok_in = [embed(params["depformer_text_emb"], delayed[:, 0], tr_in.dtype)]
        for k in range(1, c.dep_q):
            table = {name: w[k - 1] for name, w in demb.items()}
            tok_in.append(embed(table, delayed[:, k + c.audio_offset - 1], tr_in.dtype))
        dep_input = (tr_in + torch.stack(tok_in, dim=1)).transpose(1, 2).reshape(
            B * T, c.dep_q, dd)
        dep_out = self.depformer.apply(params["depformer"], dep_input,
                                       steps=range(c.dep_q))
        wlin = dense(params["linears"]["weight"], dep_out.dtype)    # [dep_q, dd, card]
        logits = torch.einsum("nkd,kdc->nkc", dep_out, wlin)
        return logits.reshape(B, T, c.dep_q, c.card).transpose(1, 2)

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
        frame, the per-step weights of step k (through the schedule), and
        depformer_in[depformer_in_index(k)] applied to h per codebook (an
        int8 GEMV each, instead of dequantizing the whole stack as the JAX
        package does; steps that share a member read the same weight).
        With cfg_coef != 1, h holds the conditioned rows then the
        unconditioned ones (B_model = 2B): both run, each step's
        previous-token embedding is shared by the pair, and the logits
        combine as uncond + (cond - uncond) * cfg_coef."""
        c = self.config
        B, B_model = text_token.shape[0], h.shape[0]
        if B_model != (2 * B if cfg_coef != 1.0 else B):
            raise ValueError(f"h has {B_model} rows for {B} tokens at cfg_coef {cfg_coef}")
        win = params["depformer_in"]["weight"]
        demb = params["depformer_emb"]
        dep_state = self.depformer.init_state(B_model, dtype=h.dtype, device=h.device)
        prev = embed(params["depformer_text_emb"], text_token, h.dtype)
        tokens = []
        for k in range(c.dep_q):
            if cfg_coef != 1.0:
                prev = prev.repeat(2, 1)
            x = (wdot(h[:, 0], win[c.depformer_in_index(k)]) + prev)[:, None]
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
                prev = embed({name: w[k] for name, w in demb.items()}, token, h.dtype)
        return torch.stack(tokens, dim=1)

    def _initial_token(self, B: int, device=None) -> torch.Tensor:
        """[B, K] initial tokens: text_card for text, card for audio."""
        c = self.config
        t = torch.full((B, c.num_codebooks), c.initial_token_id, dtype=torch.long,
                       device=device)
        t[:, 0] = c.text_initial_token_id
        return t
