"""Delayed Streams Modeling (DSM) text-to-speech (counterpart of
moshi_tpu/models/tts.py).

Every frame the LM samples a text token; the host state machine
(`StateMachine.process`, pure Python, the port's copy) rewrites it: queued
word tokens and padding budgets are force-fed, a sampled `new_word` pops
the next entry.  The audio codebooks follow `delay_steps` frames behind the
text.  A frame is `LMGen.main_step` (temporal step, text sampling), the
machine, then `LMGen.depth_step` (depformer, audio forcing as tensors, the
commit).  Voices condition the LM through cross-attention over speaker
embeddings (`make_condition_attributes`), or through an audio prefix
(`get_prefix` encodes its PCM with the offline Mimi encoder into the codes
that `generate`'s `prefixes` take); CFG's null condition drops every
condition.

Voice names resolve as the JAX package's do (models/loaders.py `hf_get`):
an alias first, then `name + voice_suffix`; a file that exists as it is,
an `hf://org/repo/path` name, or a name inside `voice_repo`, a local
directory or a hub repository.
"""

import re
import typing as tp
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .lm import UNGENERATED_TOKEN, ZERO_TOKEN
from .lm_gen import LMGen, LMGenConfig
from ..conditioners import ConditionAttributes, TensorCondition, dropout_all_conditions

DEFAULT_MAX_SPEAKERS = 5


@dataclass
class TokenIds:
    card: int
    new_word: int = 0
    pad: int = 3
    main: int = 1
    other: int = 2
    zero: int = ZERO_TOKEN
    ungenerated: int = UNGENERATED_TOKEN


@dataclass
class Entry:
    tokens: list[int]
    text: str
    padding: int = 0


@dataclass
class State:
    entries: deque
    remaining_padding: int
    forced_padding: int
    queued: deque = field(default_factory=deque)
    lookahead_queued: deque = field(default_factory=deque)
    end_step: int | None = None
    consumption_times: list = field(default_factory=list)
    transcript: list = field(default_factory=list)

    def get_tokens_ahead(self, lookahead: int) -> list[int]:
        if lookahead <= 0:
            raise ValueError(f"lookahead {lookahead}")
        for entry in self.entries:
            if entry.tokens:
                lookahead -= 1
                if lookahead == 0:
                    return entry.tokens
        return []


@dataclass
class StateMachine:
    token_ids: TokenIds
    second_stream_ahead: int = 0
    max_padding: int = 6
    initial_padding: int = 2

    def new_state(self, entries: tp.Sequence[Entry]) -> State:
        return State(entries=deque(entries), remaining_padding=self.initial_padding,
                     forced_padding=self.initial_padding)

    def process(self, step: int, state: State, token: int) -> tuple[int, bool]:
        """Rewrite the model's sampled text `token` into the frame's actual
        text input.  Returns (output_token, consumed_new_word)."""
        ids = self.token_ids
        consumed_new_word = False
        if token not in (ids.new_word, ids.pad):
            token = ids.pad

        if state.queued:
            token = ids.pad
        elif state.forced_padding > 0:
            token = ids.pad
        elif state.remaining_padding <= 0:
            token = ids.new_word

        if token == ids.new_word:
            if state.entries:
                entry = state.entries.popleft()
                state.consumption_times.append(step)
                consumed_new_word = True
                if entry.tokens:
                    state.transcript.append((entry.text, step))
                    state.queued.extend(entry.tokens)
                    if self.second_stream_ahead:
                        state.lookahead_queued.extend(
                            state.get_tokens_ahead(self.second_stream_ahead))
                    state.remaining_padding = self.max_padding
                else:
                    token = ids.pad
                state.forced_padding = entry.padding
            else:
                token = ids.pad
                if self.second_stream_ahead and state.end_step is None:
                    token = ids.new_word
                if state.end_step is None:
                    state.end_step = step

        if token == ids.pad:
            if state.remaining_padding > 0:
                state.remaining_padding -= 1
            if state.forced_padding > 0:
                state.forced_padding -= 1
            output = state.queued.popleft() if state.queued else ids.pad
        elif token == ids.new_word:
            output = ids.new_word
        else:
            raise RuntimeError(f"invalid token {token}")

        if self.second_stream_ahead:
            second = -1
            if output == ids.new_word:
                second = ids.new_word
                output = state.queued.popleft() if state.queued else ids.pad
            elif state.lookahead_queued:
                second = state.lookahead_queued.popleft()
            output = (second + 1) * ids.card + output
        return output, consumed_new_word


def script_to_entries(tokenizer, token_ids: TokenIds, frame_rate: float,
                      script: tp.Sequence[str], multi_speaker: bool = True,
                      padding_between: int = 0) -> list[Entry]:
    """Tokenize a script (one string per speaker turn) into word entries: a
    speaker token before each turn's first word, `<break time="Ns"/>` as an
    empty entry of N s of padding."""
    from ..text.tts_preprocess import normalize

    speaker_tokens = [token_ids.main, token_ids.other]
    last_speaker = None
    entries: list[Entry] = []
    event_re = re.compile(r"(?:<break\s+time=\"([0-9]+(?:.[0-9]*)?)s\"\s*/?>)|(?:\s+)")
    first_content = True

    def add_entry(idx: int, word: str):
        nonlocal first_content, last_speaker
        tokens = list(tokenizer.encode(word))
        if first_content:
            speaker = idx % len(speaker_tokens)
            if multi_speaker and last_speaker != speaker:
                last_speaker = speaker
                tokens.insert(0, speaker_tokens[speaker])
            first_content = False
        padding = max(0, padding_between + len(tokens) - 1) if padding_between > 0 else 0
        entries.append(Entry(tokens=tokens, text=word, padding=padding))

    for idx, line in enumerate(script):
        first_content = True
        line = normalize(line)
        while line:
            match = event_re.search(line)
            if match is None:
                break
            word, line = line[:match.start()], line[match.end():]
            if word:
                add_entry(idx, word)
            if match.group(1):
                entries.append(Entry(tokens=[], text="",
                                     padding=int(round(float(match.group(1)) * frame_rate))))
        if line:
            add_entry(idx, line)
    return entries


@dataclass
class TTSResult:
    frames: list          # np arrays [B, 1 + dep_q, 1] (undelayed)
    logged_text_tokens: list
    end_steps: list
    all_consumption_times: list
    all_transcripts: list


class TTSModel:
    def __init__(self, lm, mimi, tokenizer, machine: StateMachine, delay_steps: int,
                 condition_provider=None, fuser=None,
                 max_speakers: int = DEFAULT_MAX_SPEAKERS, temp: float = 0.6,
                 cfg_coef: float = 1.0, final_padding: int = 4, n_q: int = 32,
                 max_gen_length: int = 30_000, padding_bonus: float = 0.0,
                 voice_suffix: str = "", voice_repo: str | None = None,
                 voice_aliases: dict | None = None):
        self.lm, self.mimi = lm, mimi
        self.tokenizer = tokenizer
        self.machine = machine
        self.delay_steps = delay_steps
        self.condition_provider, self.fuser = condition_provider, fuser
        self.max_speakers = max_speakers
        self.temp = temp
        self.cfg_coef = cfg_coef
        self.final_padding = final_padding
        self.n_q = min(n_q, lm.config.dep_q)
        self.max_gen_length = max_gen_length
        self.padding_bonus = padding_bonus
        self.voice_suffix, self.voice_repo = voice_suffix, voice_repo
        # logical name -> file (the reference worker's `voices` table)
        self.voice_aliases = dict(voice_aliases or {})

    @property
    def frame_rate(self) -> float:
        return self.mimi.config.frame_rate

    @property
    def multi_speaker(self) -> bool:
        return (self.condition_provider is not None
                and "speaker_wavs" in self.condition_provider.conditioners)

    @property
    def valid_cfg_conditionings(self) -> set:
        """The CFG coefficients a CFG-distilled model takes as its `cfg`
        condition (empty otherwise)."""
        if self.condition_provider is not None and "cfg" in self.condition_provider.conditioners:
            cond = self.condition_provider.conditioners["cfg"]
            if cond.possible_values is not None:
                return set(float(x) for x in cond.possible_values)
        return set()

    def prepare_script(self, script: tp.Sequence[str], padding_between: int = 0) -> list[Entry]:
        return script_to_entries(self.tokenizer, self.machine.token_ids, self.frame_rate,
                                 script, multi_speaker=self.multi_speaker,
                                 padding_between=padding_between)

    def make_condition_attributes(self, voice_embeddings: list,
                                  cfg_coef: float | None = None) -> ConditionAttributes:
        """voice_embeddings: arrays [1, T, D] (a voice file's `speaker_wavs`),
        at most max_speakers of them, each in its own block of T frames of
        the [1, max_speakers * T, D] condition (empty blocks masked)."""
        tensors = {}
        if voice_embeddings:
            first = np.asarray(voice_embeddings[0])
            T, D = first.shape[1], first.shape[-1]
            voice = np.zeros((1, self.max_speakers, T, D), np.float32)
            mask = np.zeros((1, self.max_speakers, T), bool)
            for i, emb in enumerate(voice_embeddings[:self.max_speakers]):
                emb = np.asarray(emb)
                voice[:, i, :emb.shape[1]] = emb[0]
                mask[:, i, :emb.shape[1]] = True
            tensors["speaker_wavs"] = TensorCondition(voice.reshape(1, -1, D),
                                                      mask.reshape(1, -1))
        text: dict = {"control": "ok"}
        if self.condition_provider is not None and "cfg" in self.condition_provider.conditioners:
            if cfg_coef is None:
                text["cfg"] = None
            else:
                if cfg_coef not in self.valid_cfg_conditionings:
                    raise ValueError(f"cfg_coef {cfg_coef} not in "
                                     f"{sorted(self.valid_cfg_conditionings)}")
                text["cfg"] = format(cfg_coef, ".1f")
        return ConditionAttributes(text=text, tensor=tensors)

    def get_voice_path(self, voice_name: str):
        """The local file of a voice name (moshi_tpu tts.py:290-296): an
        alias's file, else `voice_name + voice_suffix`, each a path that
        exists as it is, an `hf://` name, or a name inside `voice_repo`
        (fetched from the hub when that is not a local directory)."""
        from .loaders import hf_get

        name = self.voice_aliases.get(voice_name, voice_name + self.voice_suffix)
        return hf_get(name, self.voice_repo, check_local_file_exists=True)

    @staticmethod
    def load_voice_embedding(path) -> np.ndarray:
        """One speaker embedding [1, T, D] from a voice .safetensors file
        (its `speaker_wavs`, stored [1, D, T])."""
        from ..utils.safetensors import load_file
        emb = load_file(path)["speaker_wavs"].float().numpy()
        return np.transpose(emb, (0, 2, 1))

    def get_prefix(self, mimi_params, wav: np.ndarray) -> np.ndarray:
        """Codes [1 + n_q, T - 2] of a voice's audio prefix wav [T] (float
        PCM): the offline Mimi encode on the device and in the dtype of
        mimi_params, trimmed to the LM's n_q codebooks and the last two
        frames dropped (moshi_tpu tts.py:308-320).  Rows the codec lacks
        stay UNGENERATED_TOKEN (sampled, not forced), and a ZERO_TOKEN text
        row goes on top: generate's `prefixes` take it as it is."""
        emb = mimi_params["quantizer"]["rvq_first"]["embedding"]
        x = torch.as_tensor(np.asarray(wav, np.float32)).to(emb.device, emb.dtype)
        codes = self.mimi.encode(mimi_params, x[None, None])
        n_q = self.lm.config.n_q
        avail = codes[0, :n_q, :-2].cpu().numpy()
        prefix = np.full((n_q, avail.shape[1]), UNGENERATED_TOKEN, np.int64)
        prefix[:avail.shape[0]] = avail
        null_text = np.full((1, prefix.shape[1]), ZERO_TOKEN, np.int64)
        return np.concatenate([null_text, prefix], axis=0)

    def conditions(self, attributes, condition_params, use_cfg: bool):
        """(condition_sum [B_model, 1, dim] or None, cross source [B_model,
        Ts, dim] or None) of a batch of attributes, their null variants
        after them under CFG (generate's and the batched engine's)."""
        if attributes is None or self.condition_provider is None:
            return None, None
        attributes = list(attributes)
        if use_cfg:
            attributes = attributes + dropout_all_conditions(attributes)
        if condition_params is None:
            raise ValueError("conditioning attributes need condition_params")
        tensors = self.condition_provider.prepare_and_provide(condition_params, attributes)
        if self.fuser is None:
            return None, None
        return self.fuser.get_sum(tensors), self.fuser.get_cross(tensors)

    # ---------------------------------------------------------------- generate
    def generate(self, params: dict, all_entries: tp.Sequence[tp.Sequence[Entry]],
                 attributes: tp.Sequence[ConditionAttributes] | None = None,
                 condition_params: dict | None = None,
                 prefixes: list[np.ndarray] | None = None,
                 cfg_is_no_prefix: bool = True, cfg_is_no_text: bool = True,
                 generator: torch.Generator | None = None,
                 on_frame: tp.Callable | None = None) -> TTSResult:
        """Generate every script of `all_entries` together, frame by frame,
        eagerly on the device of `params`, until each has ended and its
        audio has caught up.  prefixes: per item, codes [1 + n_q, T] (text
        row first) forced as the first T frames.  Draws come from
        `generator` (a new one seeded 0 by default)."""
        lm = self.lm
        c = lm.config
        B = len(all_entries)
        ids = self.machine.token_ids
        dev = params["text_emb"]["weight"].device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        use_cfg = self.cfg_coef != 1.0
        condition_sum, condition_cross = self.conditions(attributes, condition_params, use_cfg)

        states = [self.machine.new_state(e) for e in all_entries]
        logged_text_tokens: list[list] = [[] for _ in states]
        cfg_masked_until = text_prefixes = audio_prefixes = None
        if prefixes is not None:
            if len(prefixes) != B:
                raise ValueError(f"{len(prefixes)} prefixes for {B} scripts")
            if cfg_is_no_prefix:
                cfg_masked_until = torch.tensor([p.shape[-1] + self.delay_steps
                                                 for p in prefixes], device=dev)
            text_prefixes = [deque(np.asarray(p)[0].tolist()) for p in prefixes]
            audio_prefixes = []
            delays = [d + self.delay_steps for d in c.delays[c.audio_offset:]]
            for p in prefixes:
                K, T = p.shape
                if K != c.num_codebooks:
                    raise ValueError(f"a prefix of {K} rows for {c.num_codebooks} codebooks")
                out = np.full((K - 1, T + max(delays)), ids.ungenerated, np.int64)
                for k, d in enumerate(delays):
                    out[k, d:d + T] = np.asarray(p)[k + 1]
                audio_prefixes.append(deque(out.T))

        gen = LMGen(lm, LMGenConfig(
            use_sampling=True, temp=self.temp, temp_text=self.temp, cfg_coef=self.cfg_coef,
            cfg_is_no_text=cfg_is_no_text and use_cfg,
            cfg_is_masked_until=cfg_masked_until is not None,
            padding_bonus=self.padding_bonus))
        gstate = gen.init_state(B, generator, torch.bfloat16, dev)  # as the JAX package's
        if condition_cross is not None:
            gen.init_cross_state(gstate, params, condition_cross)

        missing = c.num_codebooks - c.dep_q - 1
        input_tokens = torch.full((B, max(missing, 1), 1), ids.zero, dtype=torch.long,
                                  device=dev)
        no_dep = torch.full((B, c.dep_q, 1), ids.zero, dtype=torch.long, device=dev)
        gen_delays = np.asarray(c.delays[c.audio_offset:c.audio_offset + c.dep_q])

        frames: list[np.ndarray] = []
        for offset in range(self.max_gen_length):
            if all(s.end_step is not None for s in states):
                max_end = max(s.end_step for s in states)
                if offset >= max_end + self.delay_steps + self.final_padding:
                    break
            text_token, _, h = gen.main_step(params, gstate, input_tokens, None,
                                             condition_sum, cfg_masked_until)
            out_tokens = []
            for b, (tok, st) in enumerate(zip(text_token.tolist(), states)):
                if text_prefixes is not None and text_prefixes[b]:
                    out_tok = text_prefixes[b].popleft()
                else:
                    out_tok, _ = self.machine.process(offset, st, tok)
                out_tokens.append(out_tok)
                logged_text_tokens[b].append((tok, out_tok))
            zero_mask = torch.from_numpy(offset < gen_delays + self.delay_steps).to(dev)
            forced = None
            if audio_prefixes is not None:
                fa = np.full((B, c.dep_q), ids.ungenerated, np.int64)
                for b, ap in enumerate(audio_prefixes):
                    if ap:
                        fa[b] = ap.popleft()[:c.dep_q]
                forced = torch.from_numpy(fa).to(dev)
            out = gen.depth_step(params, gstate, torch.tensor(out_tokens, device=dev), h,
                                 None, no_dep if offset < self.delay_steps else None,
                                 zero_mask, forced)
            out_np = out.cpu().numpy()
            if (out_np != UNGENERATED_TOKEN).any():
                frames.append(out_np)
                if on_frame is not None:
                    on_frame(out_np)
        return TTSResult(frames, logged_text_tokens, [s.end_step for s in states],
                         [s.consumption_times for s in states],
                         [s.transcript for s in states])

    def synthesize_pcm(self, params: dict, mimi_params: dict, result: TTSResult,
                       prefix_length_frames: list[int] | None = None) -> list[np.ndarray]:
        """Decode a TTSResult's frames into each item's PCM, from its prefix's
        end to its script's end."""
        if not result.frames:
            return []
        B = result.frames[0].shape[0]
        md = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        dev = mimi_params["quantizer"]["rvq_first"]["embedding"].device
        dec_state = self.mimi.init_decode_state(B, md, dev)
        pcms = []
        for frame in result.frames[self.delay_steps:]:
            codes = torch.from_numpy(frame[:, 1:self.n_q + 1]).to(dev).clamp(min=0)
            pcm, _ = self.mimi.decode_step(mimi_params, dec_state, codes)
            pcms.append(np.clip(pcm.float().cpu().numpy(), -1, 1))
        pcms = pcms[2:]
        out = []
        for b in range(B):
            start = 0 if prefix_length_frames is None else prefix_length_frames[b]
            chunks = [p[b, 0] for p in pcms[start:result.end_steps[b]]]
            out.append(np.concatenate(chunks) if chunks else np.zeros((0,), np.float32))
        return out

    # ---------------------------------------------------------- simple API
    def simple_generate(self, params: dict, mimi_params: dict, text, voice,
                        cfg_coef: float = 2.0, condition_params: dict | None = None,
                        generator: torch.Generator | None = None,
                        on_frame: tp.Callable | None = None) -> list[np.ndarray]:
        """PCM for text(s) in voice(s), which broadcast against each other:
        a single item repeats to match a list, two lists pair up.  A voice of
        a speaker-conditioned model is an embedding array [1, T, D], a path
        to a voice .safetensors file, or a voice name (get_voice_path); an
        audio-prefix model's is `file://path.wav`, read at the Mimi's rate,
        encoded by get_prefix and forced as the first frames.  Returns one
        1-D float32 array per (text, voice) pair."""
        many_texts, many_voices = isinstance(text, list), isinstance(voice, list)
        if many_texts and many_voices:
            if len(text) != len(voice):
                raise ValueError(f"Number of texts and voices must match, got "
                                 f"{len(text)} != {len(voice)}")
            if not text:
                raise ValueError("Got empty list, nothing to generate")
            texts, voices = text, voice
        elif many_texts:
            texts, voices = text, [voice] * len(text)
        elif many_voices:
            texts, voices = [text] * len(voice), voice
        else:
            texts, voices = [text], [voice]
        entries_batch = [self.prepare_script([t], padding_between=1) for t in texts]
        distilled = bool(self.valid_cfg_conditionings)
        if not distilled:
            # a model without CFG distillation takes the coefficient directly
            self.cfg_coef = cfg_coef
        attributes, prefixes = None, None
        if self.multi_speaker:
            embeddings = []
            for v in voices:
                if isinstance(v, str) or hasattr(v, "__fspath__"):
                    path = (v if str(v).endswith(".safetensors")
                            else self.get_voice_path(str(v)))
                    embeddings.append(self.load_voice_embedding(path))
                else:
                    embeddings.append(np.asarray(v))
            attributes = [self.make_condition_attributes([e], cfg_coef if distilled else None)
                          for e in embeddings]
            starts = [0] * len(texts)
        else:
            from ..audio import read_wav
            prefixes = []
            for v in voices:
                if not str(v).startswith("file://"):
                    raise ValueError("this model is conditioned by an audio prefix: pass "
                                     f"voices as file://path.wav, got {v!r}")
                wav, _ = read_wav(str(v).removeprefix("file://"), self.mimi.config.sample_rate)
                prefixes.append(self.get_prefix(mimi_params, wav[0]))
            starts = [p.shape[-1] for p in prefixes]
        result = self.generate(params, entries_batch, attributes=attributes,
                               condition_params=condition_params, prefixes=prefixes,
                               generator=generator, on_frame=on_frame)
        return self.synthesize_pcm(params, mimi_params, result, starts)
