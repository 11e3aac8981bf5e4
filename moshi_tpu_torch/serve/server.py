"""The full-duplex websocket server (counterpart of moshi_tpu/serve/server.py):
one session at a time over `/api/chat`, in the reference's binary protocol
(serve/protocol.py), each 80 ms frame Mimi encode -> LMGen.step -> Mimi
decode on the card.

    python -m moshi_tpu_torch.serve.server --checkpoint-dir DIR [--device cuda]

`main` reads the checkpoint through `CheckpointInfo` (config.json, native
or PyTorch-named weights, the SentencePiece tokenizer), warms up and
serves.  A session opens with the handshake (MT 0), then takes ogg-opus
audio (MT 1) or, after the client's `{"raw_pcm": true}` metadata, raw f32
PCM frames (MT 10), and answers with audio in the same form and text
pieces (MT 2, or MT 7 with a confidence colour).  Its first frame only
primes the encoder (the reference's first-frame skip).  Controls pause
(input discarded), start and restart (a fresh session in place, answered
with `{"event": "restarted"}`) are honoured, pings answered, and an error
from the client ends the session.  Query parameters set the session's
sampling (`_SESSION_PARAMS`), its seed (`text_seed`, `audio_seed`) and
`max_steps`; a client that passes any of them also gets the effective
config echoed (MT 4) and, while it waits in the FIFO queue for the one
session, its queue position (MT 4, once a second).

Session resume (opt-in with the `resume_support` or `resume` query
parameter): the session's config echo carries a `resume_id`; at
disconnect the whole streaming state (the codec's states, the ring KV,
the delay cache, the generator's seed and offset) is copied on the card
and kept on the host for `--resume-ttl` seconds, and a client that comes
back with `?resume=<id>` continues where it left off, its first frame not
skipped.  A restore writes the state into the buffers the captured graphs
read, in place.  With `--vault URL` and `--fleet-auth`, the same snapshot
also goes to the fleet dispatcher's vault (serve/dispatcher.py), a live
session replicates there every `--replicate-every` frames, and a resume
that finds nothing here pulls it from there: a session of a worker that
died resumes on another one.  A replication copies the state on the card
between two frames and moves that copy to the host on a stream of its
own, then streams it to the vault from a worker thread.

`--log-dir` writes each session's tokens (`text_tokens` [T] and
`audio_tokens` [dep_q, T], int32) as a safetensors file there.  MT 8
carries image embeddings [T, kv_dim] for the vision presets: their
cross-attention K/V are written into the state (in place when a buffer of
that shape exists, so the captured step with the cross block keeps
reading it) and the server answers `{"image": "ok", "frames": T}`.
`QueueAPI` is the reference web client's HTTP queue (`/add_user`,
`/check_user`, `/user_feedback`) over this server's session lock, and
`--ssl CERT_DIR` serves https/wss.

The session loop reads an async iterator of binary payloads and writes
through a `send` coroutine, so the same code runs under aiohttp
(`handle_chat`) and under an in-process transport; only `handle_chat`,
`make_app` and `main` import aiohttp, when called.

Not ported yet: `--tp` (ROADMAP A.13b).
"""

import argparse
import asyncio
import gc
import json
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..models.lm import UNGENERATED_TOKEN
from ..models.lm_gen import LMGen, LMGenConfig
from ..utils.graphs import GraphedStep
from ..utils.quantize import QTensor, QTensor4
from ..utils.trees import copy_into, map_tensors
from . import protocol as proto
from .metrics import CONNECT_COUNT, OPEN_CHANNELS
from .snapshots import (SnapshotStore, host_copy, new_resume_id, pinned_like, same_layout,
                        vault_pull, vault_push, wants_resume)

CROSS_KEYS = ("k_cross", "v_cross")


def log(level: str, msg: str):
    print(f"[{level}] {msg}", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, (QTensor, QTensor4)):
        return [tree.q, tree.scale]
    return [tree]


class _SessionGen:
    """An LMGen with its streaming state and its (graphed) steps, which
    write the step's tokens, and the text token's probability when
    `colored`, into the engine's output buffers: `step` without
    cross-attention K/V in the state, `step_cross` with them (captured
    apart: a graph runs the blocks its capture saw)."""

    def __init__(self, lm_gen: LMGen, state: dict, lm_params: dict, out: torch.Tensor,
                 prob: torch.Tensor, colored: bool, graphed: bool, device,
                 generator: torch.Generator):
        self.lm_gen, self.state, self.lm_params = lm_gen, state, lm_params
        self.out, self.prob, self.colored = out, prob, colored
        self.step = GraphedStep(self._step, graphed=graphed, device=device,
                                generators=(generator,))
        self.step_cross = GraphedStep(self._step, graphed=graphed, device=device,
                                      generators=(generator,))

    def _step(self, codes):
        if self.colored:
            out, prob, _ = self.lm_gen.step_with_text_prob(self.lm_params, self.state, codes)
            self.prob.copy_(prob)
        else:
            out, _ = self.lm_gen.step(self.lm_params, self.state, codes)
        self.out.copy_(out)
        return self.out


class _LazyOpus:
    """The opus codec's stream object, made at first use: raw-PCM sessions
    never load the codec."""

    def __init__(self, kind: str, rate: int):
        self._kind, self._rate, self._inst = kind, rate, None

    def __getattr__(self, name):
        if self._inst is None:
            from .. import native
            self._inst = getattr(native.load(), self._kind)(self._rate)
        return getattr(self._inst, name)


class ServerState:
    """One model, B = 1 streaming state on `device`, one session at a time.
    The codec runs in the dtype of its parameters; the KV cache is bf16, as
    in the JAX server.

    The frame runs as the JAX server's three programs: Mimi encode,
    LMGen.step, and Mimi decode (skipped while the LM's output is still
    UNGENERATED_TOKEN).  `graphed` (the default on a CUDA device) captures
    each as a CUDA graph at its first frame after `warmup()` and replays
    it at every frame after; the state, the generator and the PCM input
    buffer are allocated once and written in place.  `graphed=False` runs
    the same functions eagerly (the CPU's only path).

    Each set of session sampling overrides gets its own LMGen and captured
    step, made (and warmed) the first time a session asks for it and kept
    for later ones; they share the temporal transformer's state, the
    generator and the output buffers that the decode graph reads.

    `log_dir` keeps each session's token log there; `vault_url` and
    `fleet_auth` turn on the fleet vault, which a live session replicates
    to every `replicate_every` frames."""

    def __init__(self, mimi, mimi_params, lm, lm_params, *, info=None, text_tokenizer=None,
                 cfg_coef: float = 1.0, device="cuda", rng_seed: int = 0,
                 graphed: bool | None = None, session_timeout: float = 360.0,
                 log_dir: str | None = None, vault_url: str | None = None,
                 fleet_auth: str | None = None, replicate_every: int = 125,
                 **lm_gen_kwargs):
        self.info = info
        self.mimi, self.mimi_params = mimi, mimi_params
        self.lm, self.lm_params = lm, lm_params
        self.text_tokenizer = text_tokenizer
        self.device = dev = torch.device(device)
        self.graphed = dev.type == "cuda" if graphed is None else graphed
        if self.graphed and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        for t in _leaves(lm_params) + _leaves(mimi_params):
            if t.device.type != dev.type:
                raise ValueError(f"a parameter lies on {t.device}, the server on {dev}")
        self.mimi_dtype = md = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        self.frame_size = mimi.frame_size
        merged = dict(lm_gen_kwargs)
        merged.setdefault("cfg_coef", cfg_coef)
        # confidence-coloured text (MT 7): the default for hibiki checkpoints
        self.colored_text = bool(merged.pop(
            "colored_text", info is not None and info.model_type == "hibiki"))
        self.session_seed = self.rng_seed = rng_seed
        self.session_timeout = session_timeout
        self.max_steps = 4500
        self.generator = torch.Generator(device=dev)
        self.enc_state = mimi.init_encode_state(1, md, dev)
        self.dec_state = mimi.init_decode_state(1, md, dev)
        self.pcm_in = torch.zeros(self.frame_size, dtype=torch.float32, device=dev)
        self.tokens_out = torch.zeros((1, 1 + lm.config.dep_q, 1), dtype=torch.long,
                                      device=dev)
        self.prob_out = torch.zeros(1, dtype=torch.float32, device=dev)
        self.encode = GraphedStep(self._encode, graphed=self.graphed, device=dev)
        self.decode = GraphedStep(self._decode, graphed=self.graphed, device=dev)
        default = LMGen(lm, LMGenConfig.from_dict(merged))
        self._gens = {(): self._make_gen(default, None)}
        self._gen = self._gens[()]
        self.session_tokens: list[np.ndarray] = []
        self.log_dir = log_dir
        self.lock = asyncio.Lock()
        # session ids in arrival order: asyncio.Lock wakes its waiters in
        # FIFO order, so a session's index is its queue position
        self._session_order: list[int] = []
        self._session_counter = 0
        # cross-attention K/V buffers [.., B_model, T, H, D]: kept while no
        # image is set, so a later image of T frames is written in place
        self._cross: dict | None = None
        # session resume: snapshots kept here, and the fleet vault
        self._snapshots = SnapshotStore(ttl=60.0, cap=4)
        self._resume_id: str | None = None
        self._session_overrides: dict = {}
        self.vault_url = vault_url.rstrip("/") if vault_url else None
        self.fleet_auth = fleet_auth
        self.replicate_every = replicate_every
        self._push_task = None
        self._copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        # pinned host buffers a snapshot is copied into from the card, and
        # the lock of their reader (a push streams from them)
        self._staging = None
        self._staging_lock = threading.Lock()
        # one entry per finished vault push: rid, steps, bytes, seconds
        self.pushes: list[dict] = []
        self.reset()

    @property
    def resume_ttl(self) -> float:
        return self._snapshots.ttl

    @resume_ttl.setter
    def resume_ttl(self, v: float):
        self._snapshots.ttl = v

    # the active session's LMGen, state and step
    @property
    def lm_gen(self) -> LMGen:
        return self._gen.lm_gen

    @property
    def gen_state(self) -> dict:
        return self._gen.state

    @property
    def step(self) -> GraphedStep:
        """The step the next frame runs: with the cross block while the
        state holds an image's K/V."""
        gen = self._gen
        return gen.step_cross if CROSS_KEYS[0] in gen.state["transformer"] else gen.step

    def _make_gen(self, lm_gen: LMGen, shared: _SessionGen | None) -> _SessionGen:
        state = lm_gen.init_state(1, self.generator, torch.bfloat16, self.device)
        if shared is not None:
            state["transformer"] = shared.state["transformer"]
        return _SessionGen(lm_gen, state, self.lm_params, self.tokens_out, self.prob_out,
                           self.colored_text, self.graphed, self.device, self.generator)

    def _encode(self, pcm):
        codes, _ = self.mimi.encode_step(self.mimi_params, self.enc_state,
                                         pcm.to(self.mimi_dtype)[None, None])
        return codes

    def _decode(self, out):
        pcm, _ = self.mimi.decode_step(self.mimi_params, self.dec_state,
                                       out[:, 1:].clamp(min=0))
        return pcm[0, 0].float()

    # ------------------------------------------------------- session config
    # query parameter -> (LMGenConfig field, parser), the reference client's
    # names
    _SESSION_PARAMS = {
        "text_temperature": ("temp_text", float),
        "text_topk": ("top_k_text", int),
        "audio_temperature": ("temp", float),
        "audio_topk": ("top_k", int),
        "pad_mult": ("padding_bonus", float),
        "repetition_penalty": ("text_rep_penalty", float),
        "repetition_penalty_context": ("text_rep_context", int),
    }
    # any of these marks a client that knows this server: it gets the
    # config echo and queue positions (a bare reference client sees the
    # handshake first)
    _KNOWN_PARAMS = (set(_SESSION_PARAMS) |
                     {"text_seed", "audio_seed", "max_steps", "resume", "resume_support"})

    def apply_session_config(self, query) -> dict:
        """Select (or make) the LMGen for the session's sampling overrides
        in `query` (str -> str; unknown keys and unparsable values are
        ignored), fold `text_seed` / `audio_seed` into the session seed and
        set `max_steps`.  Returns the effective config, the metadata
        echo."""
        overrides = {}
        for name, (field, parse) in self._SESSION_PARAMS.items():
            if name in query:
                try:
                    overrides[field] = parse(query[name])
                except ValueError:
                    pass
        seed = self.rng_seed
        for name in ("text_seed", "audio_seed"):
            if name in query:
                try:
                    # one generator draws text and audio: both seeds fold in
                    seed = (seed * 1000003 + int(query[name])) & 0x7FFFFFFF
                except ValueError:
                    pass
        self.session_seed = seed
        try:
            self.max_steps = min(4500, int(query.get("max_steps", 4500)))
        except ValueError:
            self.max_steps = 4500
        self._session_overrides = dict(overrides)
        self._gen = self._gen_for_overrides(overrides)
        return self._session_cfg_dict()

    def _gen_for_overrides(self, overrides: dict) -> _SessionGen:
        """The memoized LMGen and step of an override set, over the
        server's default config, warmed up when new (the caller resets)."""
        key = tuple(sorted(overrides.items()))
        if key not in self._gens:
            default = self._gens[()]
            gen = self._make_gen(LMGen(self.lm, replace(default.lm_gen.gc, **overrides)),
                                 default)
            codes = torch.zeros((1, gen.lm_gen.num_input_audio, 1), dtype=torch.long,
                                device=self.device)
            for _ in range(2):
                gen.step.warm_up(codes)
            if self.lm.config.cross_attention:
                self._warm_cross(gen, codes)
            self._gens[key] = gen
            log("info", f"made session config {overrides}")
        return self._gens[key]

    def _session_cfg_dict(self) -> dict:
        c = self.lm_gen.gc
        return {"text_temperature": c.temp_text, "text_topk": c.top_k_text,
                "audio_temperature": c.temp, "audio_topk": c.top_k,
                "pad_mult": c.padding_bonus, "repetition_penalty": c.text_rep_penalty,
                "repetition_penalty_context": c.text_rep_context,
                "max_steps": self.max_steps, "seed": self.session_seed}

    # --------------------------------------------------------------- frames
    def reset(self):
        """A fresh session: the streaming states rewritten in place with the
        values of new ones (no image), the generator reseeded with
        `session_seed`.  No tensor moves, so captured graphs stay valid."""
        dev, md = self.device, self.mimi_dtype
        self._set_cross(None)
        copy_into(self.enc_state, self.mimi.init_encode_state(1, md, dev))
        copy_into(self.dec_state, self.mimi.init_decode_state(1, md, dev))
        copy_into(self.gen_state, self.lm_gen.init_state(1, None, torch.bfloat16, dev))
        self.generator.manual_seed(self.session_seed)
        self.steps_done = 0
        self.session_tokens = []

    def reset_encoder(self):
        copy_into(self.enc_state, self.mimi.init_encode_state(1, self.mimi_dtype, self.device))

    def warmup(self):
        """Run zero frames eagerly through the whole path (decode included:
        max_delay + 2 frames, at least 4), on the graphs' side streams when
        graphed, then reset.  A graphed engine needs it before its first
        frame."""
        for _ in range(max(4, self.lm.config.max_delay + 2)):
            self._frame(np.zeros(self.frame_size, np.float32), warm=True)
        if self.lm.config.cross_attention:
            self._warm_cross(self._gen, torch.zeros(
                (1, self.lm_gen.num_input_audio, 1), dtype=torch.long, device=self.device))
        self.reset()
        if self.vault_url and self.fleet_auth and self._copy_stream is not None:
            # pinned memory is slow to allocate: before serving, not at a push
            self._staging = pinned_like(self._snapshot_view())

    def _warm_cross(self, gen: _SessionGen, codes: torch.Tensor):
        """Warm `gen`'s step with the cross block up, over the K/V of a
        one-frame zero image (the caller resets)."""
        kv_dim = self.lm.config.cross_attention_kv_dim or self.lm.config.dim
        self.set_image_embeddings(np.zeros((1, kv_dim), np.float32), gen)
        gen.step_cross.warm_up(codes)

    def capture(self):
        """Capture the three graphs now (zero frames until one is decoded),
        then reset: a server whose card other engines' threads use captures
        nothing while serving its default config.  Eager engines do
        nothing."""
        if self.graphed:
            for _ in range(self.lm.config.max_delay + 2):
                self.step_frame(np.zeros(self.frame_size, np.float32))
            self.reset()

    def skip_frame(self, chunk: np.ndarray):
        """The session's first frame: encoded, then the encoder reset, so
        the next frame sees the encoder's left padding again (the
        reference's first-frame skip)."""
        self.pcm_in.copy_(torch.as_tensor(chunk, dtype=torch.float32))
        self.encode(self.pcm_in)
        self.reset_encoder()

    def step_frame(self, chunk: np.ndarray):
        """One 80 ms frame of PCM [frame_size] -> (pcm [frame_size] float32
        or None, text token or None).  Nothing is decoded while the LM's
        output is still UNGENERATED_TOKEN (the first max_delay frames)."""
        return self._frame(chunk, warm=False)[:2]

    def _frame(self, chunk, warm: bool):
        """-> (pcm or None, text token or None, its probability or None)."""
        def run(step, *args):
            return step.warm_up(*args) if warm else step(*args)

        self.steps_done += 1
        self.pcm_in.copy_(torch.as_tensor(chunk, dtype=torch.float32))
        out = run(self.step, run(self.encode, self.pcm_in))
        out_np = out.cpu().numpy().copy()  # a copy: out is the step's output buffer
        if (out_np == UNGENERATED_TOKEN).any():
            if not warm:
                self._maybe_replicate()
            return None, None, None
        prob = float(self.prob_out.cpu()) if self.colored_text else None
        self.session_tokens.append(out_np[0, :, 0])
        pcm = run(self.decode, out).cpu().numpy()
        if not warm:
            self._maybe_replicate()
        return pcm, int(out_np[0, 0, 0]), prob

    # ---------------------------------------------------------------- images
    def set_image_embeddings(self, emb: np.ndarray, gen: _SessionGen | None = None):
        """Image embeddings [T, kv_dim] (the MT 8 path of the vision presets)
        -> the cross-attention K/V of the state, computed eagerly and
        written into the buffers of the last image of T frames (the step
        captured with them keeps reading them); another T makes new
        buffers, and the steps with the cross block capture again."""
        if not self.lm.config.cross_attention:
            raise ValueError("model has no cross-attention")
        gen = gen or self._gen
        src = torch.from_numpy(np.array(emb, np.float32)).to(self.device)[None]
        if gen.lm_gen.model_batch_mult == 2:
            src = src.repeat(2, 1, 1)
        tr = gen.state["transformer"]
        for k in CROSS_KEYS:
            tr.pop(k, None)
        if self._cross is not None and self._cross["k_cross"].shape[-4:-2] == src.shape[:2]:
            tr.update(self._cross)
        gen.lm_gen.init_cross_state(gen.state, self.lm_params, src)
        if self._cross is None or tr["k_cross"] is not self._cross["k_cross"]:
            self._cross = {k: tr[k] for k in CROSS_KEYS}
            for g in (*self._gens.values(), gen):
                g.step_cross.recapture()

    def _set_cross(self, cross: dict | None):
        """The state's cross K/V: none (`cross` None), or `cross`'s values
        written into the buffers of their shape."""
        tr = self.gen_state["transformer"]
        for k in CROSS_KEYS:
            tr.pop(k, None)
        if cross is None:
            return
        if self._cross is None or self._cross["k_cross"].shape != cross["k_cross"].shape:
            self._cross = {k: torch.empty_like(cross[k], device=self.device) for k in CROSS_KEYS}
            for g in self._gens.values():
                g.step_cross.recapture()
        copy_into(self._cross, cross)
        tr.update(self._cross)

    # -------------------------------------------------------- session logs
    def save_session_log(self):
        """The session's token log (moshi-server/src/lm.rs:256-290) in
        `log_dir`: `text_tokens` [T] and `audio_tokens` [dep_q, T], int32,
        as the JAX server writes them.  Clears the tokens."""
        tokens, self.session_tokens = self.session_tokens, []
        if not self.log_dir or not tokens:
            return
        from ..utils.safetensors import save_file
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        t = torch.from_numpy(np.stack(tokens).astype(np.int32))  # [T, 1 + dep_q]
        stem = f"session-{int(time.time())}"
        path = Path(self.log_dir) / f"{stem}.safetensors"
        n = 0
        while path.exists():  # two sessions in one second
            n += 1
            path = Path(self.log_dir) / f"{stem}-{n}.safetensors"
        save_file({"text_tokens": t[:, 0].contiguous(),
                   "audio_tokens": t[:, 1:].T.contiguous()}, path)
        log("info", f"saved session log to {path}")

    # --------------------------------------------------------------- resume
    def _vault_meta(self) -> dict:
        return {"steps": self.steps_done, "max_steps": self.max_steps,
                "overrides": self._session_overrides, "seed": self.session_seed}

    def _snapshot_view(self) -> dict:
        """The session's state as a snapshot's tree (the live tensors, the
        generator's state as "rng")."""
        gen = {k: v for k, v in self.gen_state.items() if k != "generator"}
        return {"enc": self.enc_state, "dec": self.dec_state, "gen": gen,
                "rng": self.generator.get_state()}

    def _state_copy(self):
        """(copies of the session's state, made on the card in the order of
        its frames; an event recorded after them on a CUDA device, else
        None).  The next frame overwrites the live buffers in place, never
        these."""
        copies = map_tensors(self._snapshot_view(), torch.clone)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return copies, ready

    def _staged(self, copies, ready):
        """The copies on the host: on a CUDA device in the pinned staging
        buffers (made again when the state's layout changed), valid while
        the caller holds `_staging_lock`."""
        if self._copy_stream is None:
            return host_copy(copies)
        if not same_layout(self._staging, copies):
            self._staging = pinned_like(copies)
        return host_copy(copies, ready, self._copy_stream, self._staging)

    def _host(self, copies, ready):
        """The copies on the host, in memory of their own."""
        with self._staging_lock:
            return map_tensors(self._staged(copies, ready), torch.clone)

    def _push(self, rid: str, arrays, meta: dict, t0: float):
        """Stream a host snapshot to the vault (on a worker thread); log and
        record it, with the seconds since `t0` (its copy on the card) in all
        and those of the stream to the vault."""
        t1 = time.perf_counter()
        try:
            nbytes = vault_push(self.vault_url, rid, self.fleet_auth, arrays, meta)
        except Exception as e:
            log("warning", f"vault push {rid} failed: {e}")
            return
        seconds, sent = time.perf_counter() - t0, time.perf_counter() - t1
        self.pushes.append({"rid": rid, "steps": meta["steps"], "bytes": nbytes,
                            "seconds": seconds, "send_seconds": sent})
        log("info", f"vault push {rid}: step {meta['steps']}, {nbytes} bytes in "
                    f"{seconds:.3f} s ({sent:.3f} s to the vault)")

    def _store_snapshot(self):
        """At a session's end (on the event loop): a snapshot of the session
        under the resume id it was given, kept here and pushed to the vault
        (so the client may come back on another worker)."""
        rid, self._resume_id = self._resume_id, None
        vault = bool(self.vault_url and self.fleet_auth)
        if rid is None or (self._snapshots.ttl <= 0 and not vault):
            return
        t0 = time.perf_counter()
        copies, ready = self._state_copy()
        meta = self._vault_meta()
        self._snapshots.reserve(rid)  # a quick reconnect waits in take()

        async def offload():
            host = await asyncio.to_thread(self._host, copies, ready)
            self._snapshots.put(rid, host, meta)
            if vault:
                await asyncio.to_thread(self._push, rid, host, meta, t0)

        self._push_task = asyncio.ensure_future(offload())

    def _maybe_replicate(self):
        """Every `replicate_every` frames of a session with a resume id (a
        session of the event loop's), push a snapshot to the vault: copied
        on the card now (before the next frame's kernels), moved to the
        host and streamed off the event loop.  Skipped while the last push
        is still going."""
        if (self._resume_id is None or not (self.vault_url and self.fleet_auth)
                or not self.replicate_every or self.steps_done % self.replicate_every):
            return
        if self._push_task is not None and not self._push_task.done():
            return
        t0 = time.perf_counter()
        copies, ready = self._state_copy()
        rid, meta = self._resume_id, self._vault_meta()
        log("info", f"vault push {rid}: step {meta['steps']} started")

        def push():
            with self._staging_lock:
                self._push(rid, self._staged(copies, ready), meta, t0)

        self._push_task = asyncio.ensure_future(asyncio.to_thread(push))

    async def _take_snapshot(self, rid: str | None):
        """(host tree, meta) of the snapshot under `rid`, here or else in
        the vault; None.  One-shot."""
        item = await self._snapshots.take(rid)
        if item is None and rid and self.vault_url and self.fleet_auth:
            try:
                item = await asyncio.to_thread(vault_pull, self.vault_url, rid, self.fleet_auth)
            except Exception as e:
                log("warning", f"vault pull {rid} failed: {e}")
            if item is not None:
                log("info", f"session {rid} migrated in from the fleet vault "
                            f"(step {item[1]['steps']})")
        return item

    def _resume(self, item, query: dict) -> dict:
        """Continue the session of a snapshot: its override set (or the
        query's, which wins) and its state, written in place into that set's
        buffers.  Returns the session config."""
        arrays, meta = item
        if set(self._SESSION_PARAMS) & set(query):
            session_cfg = self.apply_session_config(query)
        else:
            self._session_overrides = dict(meta.get("overrides") or {})
            self._gen = self._gen_for_overrides(self._session_overrides)
            self.max_steps = int(meta["max_steps"])
            self.session_seed = int(meta.get("seed", self.session_seed))
            session_cfg = self._session_cfg_dict()
        self._restore(arrays)
        self.steps_done = int(meta["steps"])
        return session_cfg

    def _restore(self, arrays):
        """Write a snapshot's tree into the live state, in place.  The
        repetition-penalty history carries over when the session's set keeps
        one of the same width, else starts empty."""
        snap = dict(arrays["gen"])
        live = {k: v for k, v in self.gen_state.items() if k != "generator"}
        hist = ("text_history", "hist_pos")
        snap_hist = {k: snap.pop(k) for k in hist if k in snap}
        live_hist = {k: live.pop(k) for k in hist if k in live}
        snap["transformer"] = dict(snap["transformer"])
        cross = {k: snap["transformer"].pop(k) for k in CROSS_KEYS if k in snap["transformer"]}
        self._set_cross(None)
        copy_into(live, snap)
        self._set_cross(cross or None)
        if live_hist:
            if (snap_hist and snap_hist["text_history"].shape
                    == live_hist["text_history"].shape):
                copy_into(live_hist, snap_hist)
            else:
                live_hist["text_history"].fill_(-1)
                live_hist["hist_pos"].zero_()
        copy_into(self.enc_state, arrays["enc"])
        copy_into(self.dec_state, arrays["dec"])
        self.generator.set_state(arrays["rng"])

    # -------------------------------------------------------------- sessions
    def _text_msg(self, token: int, prob: float | None) -> bytes | None:
        """MT 2 text, or MT 7 with a colour byte (0-10) first; None for the
        pad tokens and without a tokenizer."""
        if token in (0, 3) or self.text_tokenizer is None:
            return None
        text = self.text_tokenizer.id_to_piece(token).replace("▁", " ").encode("utf-8")
        if prob is None:
            return proto.msg(proto.MT_TEXT, text)
        return proto.msg(proto.MT_COLOREDTEXT, bytes([max(0, min(10, round(prob * 10)))]) + text)

    async def run_session(self, query: dict, messages, send, closed=lambda: False):
        """Queue for the session lock, then serve one session.  `messages`
        is an async iterator of the client's binary payloads, `send` a
        coroutine that sends one, `closed()` true once the client is
        gone."""
        CONNECT_COUNT.inc()
        sid = self._session_counter
        self._session_counter += 1
        self._session_order.append(sid)
        notify = bool(self._KNOWN_PARAMS & set(query))
        if not await self._acquire_session(sid, notify, send, closed):
            return
        OPEN_CHANNELS.inc()
        try:
            await self._serve_session(query, messages, send)
        finally:
            OPEN_CHANNELS.dec()
            self._session_order.remove(sid)
            self.lock.release()

    async def _acquire_session(self, sid: int, notify: bool, send, closed) -> bool:
        """FIFO-acquire the session lock, sending the queue position (MT 4)
        once a second to a client that opted in.  False, without the lock,
        when the client leaves while queued."""
        acquire = asyncio.ensure_future(self.lock.acquire())
        try:
            while not acquire.done():
                pos = self._session_order.index(sid)
                if pos > 0 and notify:
                    await send(proto.msg(proto.MT_METADATA, json.dumps(
                        {"status": "wait", "queue_position": pos}).encode()))
                if closed():
                    raise ConnectionResetError("the client closed its socket")
                await asyncio.wait({acquire}, timeout=1.0)
            return True
        except (ConnectionError, RuntimeError, asyncio.CancelledError) as e:
            # a failed send or a closed socket: the client is gone
            acquire.cancel()
            try:
                await acquire
            except asyncio.CancelledError:
                pass
            else:  # the lock came before the cancellation
                self.lock.release()
            self._session_order.remove(sid)
            log("info", f"queued client {sid} left")
            if isinstance(e, asyncio.CancelledError):
                raise
            return False

    async def _serve_session(self, query: dict, messages, send):
        item = await self._take_snapshot(query.get("resume"))
        resumed = item is not None
        if resumed:
            session_cfg = self._resume(item, query)
            log("info", f"session resumed at step {self.steps_done}")
        else:
            session_cfg = self.apply_session_config(query)
            self.reset()
        # only a client that opted in learns a resume id: a snapshot for
        # any other would only push real users' entries out of the store
        self._resume_id = new_resume_id() if wants_resume(query) else None
        if self._resume_id is not None:
            session_cfg["resume_id"] = self._resume_id
        session_cfg["resumed"] = resumed
        await send(proto.handshake())
        if self._KNOWN_PARAMS & set(query):
            await send(proto.msg(proto.MT_METADATA, json.dumps(session_cfg).encode()))
        try:
            await asyncio.wait_for(self._recv_loop(messages, send, 0 if resumed else 1),
                                   timeout=self.session_timeout)
        except asyncio.TimeoutError:
            # a policy end: a resume must not outlive the session timeout
            self._resume_id = None
            log("info", "session timeout")
        finally:
            self._store_snapshot()
            self.save_session_log()
            log("info", "connection closed")

    async def _recv_loop(self, messages, send, skip_frames: int = 1):
        """Serve the session's messages until the client goes, sends an
        error, or the session reaches max_steps."""
        rate = self.mimi.config.sample_rate
        opus_reader = _LazyOpus("OpusStreamReader", rate)
        opus_writer = _LazyOpus("OpusStreamWriter", rate)
        all_pcm = np.zeros((0,), np.float32)
        paused = raw_pcm = False
        async for data in messages:
            if not data:
                continue
            kind = data[0]
            if kind == proto.MT_PCM and raw_pcm:
                pcm = np.frombuffer(data[1:len(data) - (len(data) - 1) % 4], np.float32)
            elif kind == proto.MT_AUDIO:
                pcm = np.frombuffer(opus_reader.append_bytes(data[1:]), np.float32)
            else:
                if kind == proto.MT_CONTROL and len(data) >= 2:
                    ctrl = data[1]
                    log("info", f"control: {proto.CONTROL_NAMES.get(ctrl, ctrl)}")
                    if ctrl == proto.CTRL_PAUSE:
                        paused = True
                        all_pcm = np.zeros((0,), np.float32)
                    elif ctrl == proto.CTRL_START:
                        paused = False
                    elif ctrl == proto.CTRL_RESTART:
                        self.save_session_log()
                        self.reset()
                        all_pcm = np.zeros((0,), np.float32)
                        skip_frames, paused = 1, False
                        await send(proto.msg(proto.MT_METADATA,
                                             json.dumps({"event": "restarted"}).encode()))
                elif kind == proto.MT_METADATA:
                    try:
                        meta = json.loads(data[1:].decode("utf-8"))
                    except (UnicodeDecodeError, json.JSONDecodeError):
                        meta = None
                    if isinstance(meta, dict) and meta.get("raw_pcm"):
                        raw_pcm = True
                        await send(proto.msg(proto.MT_METADATA, json.dumps(
                            {"raw_pcm": True, "sample_rate": rate,
                             "frame_size": self.frame_size}).encode()))
                    log("info", f"client metadata: {meta}")
                elif kind == proto.MT_ERROR:
                    log("error", f"client error: {data[1:].decode('utf-8', 'replace')}")
                    return
                elif kind == proto.MT_PING:
                    await send(proto.msg(proto.MT_PING))
                elif kind == proto.MT_IMAGE:
                    await send(self._image_msg(data))
                # other types (endTurn, unknown ones) are discarded
                continue
            if paused or pcm.size == 0:
                continue  # a paused session's opus is still decoded, in step
            all_pcm = np.concatenate([all_pcm, pcm])
            while all_pcm.shape[-1] >= self.frame_size:
                chunk, all_pcm = all_pcm[:self.frame_size], all_pcm[self.frame_size:]
                if skip_frames:
                    self.skip_frame(chunk)
                    skip_frames -= 1
                    continue
                out_pcm, token, prob = self._frame(chunk, warm=False)
                if self.steps_done >= self.max_steps:
                    log("info", f"max_steps {self.max_steps} reached")
                    self._resume_id = None  # a terminal end: no snapshot
                    return
                if out_pcm is None:
                    continue
                if raw_pcm:
                    await send(proto.msg(proto.MT_PCM,
                                         np.ascontiguousarray(out_pcm, np.float32).tobytes()))
                else:
                    opus = opus_writer.append_pcm(np.ascontiguousarray(out_pcm, np.float32))
                    if opus:
                        await send(proto.msg(proto.MT_AUDIO, opus))
                text = self._text_msg(token, prob)
                if text is not None:
                    await send(text)

    def _image_msg(self, data: bytes) -> bytes:
        """MT 8 (u32 T, u32 kv_dim, f32le [T, kv_dim]; protocol.rs:40) ->
        the embeddings set, and the reply: MT 4 {"image": "ok", "frames":
        T}, or MT 5 with the error."""
        import struct
        try:
            t, dim = struct.unpack("<II", data[1:9])
            emb = np.frombuffer(data[9:9 + 4 * t * dim], "<f4").reshape(t, dim)
            self.set_image_embeddings(emb)
        except (ValueError, struct.error) as e:
            return proto.msg(proto.MT_ERROR, str(e).encode())
        return proto.msg(proto.MT_METADATA, json.dumps({"image": "ok", "frames": t}).encode())

    async def handle_chat(self, request):
        """aiohttp handler of `/api/chat`."""
        from aiohttp import WSMsgType, web

        ws = web.WebSocketResponse()
        await ws.prepare(request)
        log("info", "accepted connection")

        async def messages():
            async for message in ws:
                if message.type in (WSMsgType.ERROR, WSMsgType.CLOSED):
                    return
                if message.type == WSMsgType.BINARY and message.data:
                    yield message.data

        await self.run_session(dict(request.rel_url.query), messages(), ws.send_bytes,
                               lambda: ws.closed)
        await ws.close()
        return ws


def serve_sessions(state: ServerState, seeds, frames: int):
    """Serve one session per seed, each of `frames` frames of noise PCM
    drawn from that seed and sampled with a generator of that seed, without
    a transport.  Returns, per session, (tokens [generated frames, 1 +
    dep_q], pcm frames, ms per frame)."""
    results = []
    for seed in seeds:
        pcm = (0.1 * np.random.RandomState(seed).randn(frames, state.frame_size)
               ).astype(np.float32)
        state.session_seed = seed
        state.reset()
        audio, ms = [], []
        for f in range(frames):
            t0 = time.perf_counter()
            out_pcm, _ = state.step_frame(pcm[f])
            ms.append((time.perf_counter() - t0) * 1e3)
            if out_pcm is not None:
                audio.append(out_pcm)
        width = 1 + state.lm.config.dep_q
        tokens = np.array(state.session_tokens, dtype=np.int64).reshape(-1, width)
        results.append((tokens, audio, ms))
    return results


class QueueAPI:
    """The HTTP session queue of the moshi.chat demo service that the
    reference web client polls (client/src/pages/Queue/api/client.ts,
    validators.ts), over this server's session lock: `GET
    /add_user?queue_id=` -> {session_id, session_auth_id}; `GET
    /check_user?session_id=&session_auth_id=` -> {session_id, status
    "wait" | "ready", worker_auth_id, worker_addr, current_position}; `GET
    /user_feedback` -> an ack.  A ticket is ready when every earlier one is
    gone (a ticket expires `ttl` seconds after its last poll) and the lock
    is free.  The queue is the fleet dispatcher's TicketQueue."""

    def __init__(self, state: ServerState, worker_addr: str, ttl: float = 30.0):
        from .dispatcher import TicketQueue
        self.state = state
        self.worker_addr = worker_addr
        self.queue = TicketQueue(ttl)

    async def add_user(self, request):
        from aiohttp import web
        out = self.queue.add()
        log("info", f"queue: ticket {out['session_id']} issued "
                    f"(queue_id={request.rel_url.query.get('queue_id')})")
        return web.json_response(out)

    async def check_user(self, request):
        from aiohttp import web
        q = request.rel_url.query
        try:
            sid = int(q.get("session_id", ""))
        except ValueError:
            return web.Response(status=400, text="bad session_id")
        out = self.queue.check(
            sid, q.get("session_auth_id"),
            lambda: None if self.state.lock.locked() else self.worker_addr)
        if out is None:
            return web.Response(status=404, text="unknown session")
        return web.json_response(out)

    async def user_feedback(self, request):
        from aiohttp import web
        log("info", f"user_feedback: {dict(request.rel_url.query)}")
        return web.json_response({"ok": True})

    def add_routes(self, app):
        app.router.add_get("/add_user", self.add_user)
        app.router.add_get("/check_user", self.check_user)
        app.router.add_get("/user_feedback", self.user_feedback)


def make_app(state: ServerState, static: str | None = None, queue_addr: str | None = None):
    """The aiohttp application: `/api/chat`, the queue API handing out
    `queue_addr` when given, and the web client's files from `static` at
    `/`."""
    from aiohttp import web

    app = web.Application()
    app.router.add_get("/api/chat", state.handle_chat)
    if queue_addr:
        QueueAPI(state, queue_addr).add_routes(app)
    if static:
        async def index(_):
            return web.FileResponse(Path(static) / "index.html")

        app.router.add_get("/", index)
        app.router.add_static("/", path=static, follow_symlinks=True, name="static")
    return app


def load_state(checkpoint_dir, device="cuda", cfg_coef: float = 1.0,
               kv_cache: str | None = None, session_timeout: float = 360.0,
               **server_kw) -> ServerState:
    """A ServerState over the checkpoint in `checkpoint_dir`, its weights
    on `device`.  `cfg_coef` other than 1 wins over the checkpoint's
    lm_gen_config; `kv_cache` overrides the KV cache dtype; `server_kw`
    (log_dir, vault_url, fleet_auth, replicate_every) go to ServerState."""
    from ..models.lm import LMModel
    from ..models.loaders import CheckpointInfo

    info = CheckpointInfo.from_dir(checkpoint_dir)
    log("info", "loading mimi")
    mimi, mimi_params = info.get_mimi(device=device)
    log("info", "loading moshi")
    lm, lm_params = info.get_moshi(device=device)
    if kv_cache:
        lm = LMModel(replace(lm.config, kv_cache_dtype=kv_cache))
    tokenizer = info.get_text_tokenizer()
    gen_cfg = dict(info.lm_gen_config)
    ckpt_cfg_coef = gen_cfg.pop("cfg_coef", 1.0)
    return ServerState(mimi, mimi_params, lm, lm_params, info=info, text_tokenizer=tokenizer,
                       cfg_coef=cfg_coef if cfg_coef != 1.0 else ckpt_cfg_coef,
                       device=device, session_timeout=session_timeout,
                       **server_kw, **gen_cfg)


def main(argv=None):
    from aiohttp import web

    from ..utils.serving import serving_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", default=8998, type=int)
    ap.add_argument("--checkpoint-dir", required=True,
                    help="directory with config.json, the weights and the tokenizer")
    ap.add_argument("--cfg-coef", type=float, default=1.0)
    ap.add_argument("--static", default=None, help="the web client's directory")
    ap.add_argument("--session-timeout", type=float, default=360.0)
    ap.add_argument("--kv-cache", default=None, choices=["model", "int8", "int4"],
                    help="the temporal transformer's KV cache dtype")
    ap.add_argument("--log-dir", default=None,
                    help="save each session's tokens there (safetensors)")
    ap.add_argument("--advertised-addr", default=None,
                    help="the ws address the queue API hands to clients (default: from "
                         "--host / --port, wrong behind NAT or a 0.0.0.0 bind)")
    ap.add_argument("--resume-ttl", type=float, default=60.0,
                    help="seconds a closed session stays resumable with ?resume=<resume_id> "
                         "(0 turns resume off here)")
    ap.add_argument("--vault", default=None, metavar="URL",
                    help="the fleet dispatcher's base URL: live sessions replicate their "
                         "snapshots there and a resume falls back to it")
    ap.add_argument("--fleet-auth", default=None, help="the vault's shared secret")
    ap.add_argument("--replicate-every", type=int, default=125,
                    help="frames between a live session's pushes to the vault (125: 10 s)")
    ap.add_argument("--ssl", metavar="CERT_DIR", default=None,
                    help="serve https/wss; makes a self-signed certificate in CERT_DIR if "
                         "none is there")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ways over several cards (not ported: ROADMAP A.13b)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tp:
        raise NotImplementedError("--tp is not ported yet (ROADMAP A.13b, tensor-parallel serving)")
    device = serving_device(args.device)
    state = load_state(args.checkpoint_dir, device, args.cfg_coef, args.kv_cache,
                       args.session_timeout, log_dir=args.log_dir, vault_url=args.vault,
                       fleet_auth=args.fleet_auth, replicate_every=args.replicate_every)
    state.resume_ttl = args.resume_ttl
    log("info", "warming up")
    state.warmup()
    # what the warm-up made lives as long as the server: keep the cycle
    # collector off it (a full pass costs 100s of ms in a frame)
    gc.freeze()
    ssl_context = None
    if args.ssl:
        from .worker import make_ssl_context
        ssl_context = make_ssl_context(args.ssl)
    scheme = "wss" if ssl_context else "ws"
    addr = args.advertised_addr or f"{scheme}://{args.host}:{args.port}/api/chat"
    log("info", f"serving at {'https' if ssl_context else 'http'}://{args.host}:{args.port}")
    web.run_app(make_app(state, args.static, addr), host=args.host, port=args.port,
                ssl_context=ssl_context)


if __name__ == "__main__":
    main()
