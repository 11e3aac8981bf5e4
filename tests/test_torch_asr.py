"""The port's speech-to-text path against moshi_tpu's, on the CPU in f32:
the `delay` continuous conditioner and `asr_sum_condition`, StreamingASR
over joins, freezes and a reset with the model-dtype and the int8 KV cache
(greedy text tokens, Word/EndWord/Step messages with the words' text, and
the protocol payloads the batched servers send for them), and the batched
engine of serve/batched_asr.py (markers, the backlog cap, the outboxes)."""

import copy
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu import conditioners as jcond
from moshi_tpu.models import asr as jasr
from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.serve import batched_asr as jbatched
from moshi_tpu.text import SentencePieceTokenizer as JTokenizer
from moshi_tpu_torch import conditioners as tcond
from moshi_tpu_torch.models import asr as tasr
from moshi_tpu_torch.models.lm import LMModel as TLM, lm_config_asr_300m_202501
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.serve.batched_asr import BatchedAsrState, serve_asr
from moshi_tpu_torch.text import SentencePieceTokenizer as TTokenizer
from moshi_tpu_torch.utils.params import from_jax
from test_lm import tiny_lm_config
from test_mimi import tiny_mimi_config
from test_torch_int4_kv import _bytes_equal
from test_torch_port import max_abs, port_lm_config, port_mimi_config

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_tiny_checkpoint import spm_model_bytes  # noqa: E402

B = 3
DELAY = 2           # asr_delay_in_tokens
COND_TOL = 1e-6     # f32 sin/cos embedding and one product
PRS_TOL = 1e-5      # f32 extra-head softmax after the whole temporal stack
STATE_TOL = 1e-5    # f32 Mimi and KV state, accumulation order only (test_torch_transformer.py)
# tick -> (slots reset before the frame, exec mask): slot 2 joins at tick 4
# (frozen at offset 0 before it), slot 1 freezes on ticks 7-9, slot 0
# starts a second session at tick 13
TICKS = 22
RESETS = {4: [2], 13: [0]}


def _mask(t):
    return np.array([True, not 7 <= t <= 9, t >= 4])


def test_continuous_conditioner_matches_jax():
    """Sinusoidal embedding, projection and learnt padding for a None
    value, on the same parameters, within 1e-6."""
    jc = jcond.ContinuousAttributeConditioner(output_dim=12, dim=8, scale_factor=0.5,
                                              max_period=100.0)
    tc = tcond.ContinuousAttributeConditioner(output_dim=12, dim=8, scale_factor=0.5,
                                              max_period=100.0)
    params = jc.init_params(jax.random.PRNGKey(0))
    values = [-2.5, None, 0.75]
    jout, jmask = jc.apply(params, jc.prepare(values))
    tout, tmask = tc.apply(from_jax(jax.device_get(params)), tc.prepare(values))
    assert tout.shape == (3, 1, 12)
    assert max_abs(tout.numpy(), jout) <= COND_TOL
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    tparams = tc.init_params(torch.Generator().manual_seed(0))
    assert tparams["output_proj"].shape == (8, 12)
    assert tparams["learnt_padding"].shape == (1, 1, 12)


def _providers(dim):
    jc = jcond.ContinuousAttributeConditioner(output_dim=dim, dim=4, scale_factor=1.0,
                                              max_period=10.0)
    params = {"delay": jc.init_params(jax.random.PRNGKey(1))}
    tc = tcond.ContinuousAttributeConditioner(output_dim=dim, dim=4, scale_factor=1.0,
                                              max_period=10.0)
    return (jcond.ConditionProvider({"delay": jc}), params,
            tcond.ConditionProvider({"delay": tc}), from_jax(jax.device_get(params)))


def test_asr_sum_condition_matches_jax():
    """The delay value is fed negated, the learnt padding on request, and the
    reference server's contract holds: a model with a `delay` conditioner
    takes exactly one of the two, a model without one takes neither."""
    dim = 8
    jprov, jparams, tprov, tparams = _providers(dim)

    class Info:
        def __init__(self, provider, params):
            self.provider, self.params = provider, params

        def get_conditioners(self, output_dim):
            return self.provider, None, self.params

    with_delay, without = Info(jprov, jparams), Info(None, None)
    for kw in ({"conditioning_delay": 0.5}, {"learnt_padding": True}):
        want = jasr.asr_sum_condition(with_delay, dim, **kw)
        got = tasr.asr_sum_condition(tprov, tparams, dim, **kw)
        assert got.shape == (1, 1, dim)
        assert max_abs(got.numpy(), want) <= COND_TOL
    assert tasr.asr_sum_condition(None, None, dim) is None
    assert jasr.asr_sum_condition(without, dim) is None
    for jinfo, prov, params, kw in (
            (with_delay, tprov, tparams, {"conditioning_delay": 1.0,
                                          "learnt_padding": True}),   # both set
            (with_delay, tprov, tparams, {}),                          # nothing set
            (without, None, None, {"conditioning_delay": 1.0})):       # nothing to set
        with pytest.raises(ValueError):
            jasr.asr_sum_condition(jinfo, dim, **kw)
        with pytest.raises(ValueError):
            tasr.asr_sum_condition(prov, params, dim, **kw)


def _engines(kv, tokenizer_path=None):
    """The same tiny dep_q = 0 model (two extra heads, a text head pushed
    toward the pad tokens so that words end) and tiny Mimi in both
    packages, f32, with a delay condition; with `tokenizer_path`, each
    engine decodes words with its own package's tokenizer of that file."""
    cfg = tiny_lm_config(n_q=4, dep_q=0, delays=(0,) * 5, extra_heads_num_heads=2,
                         extra_heads_dim=2, kv_cache_dtype=kv, context=16)
    jlm, jmimi = JLM(cfg), JMimi(tiny_mimi_config())
    lm_params = jlm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    w = np.array(lm_params["text_linear"]["weight"])
    w[:, [0, 3]] *= 1.3
    lm_params["text_linear"]["weight"] = jnp.asarray(w)
    mimi_params = jmimi.init_params(jax.random.PRNGKey(1))
    jprov, jparams, tprov, tparams = _providers(cfg.dim)
    # the condition at a fifth of its size: at full size it pins this tiny
    # model's text stream to one token
    jcond_vec = 0.2 * jprov.conditioners["delay"].apply(
        jparams["delay"], jprov.conditioners["delay"].prepare([-0.5]))[0]
    jtok = None if tokenizer_path is None else JTokenizer(tokenizer_path)
    ttok = None if tokenizer_path is None else TTokenizer(tokenizer_path)
    jengine = jasr.StreamingASR(jmimi, jlm, B, asr_delay_in_tokens=DELAY, temperature=0.0,
                                text_tokenizer=jtok, sum_condition=jcond_vec)
    tmcfg = port_mimi_config(tiny_mimi_config())
    tengine = tasr.StreamingASR(
        TMimi(tmcfg), TLM(port_lm_config(cfg)), B, asr_delay_in_tokens=DELAY,
        temperature=0.0, text_tokenizer=ttok, device="cpu",
        sum_condition=0.2 * tasr.asr_sum_condition(tprov, tparams, cfg.dim,
                                                   conditioning_delay=0.5))
    return (jengine, lm_params, mimi_params, tengine, from_jax(jax.device_get(lm_params)),
            from_jax(jax.device_get(mimi_params), mimi_config=tmcfg))


def _pcm(frame_size):
    rs = np.random.RandomState(0)
    return (0.3 * rs.randn(TICKS, B, 1, frame_size)).astype(np.float32)


def _same_messages(tm, jm, mask):
    assert [type(m).__name__ for m in tm] == [type(m).__name__ for m in jm]
    for a, b in zip(tm, jm):
        if isinstance(b, jasr.AsrStep):
            assert a.step_idx == b.step_idx
            assert max_abs(a.prs[:, mask], np.asarray(b.prs)[:, mask]) <= PRS_TOL
        elif isinstance(b, jasr.AsrWord):
            assert (a.tokens, a.start_time, a.batch_idx, a.text) == (
                b.tokens, b.start_time, b.batch_idx, b.text)
        else:
            assert (a.stop_time, a.batch_idx) == (b.stop_time, b.batch_idx)


class _Outbox:
    """Stands in for a BatchedAsrState when its `_dispatch` (moshi_tpu's or
    the port's, called unbound) turns engine messages into protocol
    payloads: every slot is open, no audio is buffered."""

    def __init__(self):
        self.slot_queues = dict.fromkeys(range(B))
        self.slot_pcm = {}
        self.sent = []

    def _send(self, slot, payload):
        self.sent.append((slot, payload))


def _same_payloads(tbox, jbox):
    """The port's payloads equal moshi_tpu's key for key: Word (with its
    "text") and EndWord exactly, Step up to the f32 probabilities."""
    assert [(s, p["type"]) for s, p in tbox.sent] == [(s, p["type"]) for s, p in jbox.sent]
    for (_, a), (_, b) in zip(tbox.sent, jbox.sent):
        assert a.keys() == b.keys()
        if a["type"] == "Step":
            assert (a["step_idx"], a["buffered_pcm"]) == (b["step_idx"], b["buffered_pcm"])
            assert max_abs(np.array(a["prs"]), np.array(b["prs"])) <= PRS_TOL
        else:
            assert a == b


def _play(jeng, jlp, jmp, teng, tlp, tmp, on_frame=lambda mask, jm, tm, tstate: None):
    """Step both engines over the TICKS frames of the join/freeze/reset
    schedule, calling on_frame(mask, moshi_tpu's messages, the port's, the
    port's state) after each.  Returns the last (moshi_tpu state, port
    state)."""
    jstate = jeng.init_state(jax.random.PRNGKey(0), jnp.float32)
    tstate = teng.init_state(None, torch.float32)
    for t, pcm in enumerate(_pcm(teng.mimi.frame_size)):
        for slot in RESETS.get(t, []):
            jstate = jeng.reset_batch_idx(jstate, slot)
            tstate = teng.reset_batch_idx(tstate, slot)
        mask = _mask(t)
        jm, jstate = jeng.step_pcm(jmp, jlp, jstate, pcm, exec_mask=mask)
        tm, tstate = teng.step_pcm(tmp, tlp, tstate, pcm, exec_mask=mask)
        on_frame(mask, jm, tm, tstate)
    return jstate, tstate


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_streaming_asr_matches_jax(kv, tmp_path):
    """22 frames at B = 3 with a late join, a freeze and a reset: every
    executing slot's greedy text token and every Word/EndWord/Step message
    (times and the decoded word text included) equal moshi_tpu's, and so do
    the protocol payloads the two batched servers make of them."""
    tokenizer = tmp_path / "tokenizer.model"
    tokenizer.write_bytes(spm_model_bytes(tiny_lm_config().text_card))
    jeng, jlp, jmp, teng, tlp, tmp = _engines(kv, tokenizer)
    counts = {"words": 0, "ends": 0}
    tbox, jbox = _Outbox(), _Outbox()

    def on_frame(mask, jm, tm, tstate):
        if kv == "int8":
            assert tstate["transformer"]["k"].dtype == torch.int8
        assert ([i.text_token for i in teng.items] == [i.text_token for i in jeng.items])
        assert [i.step_idx for i in teng.items] == [i.step_idx for i in jeng.items]
        _same_messages(tm, jm, mask)
        for m in tm:
            BatchedAsrState._dispatch(tbox, m, mask)
        for m in jm:
            jbatched.BatchedAsrState._dispatch(jbox, m, mask)
        counts["words"] += sum(isinstance(m, tasr.AsrWord) and m.text.startswith("w")
                               for m in tm)
        counts["ends"] += sum(isinstance(m, tasr.AsrEndWord) for m in tm)
    _play(jeng, jlp, jmp, teng, tlp, tmp, on_frame)
    assert teng.model_step_idx == jeng.model_step_idx == TICKS
    assert counts["words"] >= 3 and counts["ends"] >= 3
    _same_payloads(tbox, jbox)


def _tree_items(tree, prefix=()):
    """(key path, leaf) pairs of a state tree, sorted by path."""
    if isinstance(tree, dict):
        return sorted(kv for k, v in tree.items() for kv in _tree_items(v, prefix + (k,)))
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _tree_items(v, prefix + (i,))]
    return [(prefix, tree)]


def _same_rows(trows, jrows):
    """The port's device rows of one slot against moshi_tpu's: integer and
    bool leaves (offsets, int8 KV bytes) equal, bf16 (the int8 KV scales)
    byte for byte, f32 (Mimi's conv and KV state, a model-dtype KV cache)
    within STATE_TOL."""
    titems, jitems = _tree_items(trows), _tree_items(jrows)
    assert [k for k, _ in titems] == [k for k, _ in jitems]
    for (key, t), (_, j) in zip(titems, jitems):
        assert tuple(t.shape) == j.shape, key
        if t.dtype == torch.bfloat16:
            assert _bytes_equal(t, j), key
        elif t.dtype == torch.float32:
            assert max_abs(t.numpy(), j) <= STATE_TOL, key
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(key))


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_extracted_rows_match_jax(kv):
    """After the join/freeze/reset schedule, every slot's rows from the
    port's extract_slot_arrays equal moshi_tpu's: the int8 caches' bytes
    and scales exactly, the f32 state within STATE_TOL."""
    jeng, jlp, jmp, teng, tlp, tmp = _engines(kv)
    jstate, tstate = _play(jeng, jlp, jmp, teng, tlp, tmp)
    for slot in range(B):
        rows = teng.extract_slot_arrays(tstate, slot)
        assert rows[1]["k"].dtype == (torch.int8 if kv == "int8" else torch.float32)
        _same_rows(rows, jeng.extract_slot_arrays(jstate, slot))


def _port_engine(kv="int8"):
    _, _, _, teng, tlp, tmp = _engines(kv)
    return teng, tlp, tmp


def test_serve_asr_matches_the_engine():
    """serve_asr over a join/send schedule gives, per session, the text
    tokens of the same frames stepped on StreamingASR by hand; each executed
    frame puts one Step per executing slot in its outbox, and the Word and
    EndWord payloads carry the engine's times."""
    teng, tlp, tmp = _port_engine()
    fs = teng.mimi.frame_size
    pcm = _pcm(fs)
    frames = {s: pcm[:, s, 0] for s in range(B)}
    schedule = []
    for t in range(TICKS):
        mask = _mask(t)
        tick = {s: "send" for s in range(B) if mask[s]}
        for s in RESETS.get(t, []):
            tick[s] = "join"
        if t == 0:
            tick.update({0: "join", 1: "join"})
        schedule.append(tick)
    sessions, ms = serve_asr(BatchedAsrState(teng, tmp, tlp), schedule, frames)
    assert len(ms) == TICKS and all(m > 0 for m in ms)
    assert [len(s) for s in sessions.values()] == [2, 1, 1]

    ref = _port_engine()[0]
    state = ref.init_state(None)
    taken = dict.fromkeys(range(B), 0)
    tokens = {s: [] for s in range(B)}
    words = {s: [] for s in range(B)}
    for tick in schedule:
        chunk = np.zeros((B, 1, fs), np.float32)
        mask = np.zeros(B, bool)
        for s, action in tick.items():
            if action == "join":
                state = ref.reset_batch_idx(state, s)
                tokens[s].append([])
                words[s].append([])
            chunk[s, 0] = frames[s][taken[s]]
            taken[s] += 1
            mask[s] = True
        msgs, state = ref.step_pcm(tmp, tlp, state, chunk, mask)
        for s in np.nonzero(mask)[0]:
            tokens[s][-1].append(ref.items[s].text_token)
        for m in msgs:
            if isinstance(m, tasr.AsrWord):
                words[m.batch_idx][-1].append({"type": "Word", "text": "",
                                               "start_time": m.start_time})
            elif isinstance(m, tasr.AsrEndWord):
                words[m.batch_idx][-1].append({"type": "EndWord", "stop_time": m.stop_time})
    for s in range(B):
        for i, (toks, msgs) in enumerate(sessions[s]):
            np.testing.assert_array_equal(toks, tokens[s][i])
            steps = [m for m in msgs if m["type"] == "Step"]
            assert len(steps) == len(toks)
            assert all(len(m["prs"]) == 2 and m["buffered_pcm"] == 0 for m in steps)
            assert [m for m in msgs if m["type"] != "Step"] == words[s][i]


def test_markers_and_backlog_cap():
    """A marker comes back at the tick where the model step reaches
    registration step + delay + the frames buffered then; a backlog past
    30 s of audio is cut to exactly the cap."""
    teng, tlp, tmp = _port_engine()
    fs = teng.mimi.frame_size
    state = BatchedAsrState(teng, tmp, tlp)
    assert state.open_slot(1) == 1 and state.open_slot() == 2
    rs = np.random.RandomState(5)
    assert state.feed_pcm(1, (0.3 * rs.randn(3 * fs)).astype(np.float32))
    state.add_marker(1, 42)
    assert state.slot_markers[1] == [(DELAY + 3, 42)]
    seen_at = None
    for tick in range(8):
        if tick >= 3:
            state.feed_pcm(1, (0.3 * rs.randn(fs)).astype(np.float32))
        assert state.tick() is not None
        if {"type": "Marker", "id": 42} in state.slot_outbox[1]:
            seen_at = seen_at if seen_at is not None else teng.model_step_idx
    assert seen_at == DELAY + 3
    assert state.tick() is None           # slot 1 has no whole frame left, slot 2 none
    cap = int(30.0 * teng.mimi.config.sample_rate)
    assert state.feed_pcm(2, np.zeros(cap - fs, np.float32))
    assert not state.feed_pcm(2, np.zeros(3 * fs, np.float32))
    assert state.slot_pcm[2].shape == (cap,)
    state.close_slot(2)
    assert 2 in state.slots_free and 2 not in state.slot_outbox


def _resume_script(frame_size):
    """tests/test_asr_serving.py's resume scenario as a serve_asr schedule at
    B = 3: slots 2 (unbroken) and 1 send the same 5 frames; slot 1's
    session leaves (tick 5); a new tenant joins slot 1 and sends 2 frames of
    its own while slot 2 waits; the session resumes on slot 0 (tick 8) and
    sends the last 5 frames beside slot 2."""
    rs = np.random.RandomState(3)
    stream = (0.3 * rs.randn(10, frame_size)).astype(np.float32)
    tenant = (0.3 * rs.randn(2, frame_size)).astype(np.float32)
    schedule = ([{2: "join", 1: "join"}] + [{2: "send", 1: "send"}] * 4
                + [{1: "leave"}, {1: "join"}, {1: "send"}, {2: "send", 0: ("resume", 1)}]
                + [{2: "send", 0: "send"}] * 4)
    frames = {2: stream, 1: np.concatenate([stream[:5], tenant]), 0: stream[5:]}
    return schedule, frames


def _serve_jax(jeng, jlp, jmp, schedule, frames):
    """serve_asr's schedule played on moshi_tpu's StreamingASR by hand: a
    "leave" extracts the slot's rows and copies its word state, a resume
    restores both into the new slot.  Returns sessions as serve_asr does."""
    jstate = jeng.init_state(jax.random.PRNGKey(0), jnp.float32)
    taken, snaps = dict.fromkeys(frames, 0), {}
    sessions = {s: [] for s in range(B)}
    for tick in schedule:
        chunk = np.zeros((B, 1, jeng.mimi.frame_size), np.float32)
        mask = np.zeros(B, bool)
        for s, action in tick.items():
            if action == "leave":
                snaps[s] = (jeng.extract_slot_arrays(jstate, s), copy.deepcopy(jeng.items[s]))
                continue
            if action == "join":
                jstate = jeng.reset_batch_idx(jstate, s)
                sessions[s].append(([], []))
            elif action != "send":
                rows, jeng.items[s] = snaps.pop(action[1])
                jstate = jeng.restore_slot_arrays(jstate, rows, s)
                sessions[s].append(([], []))
            chunk[s, 0] = frames[s][taken[s]]
            taken[s] += 1
            mask[s] = True
        if not mask.any():
            continue
        msgs, jstate = jeng.step_pcm(jmp, jlp, jstate, chunk, exec_mask=mask)
        for s in np.nonzero(mask)[0]:
            sessions[s][-1][0].append(jeng.items[s].text_token)
        box = _Outbox()
        for m in msgs:
            jbatched.BatchedAsrState._dispatch(box, m, mask)
        for s, payload in box.sent:
            sessions[s][-1][1].append(payload)
    return sessions


def _words(msgs):
    return [m for m in msgs if m["type"] in ("Word", "EndWord")]


def test_serve_asr_resume_matches_jax():
    """A session leaves, a new tenant dirties its slot, and the session
    resumes on another slot: it keeps its clock, and after the same audio
    its device rows are bit-equal to the unbroken slot's and its text
    tokens and Word / EndWord messages go on as that slot's do; every
    session's tokens and messages equal moshi_tpu's StreamingASR restoring
    its own rows the same way."""
    jeng, jlp, jmp, teng, tlp, tmp = _engines("int8")
    schedule, frames = _resume_script(teng.mimi.frame_size)
    state = BatchedAsrState(teng, tmp, tlp)
    sessions, ms = serve_asr(state, schedule, frames)
    assert len(ms) == len(schedule) - 1         # the tick where the session left runs no frame
    assert state.slot_resumed == {2: False, 1: False, 0: True}
    assert [teng.items[s].step_idx for s in range(B)] == [10, 2, 10]
    assert [len(sessions[s]) for s in range(B)] == [1, 2, 1]
    (unbroken, ref_msgs), = sessions[2]
    (before, before_msgs), (resumed, resumed_msgs) = sessions[1][0], sessions[0][0]
    assert len(before) == len(resumed) == 5
    np.testing.assert_array_equal(np.concatenate([before, resumed]), unbroken)
    assert _words(ref_msgs) and _words(before_msgs + resumed_msgs) == _words(ref_msgs)
    rows = [_tree_items(teng.extract_slot_arrays(state.state, s)) for s in (0, 2)]
    assert [k for k, _ in rows[0]] == [k for k, _ in rows[1]]
    for (key, a), (_, b) in zip(*rows):
        assert torch.equal(a, b), key

    jsessions = _serve_jax(jeng, jlp, jmp, schedule, frames)
    for s in range(B):
        assert len(jsessions[s]) == len(sessions[s])
        for (tt, tm), (jt, jm) in zip(sessions[s], jsessions[s]):
            np.testing.assert_array_equal(tt, jt)
            assert [m["type"] for m in tm] == [m["type"] for m in jm]
            for a, b in zip(tm, jm):
                if a["type"] == "Step":
                    assert a["step_idx"] == b["step_idx"]
                    assert max_abs(np.array(a["prs"]), np.array(b["prs"])) <= PRS_TOL
                else:
                    assert a == b


def _state_leaves(state):
    return [leaf for _, leaf in _tree_items({k: state[k] for k in ("mimi", "transformer")})]


def test_all_true_mask_equals_no_mask():
    """A graphed engine captures its frame with the mask buffer and fills it
    with True where the caller gives no mask: an all-True exec_mask gives
    the bits of exec_mask=None (tokens, messages, every state byte)."""
    runs = []
    for mask in (None, np.ones(B, bool)):
        teng, tlp, tmp = _port_engine()
        state = teng.init_state(None, torch.float32)
        said = []
        for pcm in _pcm(teng.mimi.frame_size)[:8]:
            msgs, state = teng.step_pcm(tmp, tlp, state, pcm, exec_mask=mask)
            said.append([(type(m).__name__, getattr(m, "tokens", None),
                          getattr(m, "prs", np.zeros(0)).tobytes()) for m in msgs]
                        + [i.text_token for i in teng.items])
        runs.append((said, _state_leaves(state)))
    (said_none, leaves_none), (said_true, leaves_true) = runs
    assert said_none == said_true
    assert len(leaves_none) == len(leaves_true) > 0
    for a, b in zip(leaves_none, leaves_true):
        assert torch.equal(a, b)


def test_queued_ops_apply_before_the_frame():
    """A snapshot, a reset and a restore queued between two ticks all apply,
    in order, before the next tick's frame: the snapshot holds the rows the
    slot had when it left (not the reset ones), the reset slot's frame runs
    from offset 0 and the restored slot's from the snapshot's offset.  A
    resume asked for before the snapshot was taken takes it first."""
    teng, tlp, tmp = _port_engine()
    fs = teng.mimi.frame_size
    state = BatchedAsrState(teng, tmp, tlp)
    pcm = _pcm(fs)
    for s in range(B):
        state.open_slot(s)
    for t in range(4):                      # slot 2 sends 2 frames, slots 0 and 1 all 4
        for s in range(B if t < 2 else 2):
            state.feed_pcm(s, pcm[t, s, 0])
        state.tick()
    rid2 = state.issue_resume_id(2)
    state.close_slot(2)
    state.tick()                            # no frame: the snapshot of slot 2 is taken
    assert rid2 in state.snapshots and not state.pending_ops

    left = teng.extract_slot_arrays(state.state, 1)
    rid1 = state.issue_resume_id(1)
    state.close_slot(1)
    state.open_slot(1)                   # a new tenant on slot 1
    state.open_slot(2, resume=rid2)      # slot 2's session back on slot 2
    assert [op[0] for op in state.pending_ops] == ["snapshot", "reset", "restore"]
    for s in range(B):
        state.feed_pcm(s, pcm[4, s, 0])
    assert state.tick().all()
    offsets = state.state["transformer"]["offset"].tolist()
    assert offsets == [5, 1, 3]
    assert [teng.items[s].step_idx for s in range(B)] == [5, 1, 3]
    rows, meta = state.snapshots[rid1]
    assert meta["item"].step_idx == 4 and state.slot_resumed == {0: False, 1: False, 2: True}
    for (key, a), (_, b) in zip(_tree_items(rows), _tree_items(left)):
        assert a.device.type == "cpu" and torch.equal(a, b), key

    rid0 = state.issue_resume_id(0)
    state.close_slot(0)
    assert state.open_slot(0, resume=rid0) == 0 and state.slot_resumed[0]
    assert [op[0] for op in state.pending_ops] == ["restore"]


def test_graphed_needs_a_cuda_device():
    """On the CPU an engine runs eagerly by default, and graphed=True
    raises; warmup (three zero frames, then every slot reset) leaves the
    state of a fresh engine and the step clock where it was."""
    teng, tlp, tmp = _port_engine()
    assert not teng.graphed
    with pytest.raises(ValueError):
        tasr.StreamingASR(teng.mimi, teng.lm, B, DELAY, device="cpu", graphed=True)
    state = BatchedAsrState(teng, tmp, tlp)
    fresh = _state_leaves(teng.init_state(None))
    state.warmup()
    assert teng.model_step_idx == 0
    assert all(item.step_idx == 0 for item in teng.items)
    for a, b in zip(_state_leaves(state.state), fresh):
        assert torch.equal(a, b)


def test_text_tokenizer_matches_jax(tmp_path):
    """The port's copy of the SentencePiece reader decodes, encodes and
    names pieces as moshi_tpu's does (controls and <unk> decode to
    nothing)."""
    path = tmp_path / "tokenizer.model"
    path.write_bytes(spm_model_bytes(40))
    j, t = JTokenizer(path), TTokenizer(path)
    assert len(t) == len(j) == 40
    ids = [5, 1, 17, 3, 39, 0, 2]
    assert t.decode(ids) == j.decode(ids) == "w5 w17 w3 w39"
    assert t.encode("w5 w17") == j.encode("w5 w17") == [5, 17]
    assert [t.id_to_piece(i) for i in range(40)] == [j.id_to_piece(i) for i in range(40)]


def test_asr_presets_match_jax():
    """The ASR presets equal moshi_tpu's; dep_q = 0 builds no depformer."""
    from moshi_tpu.models import loaders
    from moshi_tpu_torch.models import lm as tlm
    for name in ("lm_config_asr_300m_202501", "lm_config_asr_v0_1_1b"):
        assert port_lm_config(getattr(loaders, name)()) == getattr(tlm, name)()
    c = dataclasses.replace(lm_config_asr_300m_202501(), kv_cache_dtype="int8")
    assert TLM(c).depformer is None and c.transformer_config.head_dim == 128
