"""The port's TTS (models/tts.py, serve/batched_tts.py) against
moshi_tpu's on the same converted weights, in f32 on the CPU: the DSM state
machine and script tokenization, TTSModel.generate and synthesize_pcm (with
a voice, CFG and an audio prefix), and the batched engine at B = 3 over 40
frames of joins, a starved slot, a reset, a voice change and a voiceless
slot, with the int4 and int8 KV caches; the order of the engine's queued
ops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu import conditioners as jc
from moshi_tpu.models import tts as jtts
from moshi_tpu.models.lm import LMModel as JLM
from moshi_tpu.models.mimi import MimiModel as JMimi
from moshi_tpu.serve import batched_tts as jbt
from moshi_tpu_torch import conditioners as tc
from moshi_tpu_torch.models import tts as ttts
from moshi_tpu_torch.models.lm import LMModel as TLM
from moshi_tpu_torch.models.mimi import MimiModel as TMimi
from moshi_tpu_torch.serve.batched_tts import BatchedTTSState, serve_tts
from moshi_tpu_torch.utils.params import from_jax
from moshi_tpu_torch.utils.safetensors import save_file
from test_lm import tiny_lm_config
from test_mimi import tiny_mimi_config
from test_torch_port import max_abs, port_lm_config, port_mimi_config
from test_tts_asr import FakeTokenizer

PCM_TOL = 1e-4  # f32 Mimi decode, port vs JAX (tests/test_torch_mimi.py)
VOICE_T, VOICE_D = 3, 6  # frames and width of a speaker embedding
CFG_VALUES = ["1.0", "2.0", "3.0"]


def _machine(mod, cfg):
    return mod.StateMachine(mod.TokenIds(card=cfg.text_card + 1), max_padding=3,
                            initial_padding=1)


def _tts_pair(kv="model", cfg_coef=1.0, temp=0.0):
    """A tiny voiced TTS (cross-attention over speaker embeddings, a `cfg`
    LUT condition summed into the inputs, heads of 64) in both packages:
    (jax tts, params, mimi params, condition params), (port ...)."""
    cfg = dataclasses.replace(
        tiny_lm_config(dim=128, num_heads=2, n_q=2, dep_q=2, delays=(0, 0, 1),
                       depformer_dim=32, cross_attention=True, text_card_out=65),
        kv_cache_dtype=kv)
    conds = {"speaker_wavs": {"type": "tensor", "tensor": {"dim": VOICE_D}},
             "cfg": {"type": "lut", "lut": {"n_bins": 3, "dim": 8, "tokenizer": "noop",
                                            "possible_values": CFG_VALUES}}}
    fuse = {"cross": ["speaker_wavs"], "sum": ["cfg"]}
    jlm, jmimi = JLM(cfg), JMimi(tiny_mimi_config())
    params = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32))
    mparams = jax.device_get(jmimi.init_params(jax.random.PRNGKey(1)))
    jprov = jc.conditioners_from_config(cfg.dim, conds)
    cparams = jax.device_get(jprov.init_params(jax.random.PRNGKey(2)))
    kw = dict(delay_steps=2, max_speakers=2, temp=temp, cfg_coef=cfg_coef, n_q=2,
              max_gen_length=60, final_padding=2)
    jt = jtts.TTSModel(jlm, jmimi, FakeTokenizer(), _machine(jtts, cfg),
                       condition_provider=jprov, fuser=jc.ConditionFuser(fuse), **kw)
    tmcfg = port_mimi_config(tiny_mimi_config())
    tt = ttts.TTSModel(TLM(port_lm_config(cfg)), TMimi(tmcfg), FakeTokenizer(),
                       _machine(ttts, cfg),
                       condition_provider=tc.conditioners_from_config(cfg.dim, conds),
                       fuser=tc.ConditionFuser(fuse), **kw)
    return ((jt, params, mparams, cparams),
            (tt, from_jax(params), from_jax(mparams, mimi_config=tmcfg), from_jax(cparams)))


def _voices(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(VOICE_T, VOICE_D).astype(np.float32) * (1 + i) for i in range(n)]


# ------------------------------------------------------------ state machine
def _random_entries(mod, rs):
    out = []
    for _ in range(rs.randint(1, 6)):
        n = rs.randint(0, 4)
        out.append(mod.Entry(tokens=list(rs.randint(4, 60, n)), text="w" * n,
                             padding=int(rs.randint(0, 3))))
    return out


@pytest.mark.parametrize("second_stream", [0, 2])
def test_state_machine_matches_jax(second_stream):
    """Random entries and random sampled tokens (new word, pad, others):
    each step's output, consumption and every field of the state equal
    JAX's."""
    rs = np.random.RandomState(second_stream)
    for trial in range(20):
        seed = rs.randint(1 << 30)
        j_entries = _random_entries(jtts, np.random.RandomState(seed))
        t_entries = _random_entries(ttts, np.random.RandomState(seed))
        jm = jtts.StateMachine(jtts.TokenIds(card=100), second_stream_ahead=second_stream,
                               max_padding=4, initial_padding=trial % 3)
        tm = ttts.StateMachine(ttts.TokenIds(card=100), second_stream_ahead=second_stream,
                               max_padding=4, initial_padding=trial % 3)
        js, ts = jm.new_state(j_entries), tm.new_state(t_entries)
        for step, tok in enumerate(rs.choice([0, 3, 7, 50], 40)):
            assert tm.process(step, ts, int(tok)) == jm.process(step, js, int(tok))
            assert repr(ts) == repr(js)  # every field, the queued entries too


def test_script_to_entries_matches_jax():
    script = ["Hello there: it's (really) me", 'wait <break time="1.5s"/> for it',
              "and   the end’s here"]
    for multi, pad in ((True, 0), (False, 2), (True, 1)):
        j = jtts.script_to_entries(FakeTokenizer(), jtts.TokenIds(card=65), 12.5, script,
                                   multi_speaker=multi, padding_between=pad)
        t = ttts.script_to_entries(FakeTokenizer(), ttts.TokenIds(card=65), 12.5, script,
                                   multi_speaker=multi, padding_between=pad)
        assert repr(t) == repr(j)
    from moshi_tpu.text import tts_preprocess as jp
    from moshi_tpu_torch.text import tts_preprocess as tp
    text = 'a: b’s <break time="0.5s"/> (c) – d <break time="20s"/>'
    assert [str(x) for x in tp.parse_segments(text)] == [str(x) for x in jp.parse_segments(text)]
    assert tp.normalize(text) == jp.normalize(text)


# ---------------------------------------------------------------- generate
GENERATE_CASES = {"voice": (1.0, False), "voice_cfg": (2.0, False),
                  "voice_cfg_prefix": (2.0, True)}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_and_synthesize_match_jax(case):
    """Two scripts, each with its voice (the `cfg` condition left to its
    padding), greedy: the logged text tokens, frames, end steps,
    consumption times and transcripts equal JAX's; the PCM is within
    PCM_TOL.  With CFG the null conditions follow the slots'; with a prefix
    its codes are forced and CFG masks them."""
    cfg_coef, with_prefix = GENERATE_CASES[case]
    (jt, jp, jm, jcp), (tt, tp, tm, tcp) = _tts_pair(cfg_coef=cfg_coef)
    scripts = [["hello world, how are you"], ["bye now", "ok"]]
    voices = _voices(2)
    jattrs = [jt.make_condition_attributes([v[None]]) for v in voices]
    tattrs = [tt.make_condition_attributes([v[None]]) for v in voices]
    assert tattrs[0].text == jattrs[0].text == {"control": "ok", "cfg": None}
    assert tt.multi_speaker and tt.valid_cfg_conditionings == jt.valid_cfg_conditionings
    prefixes = None
    if with_prefix:
        rs = np.random.RandomState(4)
        codes = rs.randint(0, 48, (1 + 2, 3))
        codes[0] = -1
        prefixes = [codes, codes[:, :2]]
    jr = jt.generate(jp, [jt.prepare_script(s) for s in scripts], attributes=jattrs,
                     condition_params=jcp, prefixes=prefixes, rng=jax.random.PRNGKey(0))
    tr = tt.generate(tp, [tt.prepare_script(s) for s in scripts], attributes=tattrs,
                     condition_params=tcp, prefixes=prefixes)
    assert len(tr.frames) == len(jr.frames) > 10
    for a, b in zip(tr.frames, jr.frames):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tr.logged_text_tokens == jr.logged_text_tokens
    assert (tr.end_steps, tr.all_consumption_times, tr.all_transcripts) == (
        jr.end_steps, jr.all_consumption_times, jr.all_transcripts)
    starts = None if prefixes is None else [p.shape[-1] for p in prefixes]
    tpcm = tt.synthesize_pcm(tp, tm, tr, starts)
    jpcm = jt.synthesize_pcm(jp, jm, jr, starts)
    assert [len(p) for p in tpcm] == [len(p) for p in jpcm]
    assert all(len(p) for p in tpcm)
    for a, b in zip(tpcm, jpcm):
        assert max_abs(a, b) <= PCM_TOL


def test_simple_generate_takes_embeddings_and_refuses_the_rest(tmp_path, monkeypatch):
    from moshi_tpu_torch.models import loaders as tloaders
    (_, _, _, _), (tt, tp, tm, tcp) = _tts_pair()
    voice = _voices(1)[0][None]
    pcm = tt.simple_generate(tp, tm, ["hi there", "yes"], voice, cfg_coef=2.0,
                             condition_params=tcp)
    assert len(pcm) == 2 and all(p.ndim == 1 and len(p) for p in pcm)
    # a voice name resolves in the local voice directory or on the hub
    save_file({"speaker_wavs": torch.from_numpy(np.ascontiguousarray(voice.transpose(0, 2, 1)))},
              tmp_path / "some_voice_name.sig@1.safetensors")
    tt.voice_repo, tt.voice_suffix = str(tmp_path), ".sig@1.safetensors"
    by_name = tt.simple_generate(tp, tm, "hi", "some_voice_name", cfg_coef=2.0,
                                 condition_params=tcp)
    by_array = tt.simple_generate(tp, tm, "hi", voice, cfg_coef=2.0, condition_params=tcp)
    assert len(by_name) == 1 and np.array_equal(by_name[0], by_array[0])
    asked = []

    def download(repo, filename, revision=None):   # the hub, served from tmp_path
        asked.append((repo, filename))
        return str(tmp_path / filename)

    monkeypatch.setattr(tloaders, "_hf_hub_download", download)
    hub_file = tmp_path / "some_voice_name.sig@1.safetensors"
    assert tt.get_voice_path("hf://kyutai/tts-voices/some_voice_name") == hub_file
    tt.voice_repo = "kyutai/tts-voices"
    assert tt.get_voice_path("some_voice_name") == hub_file
    assert asked == [("kyutai/tts-voices", hub_file.name)] * 2
    prefix = tt.get_prefix(tm, np.zeros(5 * tt.mimi.frame_size, np.float32))
    assert prefix.shape == (1 + 2, 3) and (prefix[0] == ttts.ZERO_TOKEN).all()
    with pytest.raises(ValueError):
        tt.simple_generate(tp, tm, ["a", "b"], [voice], condition_params=tcp)


# ---------------------------------------------------------- batched engine
def _schedule(voices):
    """B = 3 over 40 ticks: slot 1 alone and voiceless first (the
    unconditioned mode), slot 0 joins with voice A and starves for 3 ticks
    before its last words, slot 2 joins with voice B, takes voice C at tick
    18 and ends; slot 0 is reset at tick 24 with voice A; slot 1 leaves at
    tick 30 and a voiceless session joins it at 32."""
    a, b, c = voices
    sched = [{} for _ in range(40)]
    sched[0] = {1: [("join", None), ("words", ["alpha beta gamma delta epsilon"])]}
    sched[2] = {0: [("join", a), ("words", ["one two"]),
                    ("refill", 3, ["three four five six"], True)]}
    sched[6] = {2: [("join", b), ("words", ["hello world again"]), "eos"]}
    sched[18] = {2: [("voice", c)]}
    sched[24] = {0: [("join", a), ("words", ["one two three"]), "eos"]}
    sched[30] = {1: ["leave"]}
    sched[32] = {1: [("join", None), ("words", ["zeta eta"])]}
    return sched


def _jax_serve(st, schedule):
    """serve_tts's loop over moshi_tpu's BatchedTTSState (its run_loop and
    socket handler without asyncio): the same actions, the output frames
    read from the depth program."""
    B = st.batch_size
    sessions = {s: [] for s in range(B)}
    refills, outs = {}, []
    depth = st._depth_decode

    def recording(*args):
        res = depth(*args)
        outs.append(np.asarray(res[0]))
        return res
    st._depth_decode = recording
    for tick in schedule:
        for s, actions in tick.items():
            for action in actions:
                kind = action if isinstance(action, str) else action[0]
                if kind == "join":
                    if st.slots[s] is not None:
                        st.pending_ops = [op for op in st.pending_ops
                                          if not (op[0] == "voice" and op[1] == s)]
                    st.unready.add(s)
                    st.pending_ops.append(("reset", s))
                    st.slots[s] = jbt._TtsSlot(st.machine)
                    refills.pop(s, None)
                    if action[1] is not None:
                        st.set_slot_voice(s, action[1])
                    sessions[s].append({"tokens": [], "events": [], "pcm": [], "eos": False})
                elif kind == "words":
                    st.feed_words(s, action[1])
                elif kind == "eos":
                    st.feed_eos(s)
                elif kind == "voice":
                    st.set_slot_voice(s, action[1])
                elif kind == "refill":
                    refills[s] = [action[1], action[2], action[3], 0]
                elif kind == "leave":
                    st.pending_ops = [op for op in st.pending_ops
                                      if not (op[0] == "voice" and op[1] == s)]
                    st.slots[s] = None
                    refills.pop(s, None)
        for s, r in list(refills.items()):
            if st._starved(st.slots[s]):
                if r[3] == r[0]:
                    st.feed_words(s, r[1])
                    if r[2]:
                        st.feed_eos(s)
                    del refills[s]
                else:
                    r[3] += 1
        active = st.steppable()
        if active:
            st.step_batch(active)
            for b in active:
                sessions[b][-1]["tokens"].append(outs[-1][b, :, 0])
        for s, slot in enumerate(st.slots):
            if slot is None:
                continue
            while not slot.queue.empty():
                kind, payload = slot.queue.get_nowait()
                sess = sessions[s][-1]
                if kind == "eos":
                    sess["eos"] = True
                else:
                    sess["events" if kind == "event" else "pcm"].append(payload)
    return sessions


@pytest.mark.parametrize("kv", ["int4", "int8"])
def test_batched_engine_matches_jax(kv):
    """Every session's output frames and Text events identical to JAX's
    engine, its PCM within PCM_TOL, its end the same; the starved slot sat
    out exactly 3 ticks, and the cross K/V exist only once a slot has a
    voice."""
    (jt, jp, jm, jcp), (tt, tp, tm, tcp) = _tts_pair(kv)
    jst = jbt.BatchedTTSState(jt, jp, jm, 3, jax.random.PRNGKey(0), condition_params=jcp)
    tst = BatchedTTSState(tt, tp, tm, 3, condition_params=tcp, voice_frames=VOICE_T,
                          device="cpu")
    tst.warmup()
    schedule = _schedule(_voices(3, seed=1))
    jsessions = _jax_serve(jst, schedule)
    tsessions, ticks = serve_tts(tst, schedule)
    masks = np.stack([m for m, _ in ticks])
    assert len(ticks) == 40 and not masks[:2, 0].any() and masks[:2, 1].all()
    frozen = np.nonzero(~masks[3:24, 0])[0]
    assert len(frozen) == 3 and np.all(np.diff(frozen) == 1)  # the starve, in one run
    assert [len(s) for s in tsessions.values()] == [2, 2, 1]
    assert tsessions[2][0]["eos"] and tsessions[0][1]["eos"] is jsessions[0][1]["eos"]
    n_pcm = 0
    for s in range(3):
        for t, j in zip(tsessions[s], jsessions[s], strict=True):
            np.testing.assert_array_equal(t["tokens"], np.array(j["tokens"]).reshape(
                t["tokens"].shape))
            assert t["events"] == j["events"] and t["eos"] == j["eos"]
            assert len(t["pcm"]) == len(j["pcm"])
            for a, b in zip(t["pcm"], j["pcm"]):
                assert max_abs(a, b) <= PCM_TOL
            n_pcm += len(t["pcm"])
    assert n_pcm > 20 and sum(len(t["events"]) for t in tsessions[0]) >= 5
    assert "k_cross" in tst.gen_state_cross["transformer"]
    assert "k_cross" not in tst.gen_state["transformer"]


def test_queued_ops_apply_in_order():
    """A voice queued after a join applies after its reset; a slot's queued
    voice leaves with its session; a reset clears the slot's voice, and the
    engine runs unconditioned once no slot has one; ops wait for a tick."""
    _, (tt, tp, tm, tcp) = _tts_pair()
    st = BatchedTTSState(tt, tp, tm, 3, condition_params=tcp, voice_frames=VOICE_T,
                         device="cpu")
    st.warmup()
    a, b = _voices(2)
    assert st.open_slot() == 0
    st.set_slot_voice(0, a)
    assert st.open_slot() == 1 and st.open_slot(2) == 2 and st.open_slot() is None
    st.set_slot_voice(1, b)
    assert [op[:2] for op in st.pending_ops] == [("reset", 0), ("voice", 0), ("reset", 1),
                                                 ("reset", 2), ("voice", 1)]
    assert st.unready == {0, 1, 2} and not st.conditioned
    st.close_slot(1)  # its voice must not reach slot 1's next session
    assert ("voice", 1) not in [op[:2] for op in st.pending_ops]
    assert st.steppable() == [0, 2]  # the initial padding runs before any word
    assert st.unready == set() and st.pending_ops == []
    assert st.slot_attrs[0] is not None and st.slot_attrs[1] is None and st.conditioned
    k = st.gen_state_cross["transformer"]["k_cross"]
    ptr, before = k.data_ptr(), k.clone()
    st.set_slot_voice(2, b)
    st.steppable()
    assert k.data_ptr() == ptr and not torch.equal(k[:, 2], before[:, 2])
    assert torch.equal(k[:, 0], before[:, 0])  # slot 0's voice rows unchanged
    st.close_slot(0)
    st.open_slot(0)
    st.close_slot(2)
    st.open_slot(2)
    st.steppable()
    assert st.slot_attrs == [None] * 3 and not st.conditioned
    with pytest.raises(ValueError):
        st.open_slot(0)


def test_a_voice_of_another_shape_is_refused_and_the_others_run_on():
    """A voice whose frames or width are not the engine's raises at
    set_slot_voice, with nothing queued and the slot's voice unchanged;
    every slot keeps running.  An engine made without voice_frames takes
    the first voice's frames."""
    _, (tt, tp, tm, tcp) = _tts_pair()
    st = BatchedTTSState(tt, tp, tm, 3, condition_params=tcp, voice_frames=VOICE_T,
                         device="cpu")
    st.warmup()
    a, b = _voices(2)
    for s in range(3):
        st.open_slot(s)
        st.feed_words(s, ["one two three four five six seven eight"])
    st.set_slot_voice(0, a)
    assert st.tick()[0].all()
    k = st.gen_state_cross["transformer"]["k_cross"].clone()
    for bad in (np.zeros((VOICE_T + 1, VOICE_D)), np.zeros((VOICE_T, VOICE_D + 1)),
                np.zeros(VOICE_T * VOICE_D), b[None]):
        with pytest.raises(ValueError, match="voice"):
            st.set_slot_voice(1, bad)
    assert st.pending_ops == [] and st.slot_attrs[1] is None
    for _ in range(3):
        assert st.tick()[0].all()
    assert torch.equal(st.gen_state_cross["transformer"]["k_cross"], k)
    lazy = BatchedTTSState(tt, tp, tm, 2, condition_params=tcp, device="cpu")
    lazy.set_slot_voice(0, a[:2])
    assert lazy.voice_frames == 2
    with pytest.raises(ValueError, match="voice"):
        lazy.set_slot_voice(1, a)


def test_graphed_engine_refused_on_the_cpu():
    _, (tt, tp, tm, tcp) = _tts_pair()
    with pytest.raises(ValueError, match="CUDA"):
        BatchedTTSState(tt, tp, tm, 2, device="cpu", graphed=True)
