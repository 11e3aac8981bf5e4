"""The port's conditioners (moshi_tpu_torch/conditioners.py) against
moshi_tpu's on the same converted parameters, in f32 on the CPU: the LUT
conditioner (hashed strings, possible values, None), the tensor
conditioner (padded rows), the continuous attribute, the provider over
attribute batches with CFG's null variants, the fuser's sum and cross, and
conditioners_from_config."""

import jax
import numpy as np
import pytest
import torch

from moshi_tpu import conditioners as jc
from moshi_tpu_torch import conditioners as tc
from moshi_tpu_torch.utils.params import from_jax
from test_torch_port import max_abs

TOL = 1e-6  # f32, same parameters: one product and a blend

CONFIG = {
    "cfg": {"type": "lut", "lut": {"n_bins": 5, "dim": 8, "tokenizer": "noop",
                                   "possible_values": ["1.0", "1.5", "2.0", "2.5", "3.0"]}},
    "tag": {"type": "lut", "lut": {"n_bins": 11, "dim": 8, "tokenizer": "noop"}},
    "speaker_wavs": {"type": "tensor", "tensor": {"dim": 6}},
    "delay": {"type": "continuous_attribute",
              "continuous_attribute": {"dim": 8, "scale_factor": 0.5}},
}
DIM = 16


def _providers():
    jp = jc.conditioners_from_config(DIM, CONFIG)
    params = jax.device_get(jp.init_params(jax.random.PRNGKey(0)))
    return jp, params, tc.conditioners_from_config(DIM, CONFIG), from_jax(params)


def _voice(rs, T, D=6):
    return rs.randn(1, T, D).astype(np.float32)


def _attributes():
    rs = np.random.RandomState(0)
    short = jc.TensorCondition(_voice(rs, 3), np.ones((1, 3), bool))
    longer = jc.TensorCondition(_voice(rs, 5), np.array([[True] * 4 + [False]]))
    return [jc.ConditionAttributes(text={"cfg": "2.0", "tag": "hello", "delay": "0.5"},
                                   tensor={"speaker_wavs": short}),
            jc.ConditionAttributes(text={"cfg": None, "tag": None, "delay": None},
                                   tensor={"speaker_wavs": longer})]


def _port_attributes(attrs):
    return [tc.ConditionAttributes(dict(a.text), {k: tc.TensorCondition(v.tensor, v.mask)
                                                  for k, v in a.tensor.items()})
            for a in attrs]


def test_config_builds_the_same_conditioners():
    jp, _, tp, _ = _providers()
    assert list(jp.conditioners) == list(tp.conditioners)
    for name, j in jp.conditioners.items():
        t = tp.conditioners[name]
        assert type(t).__name__ == type(j).__name__ and t.kind == j.kind
        assert t.output_dim == j.output_dim == DIM
    assert tp.conditioners["cfg"].possible_values == jp.conditioners["cfg"].possible_values
    with pytest.raises(ValueError):
        tc.conditioners_from_config(DIM, {"x": {"type": "nope", "nope": {}}})


@pytest.mark.parametrize("name,values", [
    ("cfg", ["1.0", None, "3.0", "2.5"]),
    ("tag", ["hello", "world", None, "a much longer string"]),
    ("delay", ["0.5", None, "-1.25", "3"]),
])
def test_text_conditioner_matches_jax(name, values):
    jp, jparams, tp, tparams = _providers()
    jprep = jp.conditioners[name].prepare(values)
    tprep = tp.conditioners[name].prepare(values)
    for a, b in zip(jprep, tprep):
        np.testing.assert_array_equal(a, b)
    jout, jmask = jp.conditioners[name].apply(jparams[name], jprep)
    tout, tmask = tp.conditioners[name].apply(tparams[name], tprep)
    assert tout.shape == (len(values), 1, DIM)
    assert max_abs(tout.numpy(), jout) <= TOL
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_lut_rejects_unknown_values_and_hashes_like_jax():
    _, _, tp, _ = _providers()
    with pytest.raises(ValueError):
        tp.conditioners["cfg"].prepare(["9.9"])
    for word in ("", "hello", "√ünïcode"):
        assert tc.hash_trick(word, 1000) == jc.hash_trick(word, 1000)


def test_provider_fuser_and_null_conditions_match_jax():
    """prepare_and_provide over a batch of attributes with padded tensor
    rows, CFG's null variants after it; the fuser's sum and cross."""
    jp, jparams, tp, tparams = _providers()
    jattrs = _attributes()
    jattrs = jattrs + jc.dropout_all_conditions(jattrs)
    tattrs = _port_attributes(_attributes())
    tattrs = tattrs + tc.dropout_all_conditions(tattrs)
    assert tattrs[2].text == {"cfg": None, "tag": None, "delay": None}
    assert not tattrs[3].tensor["speaker_wavs"].mask.any()
    jt = jp.prepare_and_provide(jparams, jattrs)
    tt = tp.prepare_and_provide(tparams, tattrs)
    assert list(jt) == list(tt)
    for name in jt:
        assert max_abs(tt[name][0].numpy(), jt[name][0]) <= TOL
        np.testing.assert_array_equal(tt[name][1].numpy(), np.asarray(jt[name][1]))
    assert tt["speaker_wavs"][0].shape == (4, 5, DIM)
    fuse = {"sum": ["cfg", "delay"], "cross": ["speaker_wavs", "tag"]}
    jf, tf = jc.ConditionFuser(fuse), tc.ConditionFuser(fuse)
    assert tf.has_conditions
    assert max_abs(tf.get_sum(tt).numpy(), jf.get_sum(jt)) <= TOL
    cross = tf.get_cross(tt)
    assert cross.shape == (4, 6, DIM)
    assert max_abs(cross.numpy(), jf.get_cross(jt)) <= TOL
    empty = tc.ConditionFuser({})
    assert not empty.has_conditions and empty.get_sum(tt) is None and empty.get_cross(tt) is None
    with pytest.raises(ValueError):
        tc.ConditionFuser({"prepend": ["tag"]})


def test_tensor_condition_cat_pads_like_jax():
    rs = np.random.RandomState(1)
    conds = [(_voice(rs, 2), np.ones((1, 2), bool)), (_voice(rs, 4), np.ones((1, 4), bool))]
    j = jc.TensorCondition.cat([jc.TensorCondition(*c) for c in conds])
    t = tc.TensorCondition.cat([tc.TensorCondition(*c) for c in conds])
    np.testing.assert_array_equal(t.tensor, j.tensor)
    np.testing.assert_array_equal(t.mask, j.mask)
    assert tc.TensorCondition.from_tensor(conds[0][0]).mask.all()


def test_seeded_init_has_the_jax_shapes():
    jp, jparams, tp, _ = _providers()
    tparams = tp.init_params(torch.Generator().manual_seed(0))
    for name, sub in jparams.items():
        for key, leaf in sub.items():
            assert tuple(tparams[name][key].shape) == np.asarray(leaf).shape
