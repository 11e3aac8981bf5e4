"""The port's mesh (moshi_tpu_torch/parallel) against moshi_tpu's, in f32 on
the CPU: lm_param_spec, fsdp_param_spec (with and without a base) and
opt_state_spec give the JAX package's specs leaf for leaf on dense, int8,
int4 and LoRA trees; two gloo ranks, spawned once as their own processes
(tests/torch_mesh_ranks.py, which imports no JAX), train the LM under
mesh {dp: 2} and {dp: 2, fsdp: true} with clipping and accumulation to the
one-device run's params and to JAX's run_training over the same mesh, resume
an fsdp checkpoint bit for bit (and at dp = 1), train the tiny Mimi to the
one-device run's params and codebooks, and average rvq_train_forward's
statistics over the group as JAX's axis_name does; the CLI under torchrun
on two CPU ranks; and the mesh configs the trainer refuses."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from moshi_tpu import train as jtrain
from moshi_tpu.parallel import mesh as jmesh
from moshi_tpu.quantization import train as jqt
from moshi_tpu.quantization.vq import RVQConfig as JRVQConfig
from moshi_tpu_torch import train as ttrain
from moshi_tpu_torch.models import native_ckpt
from moshi_tpu_torch.parallel import mesh as tmesh
from moshi_tpu_torch.utils.params import from_jax
from moshi_tpu_torch.utils.quantize import quantize_lm_params
from test_torch_lora import jax_lora_tree, to_jax
from test_torch_lora import one_thread  # noqa: F401  (autouse)
from test_torch_train import _tiny_lm_train_cfg

ROOT = Path(__file__).resolve().parent.parent
# JAX's own bounds for its sharded trainer against one device
# (tests/test_train.py:285-290)
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
# Mimi at dp = 2 against one device after one step: the same f32 bounds, on
# the params and on the EMA state (k-means' codebooks included)
MIMI_RTOL, MIMI_ATOL = 1e-4, 1e-5
RVQ_TOL = 1e-5    # f32, max |diff| / max |JAX| (tests/test_torch_vq_train.py)
RANKS_TIMEOUT = 300


# ------------------------------------------------------------ the rules
def _trees(kind):
    """A JAX tree of the tiny LM and the port's copy of it (the quantized
    ones by the port's quantizer, whose leaves have the JAX package's
    shapes)."""
    if kind in ("int8", "int4"):
        tree = quantize_lm_params(from_jax(jax.device_get(jax_lora_tree()[2])), min_size=1,
                                  mode=kind)
        return to_jax(tree), tree
    tree = jax_lora_tree("int8")[3] if kind == "lora" else jax_lora_tree()[2]
    return tree, from_jax(jax.device_get(tree))


def _same_leaves(jtree, ttree):
    """The port's leaf paths, after checking they are JAX's leaves in
    order (by shape)."""
    tleaves = list(ttrain.tree_leaves(ttree))
    assert [tuple(x.shape) for x in jax.tree.leaves(jtree)] == \
        [tuple(t.shape) for _, t in tleaves]
    return [p for p, _ in tleaves]


def _assert_specs(jspecs, tspecs, paths):
    jl = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
    assert len(jl) == len(paths)
    for p, js in zip(paths, jl):
        assert tspecs[p] == tuple(js), (p, tspecs[p], js)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "lora"])
def test_param_specs_match_jax(kind):
    """lm_param_spec over make_mesh(8, tp=4) (the counterpart of
    tests/test_mesh_quantized.py::test_quantized_leaf_specs), and
    fsdp_param_spec alone and with lm_param_spec as its base (of
    tests/test_train.py::test_fsdp_spec_composes_with_tp), leaf by leaf."""
    jtree, ttree = _trees(kind)
    paths = _same_leaves(jtree, ttree)
    jm, tm = jmesh.make_mesh(8, tp=4), tmesh.make_mesh(8, tp=4)
    assert tm.shape == {"dp": 2, "tp": 4} and tm.groups == {}
    jbase, tbase = jmesh.lm_param_spec(jtree, jm), tmesh.lm_param_spec(ttree, tm)
    _assert_specs(jbase, tbase, paths)
    assert sum(1 for s in tbase.values() if "tp" in s) > 4
    _assert_specs(jmesh.fsdp_param_spec(jtree, jm), tmesh.fsdp_param_spec(ttree, tm), paths)
    both = tmesh.fsdp_param_spec(ttree, tm, base=tbase)
    _assert_specs(jmesh.fsdp_param_spec(jtree, jm, base=jbase), both, paths)
    assert any("dp" in s and "tp" in s for s in both.values())
    assert tmesh.batch_spec(tm) == tuple(jmesh.batch_spec(jm))


def test_opt_state_spec_matches_jax():
    """adamw's moments and MultiSteps' accumulator take the params' specs
    (fsdp over lm_param_spec), the counts stay replicated, as JAX's
    opt_state_spec gives them."""
    jtree, ttree = _trees("dense")
    jm, tm = jmesh.make_mesh(8, tp=4), tmesh.make_mesh(8, tp=4)
    ocfg = {"grad_clip": 1.0, "accum_steps": 2}
    jspecs = jmesh.fsdp_param_spec(jtree, jm, base=jmesh.lm_param_spec(jtree, jm))
    tspecs = tmesh.fsdp_param_spec(ttree, tm, base=tmesh.lm_param_spec(ttree, tm))
    jstate = jtrain.make_optimizer(ocfg).init(jtree)
    jos = jmesh.opt_state_spec(jstate, jtree, jspecs, jm)
    topt = ttrain.make_optimizer(ocfg)
    tstate = topt.init(ttree)
    tos = tmesh.opt_state_spec(tstate, ttree, tspecs, topt.select(ttree), tm)

    def by_kind(leaves, names):
        out = {k: [] for k in names}
        for key, spec in leaves:
            for k in names:
                if k in key:
                    out[k].append(spec)
        return out
    jleaves = [(jax.tree_util.keystr(k), tuple(s)) for k, s in jax.tree_util.tree_flatten_with_path(
        jos, is_leaf=lambda x: isinstance(x, P))[0]]
    tleaves = [("/".join(map(str, p)), tos[p]) for p, _ in ttrain.tree_leaves(tstate)]
    jk = by_kind(jleaves, ("mu", "nu", "acc_grads"))
    tk = by_kind(tleaves, ("mu", "nu", "acc"))
    want = [tuple(s) for s in jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P))]
    assert jk["mu"] == tk["mu"] == jk["nu"] == tk["nu"] == jk["acc_grads"] == tk["acc"] == want
    assert {s for k, s in jleaves if "count" in k or "step" in k} == \
        {s for k, s in tleaves if "count" in k or "step" in k} == {()}


# ------------------------------------------------------- two gloo ranks
MIMI_CFG = {
    "target": "mimi", "device": "cpu", "num_codebooks": 4, "seed": 3,
    "mimi_config": {
        "sample_rate": 1200, "channels": 1, "frame_rate": 12.5,
        "seanet": dict(dimension=32, n_filters=4, n_residual_layers=1, ratios=[4, 3, 2],
                       kernel_size=7, residual_kernel_size=3, last_kernel_size=3,
                       dilation_base=2, compress=2, pad_mode="constant"),
        "transformer": dict(d_model=32, num_heads=2, num_layers=2, dim_feedforward=64,
                            causal=True, context=25, positional_embedding="rope",
                            gating="none", norm="layer_norm", layer_scale=0.01),
        "quantizer": dict(dimension=16, input_dimension=32, output_dimension=32, n_q=8,
                          bins=32)},
    "optimizer": {"lr": 1e-3, "grad_clip": 1.0},
    "steps": 8, "batch_size": 4, "seq_len": 4, "log_every": 0}
# the rank pair's Mimi runs: one step under dp and fsdp, 8 under dp
MIMI_MESHES = {"dp1": {"mesh": {"dp": 2}, "steps": 1},
               "fsdp1": {"mesh": {"dp": 2, "fsdp": True}, "steps": 1},
               "dp8": {"mesh": {"dp": 2}}}
RVQ_CASE = {"config": dict(dimension=8, input_dimension=12, output_dimension=10, n_q=3,
                           bins=16),
            "train": dict(decay=0.9)}


def _rvq_inputs():
    rs = np.random.RandomState(5)
    usage = rs.rand(3, 16).astype(np.float32) + 0.5
    return {"x": rs.randn(4, 7, 12).astype(np.float32),
            "params": {"input_proj": rs.randn(12, 8).astype(np.float32) / 12 ** 0.5,
                       "output_proj": rs.randn(8, 10).astype(np.float32) / 8 ** 0.5},
            "state": {"initialized": np.ones((), np.float32), "cluster_usage": usage,
                      "embedding_sum": rs.randn(3, 16, 8).astype(np.float32) * usage[..., None]}}


def _lm_cfg(out: Path, **over):
    """The tiny LM from one native checkpoint of JAX params, batches of 4
    rows from a file whose masked tokens (-1) sit in rank 0's rows only, so
    the ranks' counts of valid positions differ; 8 steps of 2 micro-steps
    under the optimizer of JAX's own sharded test (cosine, 5 warmup steps,
    clipped at 1.0)."""
    cfg = jax_lora_tree()[0]
    base = _tiny_lm_train_cfg(cfg, steps=8, batch_size=4,
                              optimizer={"lr": 3e-3, "schedule": "cosine", "warmup_steps": 5,
                                         "grad_clip": 1.0, "accum_steps": 2},
                              checkpoint_dir=str(out / "ckpt"),
                              data={"kind": "safetensors", "path": str(out / "codes.safetensors"),
                                    "key": "codes"})
    del base["lm_config"]
    return {**base, **over}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks started once for every case of the file, and beside
    them the CLI under torchrun on two CPU ranks (Mimi at dp = 2, one step):
    (job dir, wait), wait() giving the ranks' results once they exited and
    wait(torchrun=True) the CLI's output."""
    out = tmp_path_factory.mktemp("mesh")
    cfg, _, params, _ = jax_lora_tree()
    (out / "ckpt").mkdir()
    (out / "ckpt" / "config.json").write_text(json.dumps(
        {**_tiny_lm_train_cfg(cfg)["lm_config"], "native_format": True,
         "moshi_name": "m.safetensors"}))
    native_ckpt.save_params(out / "ckpt" / "m.safetensors", from_jax(jax.device_get(params)))
    rs = np.random.RandomState(4)
    codes = rs.randint(0, min(cfg.card, cfg.text_card),
                       size=(8, cfg.num_codebooks, 8)).astype(np.int32)
    for row in (0, 1, 4, 5):   # rank 0's rows of the four batches
        codes[row, rs.randint(0, cfg.num_codebooks, 5), rs.randint(0, 8, 5)] = -1
    from safetensors.numpy import save_file
    save_file({"codes": codes}, str(out / "codes.safetensors"))
    native_ckpt.save_params(out / "rvq_in.safetensors", {
        k: ({n: torch.from_numpy(v) for n, v in v.items()} if isinstance(v, dict)
            else torch.from_numpy(v)) for k, v in _rvq_inputs().items()})
    fsdp = _lm_cfg(out, mesh={"dp": 2, "fsdp": True}, out_dir=str(out / "fsdp"), save_every=4)
    (out / "lm_fsdp.json").write_text(json.dumps(fsdp))
    job = {"cases": ["lm_dp", "lm_fsdp", "lm_fsdp_resume", "mimi", "rvq"],
           "lm_dp": _lm_cfg(out, mesh={"dp": 2}), "lm_fsdp": fsdp,
           "lm_fsdp_resume": str(out / "fsdp" / "train-000004.safetensors"),
           "mimi": {name: {**MIMI_CFG, **over} for name, over in MIMI_MESHES.items()},
           "rvq": RVQ_CASE}
    (out / "job.json").write_text(json.dumps(job))
    (out / "mimi_torchrun.json").write_text(json.dumps(
        {**MIMI_CFG, "mesh": {"dp": 2}, "steps": 1, "out_dir": str(out / "torchrun")}))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    logs = [open(out / f"{name}.log", "w") for name in ("rank0", "rank1", "torchrun")]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
                               str(r), "2", str(out)], cwd=ROOT, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "moshi_tpu_torch.train", "--config", str(out / "mimi_torchrun.json"),
         "--device", "cpu"], cwd=ROOT, env=env, stdout=logs[2], stderr=subprocess.STDOUT))
    done = {}

    def wait(torchrun: bool = False):
        if not done:
            try:
                rcs = [p.wait(timeout=RANKS_TIMEOUT) for p in procs]
            finally:
                for p in procs:
                    p.kill()
            tails = "\n".join(f.read_text()[-3000:] for f in
                              (out / "rank0.log", out / "rank1.log", out / "torchrun.log"))
            assert rcs == [0, 0, 0], tails
            done["results"] = [json.loads((out / f"results-r{r}.json").read_text())
                               for r in range(2)]
        return (out / "torchrun.log").read_text() if torchrun else done["results"]
    yield out, wait
    for p, f in zip(procs, logs):
        p.kill()
        p.wait()
        f.close()


def _leaves(tree) -> dict:
    return {p: t.detach().float().numpy() for p, t in ttrain.tree_leaves(tree)}


def _assert_params_close(got: dict, want: dict, rtol, atol):
    assert list(got) == list(want) and got
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=rtol, atol=atol, err_msg=str(p))


def _jax_params(jparams) -> dict:
    return _leaves(from_jax(jax.device_get(jparams)))


@pytest.fixture(scope="module")
def one_device(ranks):
    """The port's and the JAX package's one-device runs of _lm_cfg, made
    while the ranks run."""
    out, _ = ranks
    return (ttrain.run_training(_lm_cfg(out), log=lambda line: None),
            jtrain.run_training(_lm_cfg(out), log=lambda line: None))


@pytest.mark.parametrize("fsdp", [False, True])
def test_lm_mesh_matches_one_device_and_jax(ranks, one_device, fsdp):
    """The LM over two ranks (clipped, 2 micro-steps a step, the ranks'
    valid counts unequal): the loss and every param end where the port's
    one-device run ends, at JAX's own bounds for its sharded trainer; the
    loss ends where JAX's run_training over the same mesh ends, at the same
    bound, and each param as near it as that bound plus the distance
    between JAX's own mesh and one-device runs (Adam turns f32 reordering
    into steps of ~lr where a gradient is near zero, and neither trainer can
    reproduce the other's order of summation).  Both ranks hold the same
    replicas, or under fsdp each sharded leaf's half."""
    out, wait = ranks
    mesh = {"dp": 2, "fsdp": True} if fsdp else {"dp": 2}
    jax_mesh = jtrain.run_training(_lm_cfg(out, mesh=mesh), log=lambda line: None)
    one, jax_one = one_device
    res = wait()
    name = "lm_fsdp" if fsdp else "lm_dp"
    if fsdp:
        got = _leaves(native_ckpt.load_params(out / "lm_fsdp.safetensors")["params"])
        kept = [res[r][name]["kept"] for r in range(2)]
        assert kept[0] == kept[1]
        halves = [k for k, (n, whole) in kept[0].items() if n * 2 == whole]
        assert all(n * 2 == whole or n == whole for n, whole in kept[0].values())
        assert len(halves) > len(kept[0]) // 2
        # adamw's mu and nu and the accumulator, each sharded as its param
        assert res[0][name]["sharded_opt_leaves"] == 3 * len(halves)
    else:
        got, other = (_leaves(native_ckpt.load_params(out / f"lm_dp-r{r}.safetensors")["params"])
                      for r in range(2))
        assert all(np.array_equal(got[p], other[p]) for p in got)
    for r in range(2):
        for ref in (one["loss"], jax_mesh["loss"]):
            np.testing.assert_allclose(res[r][name]["loss"], ref, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _assert_params_close(got, _leaves(one["params"]), PARAM_RTOL, PARAM_ATOL)
    jm, j1 = _jax_params(jax_mesh["params"]), _jax_params(jax_one["params"])
    assert list(got) == list(jm)
    for p in jm:
        bound = PARAM_ATOL + PARAM_RTOL * np.abs(jm[p]) + np.abs(jm[p] - j1[p])
        assert (np.abs(got[p] - jm[p]) <= bound).all(), p
    start = _leaves(native_ckpt.load_params(out / "ckpt" / "m.safetensors"))
    assert all(not np.array_equal(got[p], start[p]) for p in got)


def test_fsdp_resume_is_bitwise_and_loads_at_dp1(ranks, one_device):
    """The fsdp run's step-4 checkpoint (gathered whole by rank 0) resumed
    through the CLI at dp = 2 ends bit for bit where the unbroken run ends,
    params and optimizer state; at dp = 1 it resumes to the one-device
    run's params within JAX's bounds."""
    out, wait = ranks
    ck = out / "fsdp" / "train-000004.safetensors"
    wait()
    assert ttrain.load_train_state(ck)[2] == 4
    unbroken = native_ckpt.load_params(out / "lm_fsdp.safetensors")
    resumed = native_ckpt.load_params(out / "lm_fsdp_resumed.safetensors")
    for tree in ("params", "opt_state"):
        a, b = list(ttrain.tree_leaves(unbroken[tree])), list(ttrain.tree_leaves(resumed[tree]))
        assert [p for p, _ in a] == [p for p, _ in b] and a
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b)), tree
    at1 = ttrain.run_training(_lm_cfg(out, resume=str(ck)), log=lambda line: None)
    _assert_params_close(_leaves(at1["params"]), _leaves(one_device[0]["params"]),
                         PARAM_RTOL, PARAM_ATOL)


def test_mimi_mesh_matches_one_device(ranks):
    """Mimi over two ranks: k-means on the first batch, the EMA sums and
    the expired-code draws taken over the global batch with one generator
    state on both ranks.  After one step (k-means, the EMA and a
    replacement draw, the first update) params and codebook state are the
    one-device run's, under dp and under fsdp; after 8 the ranks still
    hold the same bytes, the loss has fallen and the codebooks are in use.
    Beyond the first step the nearest-code argmin turns f32 reordering
    into other assignments (at step 2 the entropy already differs in its
    5th digit), so a later step is no f32 bound's business."""
    out, wait = ranks
    one = ttrain.run_training({**MIMI_CFG, "steps": 1}, log=lambda line: None)
    res = wait()
    for name in MIMI_MESHES:
        got = [native_ckpt.load_params(out / f"mimi_{name}-r{r}.safetensors") for r in range(2)]
        for tree in ("params", "vq_state"):
            a, b = _leaves(got[0][tree]), _leaves(got[1][tree])
            assert all(np.array_equal(a[p], b[p]) for p in a), (name, tree)
            if name != "dp8":
                _assert_params_close(a, _leaves(one[tree]), MIMI_RTOL, MIMI_ATOL)
        if name != "dp8":
            got = res[0]["mimi"][name]
            np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
            assert got["entropy"] == pytest.approx(one["metrics"]["entropy"], rel=1e-6)
            assert got["expired_frac"] == one["metrics"]["expired_frac"] > 0
    first, last = res[0]["mimi"]["dp1"], res[0]["mimi"]["dp8"]
    assert last["loss"] < first["loss"] and last["entropy"] > 0.5


def test_mimi_cli_under_torchrun(ranks):
    """`torchrun --standalone --nproc_per_node 2 -m moshi_tpu_torch.train`
    with mesh {dp: 2} on the CPU: each rank joins the gloo group from
    torchrun's environment, rank 0 alone prints the final line and writes
    the checkpoint, whose params and codebook state are the one-device
    step's."""
    out, wait = ranks
    one = ttrain.run_training({**MIMI_CFG, "steps": 1}, log=lambda line: None)
    finals = [json.loads(line) for line in wait(torchrun=True).splitlines()
              if line.startswith('{"final_step"')]
    assert len(finals) == 1 and finals[0]["final_step"] == 1
    np.testing.assert_allclose(finals[0]["final_loss"], one["loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    ck = out / "torchrun" / "train-000001.safetensors"
    _assert_params_close(_leaves(ttrain.load_train_state(ck)[0]), _leaves(one["params"]),
                         MIMI_RTOL, MIMI_ATOL)
    _assert_params_close(_leaves(native_ckpt.load_params(str(ck) + ".vq")),
                         _leaves(one["vq_state"]), MIMI_RTOL, MIMI_ATOL)


def test_rvq_group_matches_jax_axis_name(ranks):
    """rvq_train_forward over a group of 2 against JAX's under shard_map
    with axis_name (lax.pmean of the batch statistics), on an initialized
    state where no code expires: each rank's codes, straight-through output
    and commit loss, and the averaged EMA state."""
    out, wait = ranks
    case = _rvq_inputs()
    cfg = JRVQConfig(**RVQ_CASE["config"], force_projection=True)

    def shard(x):
        o, st = jqt.rvq_train_forward(cfg, jqt.RVQTrainConfig(**RVQ_CASE["train"]),
                                      {k: jnp.asarray(v) for k, v in case["params"].items()},
                                      {k: jnp.asarray(v) for k, v in case["state"].items()}, x,
                                      jax.random.PRNGKey(0), axis_name="dp")
        return (o["quantized"], o["codes"], o["commit_loss"][None], o["expired_frac"][None],
                st["cluster_usage"][None], st["embedding_sum"][None])
    fn = jax.shard_map(shard, mesh=JMesh(np.array(jax.devices()[:2]), ("dp",)),
                       in_specs=P("dp"), out_specs=P("dp"), check_vma=False)
    jq, jc, jcommit, jexp, jusage, jsum = map(np.asarray, fn(jnp.asarray(case["x"])))
    wait()
    for r in range(2):
        got = native_ckpt.load_params(out / f"rvq-r{r}.safetensors")
        rows = slice(2 * r, 2 * r + 2)
        assert np.array_equal(got["codes"].numpy(), jc[rows])
        assert float(got["expired_frac"]) == float(jexp[r]) == 0.0
        for g, want in ((got["quantized"], jq[rows]), (got["commit_loss"], jcommit[r]),
                        (got["state"]["cluster_usage"], jusage[r]),
                        (got["state"]["embedding_sum"], jsum[r])):
            assert float(np.abs(g.numpy() - want).max()) <= RVQ_TOL * float(np.abs(want).max())


def test_ranks_import_no_jax(ranks):
    _, wait = ranks
    assert [r["imported"] for r in wait()] == [[], []]


# ------------------------------------------------------------- refusals
def test_mesh_refusals(tmp_path):
    """A batch that does not split over dp; dp >= 2 with no process group
    (the message says how to launch); dp unequal to the group's size."""
    cfg = _tiny_lm_train_cfg(jax_lora_tree()[0], steps=1)
    with pytest.raises(ValueError, match="batch_size 3 does not split"):
        ttrain.run_training({**cfg, "batch_size": 3, "mesh": {"dp": 2}})
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        ttrain.run_training({**cfg, "mesh": {"dp": 2}})
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="mesh.dp = 2 in a process group of 1 ranks"):
            ttrain.run_training({**cfg, "mesh": {"dp": 2}})
        # dp = 1 over the group trains, the collectives over one rank
        out = ttrain.run_training({**cfg, "mesh": {"dp": 1}}, log=lambda line: None)
        assert out["dp"].mesh.shape == {"dp": 1, "tp": 1}
        plain = ttrain.run_training(cfg, log=lambda line: None)
        assert out["loss"] == plain["loss"]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            ttrain.tree_leaves(out["params"]), ttrain.tree_leaves(plain["params"])))
    finally:
        dist.destroy_process_group()
