"""One rank of the port's data-parallel training, run as its own process by
tests/test_torch_mesh.py:

    python tests/torch_mesh_ranks.py RANK WORLD JOB_DIR

It joins a gloo group through a file store in JOB_DIR, runs the cases of
JOB_DIR/job.json in turn (each writes its results to JOB_DIR as native
safetensors and JSON) and destroys the group.  It imports the port alone:
the test process holds the JAX package's side."""

import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from moshi_tpu_torch import train
from moshi_tpu_torch.models import native_ckpt
from moshi_tpu_torch.quantization import train as qt
from moshi_tpu_torch.quantization.vq import RVQConfig


def lm_dp(job, rank, out):
    res = train.run_training(job["lm_dp"], log=lambda line: None)
    native_ckpt.save_params(out / f"lm_dp-r{rank}.safetensors", {"params": res["params"]})
    return {"loss": res["loss"]}


def lm_fsdp(job, rank, out):
    """fsdp saved at 4 and 8: each leaf's elements on this rank against
    the whole leaf's, and the whole params and optimizer state."""
    res = train.run_training(job["lm_fsdp"], log=lambda line: None)
    dp = res["dp"]
    params, opt_state = dp.gather(res["params"], res["opt_state"])
    whole = dict(train.tree_leaves(params))
    kept = {"/".join(map(str, p)): [t.numel(), whole[p].numel()]
            for p, t in train.tree_leaves(res["params"])}
    if rank == 0:
        native_ckpt.save_params(out / "lm_fsdp.safetensors",
                                {"params": params, "opt_state": opt_state})
    return {"loss": res["loss"], "kept": kept,
            "sharded_opt_leaves": sum(1 for s in dp.opt_specs.values() if any(s))}


def lm_fsdp_resume(job, rank, out):
    """The fsdp run resumed from its step-4 checkpoint through the CLI."""
    res = train.main(["--config", str(out / "lm_fsdp.json"), "--resume",
                      job["lm_fsdp_resume"], "--out-dir", str(out / "resumed"), "--device", "cpu"])
    params, opt_state = res["dp"].gather(res["params"], res["opt_state"])
    if rank == 0:
        native_ckpt.save_params(out / "lm_fsdp_resumed.safetensors",
                                {"params": params, "opt_state": opt_state})
    return {"loss": res["loss"]}


def mimi(job, rank, out):
    """Mimi under each named config; under fsdp the params gathered."""
    results = {}
    for name, cfg in job["mimi"].items():
        res = train.run_training(cfg, log=lambda line: None)
        native_ckpt.save_params(out / f"mimi_{name}-r{rank}.safetensors",
                                {"params": res["dp"].gather(res["params"]),
                                 "vq_state": res["vq_state"]})
        results[name] = {"loss": res["loss"], **res["metrics"]}
    return results


def rvq(job, rank, out):
    """rvq_train_forward over this rank's rows, its statistics averaged
    over the group."""
    case = native_ckpt.load_params(out / "rvq_in.safetensors")
    x = case["x"]
    b = x.shape[0] // dist.get_world_size()
    got, state = qt.rvq_train_forward(RVQConfig(**job["rvq"]["config"]),
                                      qt.RVQTrainConfig(**job["rvq"]["train"]), case["params"],
                                      case["state"], x[rank * b:(rank + 1) * b],
                                      torch.Generator().manual_seed(0), group=dist.group.WORLD)
    native_ckpt.save_params(out / f"rvq-r{rank}.safetensors", {
        "quantized": got["quantized"].detach(), "codes": got["codes"],
        "commit_loss": got["commit_loss"].detach(), "entropy": got["entropy"],
        "expired_frac": got["expired_frac"], "state": state})
    return {}


CASES = {"lm_dp": lm_dp, "lm_fsdp": lm_fsdp, "lm_fsdp_resume": lm_fsdp_resume,
         "mimi": mimi, "rvq": rvq}


def main(rank: int, world: int, out: Path) -> None:
    # beside other test processes torch's thread pool slows a tiny model
    torch.set_num_threads(1)
    job = json.loads((out / "job.json").read_text())
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}", rank=rank,
                            world_size=world)
    results = {}
    try:
        for name in job["cases"]:
            results[name] = CASES[name](job, rank, out)
    finally:
        dist.destroy_process_group()
    results["imported"] = sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib", "moshi_tpu"))
    (out / f"results-r{rank}.json").write_text(json.dumps(results))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
