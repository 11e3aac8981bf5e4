"""The (dp, tp) mesh of ranks and its sharding rules (counterpart of
moshi_tpu/parallel/mesh.py).

A mesh places rank r at (r // tp, r % tp), as the JAX package reshapes its
devices, and holds this rank's process group along each axis.  A spec is a
tuple with a mesh-axis name or None per leading dim of a tensor, as
jax.sharding.PartitionSpec (() is replicated); a spec tree is a dict from
the leaf paths of train.tree_leaves (a QTensor's q and scale, a
LoRAWeight's base, a and b) to specs.  The rules are the JAX package's,
leaf for leaf: `lm_param_spec` (tensor parallel over the transformer's
projections), `fsdp_param_spec` (ZeRO-3 over dp, composable with a base
spec tree) and `opt_state_spec` (adamw's moments take the params' specs).
`shard_tree` keeps this rank's slice of each leaf and `gather_tree`
reassembles the whole leaves: where JAX's GSPMD places arrays, the trainer
moves the slices itself.
"""

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..models.lora import LoRAWeight
from ..train import tree_leaves, tree_replace
from ..utils.quantize import QTensor, QTensor4
from . import collectives

AXES = ("dp", "tp")


@dataclass(frozen=True)
class Mesh:
    """`shape` {"dp": n // tp, "tp": tp}; `rank` this process's rank;
    `groups` its process group along each axis (None: an axis of one rank,
    or no process group)."""
    shape: dict
    rank: int = 0
    groups: dict = field(default_factory=dict)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        tp = self.shape["tp"]
        return self.rank // tp if axis == "dp" else self.rank % tp

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(n_devices: int | None = None, tp: int | None = None) -> Mesh:
    """A (dp, tp) mesh of `n_devices` ranks, `tp` defaulting to
    min(n_devices, 4).  Within an initialized process group the mesh spans
    its ranks (n_devices, default the world size, must equal it) and holds
    this rank's groups; outside one it is a shape for the spec rules."""
    world = dist.get_world_size() if dist.is_initialized() else None
    n = n_devices if n_devices is not None else (world or 1)
    if tp is None:
        tp = min(n, 4)
    assert n % tp == 0, (n, tp)
    shape = {"dp": n // tp, "tp": tp}
    if world is None:
        return Mesh(shape)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    rank = dist.get_rank()
    members = {"dp": [[d * tp + t for d in range(n // tp)] for t in range(tp)],
               "tp": [[d * tp + t for t in range(tp)] for d in range(n // tp)]}
    groups = {}
    for axis in AXES:
        for ranks in members[axis]:
            # every rank makes every group, in one order (new_group's rule)
            if len(ranks) == world:
                g = dist.group.WORLD
            elif len(ranks) > 1:
                g = dist.new_group(ranks)
            else:
                g = None
            if rank in ranks:
                groups[axis] = g
    return Mesh(shape, rank, groups)


def _joined(path: tuple) -> str:
    """A leaf path as the JAX package's rule reads it: dict keys by name,
    list indices as "[i]"."""
    return "/".join(f"[{k}]" if isinstance(k, int) else str(k) for k in path)


def _weight_leaves(tree, path=()):
    """(path, node) of every weight: a tensor, or a QTensor, QTensor4 or
    LoRAWeight whole, in tree_leaves' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _weight_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _weight_leaves(v, path + (i,))
    elif isinstance(tree, (torch.Tensor, QTensor, QTensor4, LoRAWeight)):
        yield path, tree


def lm_param_spec(params, mesh: Mesh) -> dict:
    """Specs of an LM's params: tensor parallel over the obvious matmul
    axes when divisible, replicated otherwise (moshi_tpu mesh.py
    lm_param_spec):
    - attn.in_proj  [L, W, d, qkv]  -> shard qkv (column parallel)
    - attn.out_proj [L, W, d, d]    -> shard d_in (row parallel)
    - mlp.linear_in [L, W, d, 2h]   -> shard 2h
    - mlp.linear_out[L, W, h, d]    -> shard h
    - embedding tables stay replicated; other embeddings and the vocab
      heads shard their last axis.
    The column/row decision is made on a wrapped weight's logical shape and
    expanded onto each child: a QTensor's scale [..., 1, out] shards under
    column parallelism and stays whole under row parallelism, a
    LoRAWeight's a follows the row sharding and b the column one."""
    tp = mesh.shape["tp"]

    def decide(joined: str, shape: tuple) -> str | None:
        if len(shape) < 2:
            return None
        last, second = shape[-1], shape[-2]
        col = last % tp == 0
        row = second % tp == 0
        if "attn" in joined and joined.endswith("in_proj"):
            return "col" if col else None
        if "attn" in joined and joined.endswith("out_proj"):
            return "row" if row else None
        if joined.endswith("mlp/linear_in") or "linear1" in joined:
            return "col" if col else None
        if joined.endswith("mlp/linear_out") or "linear2" in joined:
            return "row" if row else None
        if "emb" in joined and joined.endswith("weight"):
            # tables read by a vocab gather: a tp-sharded embedding dim
            # would make the gather and its scatter-add gradient collective
            return None
        if "emb" in joined or "text_linear" in joined or "linears" in joined:
            return "col" if col else None
        return None

    def col_spec(ndim):
        return (None,) * (ndim - 1) + ("tp",)

    def row_spec(ndim, axis_from_end=2):
        return (None,) * (ndim - axis_from_end) + ("tp",) + (None,) * (axis_from_end - 1)

    def expand(kind, x) -> list:
        """(path below x, spec) of each tensor of a weight x."""
        if isinstance(x, LoRAWeight):
            a = row_spec(x.a.ndim) if kind == "row" and x.a.shape[-2] % tp == 0 else ()
            b = col_spec(x.b.ndim) if kind == "col" and x.b.shape[-1] % tp == 0 else ()
            return ([(("base",) + p, s) for p, s in expand(kind, x.base)]
                    + [(("a",), a), (("b",), b)])
        if isinstance(x, QTensor):
            # q [.., in, out]; scale [.., 1, out]
            if kind == "col":
                q, s = col_spec(x.q.ndim), col_spec(x.scale.ndim)
            elif kind == "row":
                q, s = row_spec(x.q.ndim), ()
            else:
                q, s = (), ()
            return [(("q",), q), (("scale",), s)]
        if isinstance(x, QTensor4):
            # q [.., in/2, out]; scale [.., in/gs, 1, out]
            if kind == "col":
                q, s = col_spec(x.q.ndim), col_spec(x.scale.ndim)
            elif kind == "row" and x.q.shape[-2] % tp == 0 and x.scale.shape[-3] % tp == 0:
                q, s = row_spec(x.q.ndim), row_spec(x.scale.ndim, 3)
            else:
                q, s = (), ()
            return [(("q",), q), (("scale",), s)]
        if kind == "col":
            return [((), col_spec(x.ndim))]
        if kind == "row":
            return [((), row_spec(x.ndim))]
        return [((), ())]

    specs = {}
    for path, x in _weight_leaves(params):
        kind = decide(_joined(path), tuple(x.shape)) if x.ndim else None
        specs.update({path + sub: s for sub, s in expand(kind, x)})
    return specs


def _with_axis(spec: tuple, shape: tuple, n: int, name: str) -> tuple:
    """`spec` with mesh axis `name` on the largest still-unsharded dim of
    `shape` that n divides (spec unchanged when none qualifies)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best = None
    for i, d in enumerate(shape):
        if parts[i] is None and d % n == 0 and d >= n and (best is None or d > shape[best]):
            best = i
    if best is None:
        return spec
    parts[best] = name
    return tuple(parts)


def fsdp_param_spec(tree, mesh: Mesh, axis: str = "dp", base: dict | None = None) -> dict:
    """ZeRO-3 specs: each leaf's largest divisible dim sharded over `axis`
    (scalars replicated).  Shape-based, so an optimizer state's leaves get
    specs consistent with the params'.  `base` (a spec tree of the same
    leaves, e.g. lm_param_spec's) composes: the axis goes on the largest dim
    the base left unsharded."""
    n = mesh.shape[axis]
    base = base or {}
    return {p: _with_axis(base.get(p, ()), tuple(x.shape), n, axis) if x.ndim else ()
            for p, x in tree_leaves(tree)}


def opt_state_spec(opt_state, params, param_specs: dict, paths: list, mesh: Mesh | None = None,
                   axis: str = "dp") -> dict:
    """Specs of an optimizer state from the params' spec tree: a list of
    tensors laid out as the trained leaves `paths` of `params` (adamw's
    mu and nu, MultiSteps' accumulator) takes their specs verbatim, so the
    update stays local to each rank's slices.  Other leaves (the counts)
    take the shape-based fsdp rule when `mesh` is given, else stay
    replicated."""
    leaves = dict(tree_leaves(params))
    shapes = [tuple(leaves[p].shape) for p in paths]

    def fallback(x):
        if mesh is None or not x.ndim:
            return ()
        return _with_axis((), tuple(x.shape), mesh.shape[axis], axis)

    specs = {}

    def rec(node, path):
        if (isinstance(node, list) and len(node) == len(paths)
                and all(isinstance(t, torch.Tensor) for t in node)
                and [tuple(t.shape) for t in node] == shapes):
            specs.update({path + (i,): param_specs[p] for i, p in enumerate(paths)})
        elif isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + (i,))
        elif isinstance(node, torch.Tensor):
            specs[path] = fallback(node)
    rec(opt_state, ())
    return specs


def batch_spec(mesh: Mesh) -> tuple:
    return ("dp",)


def _sharded_dims(spec: tuple):
    return [(i, a) for i, a in enumerate(spec) if a is not None]


def shard_tree(tree, mesh: Mesh, specs: dict):
    """The tree with each leaf cut to this rank's slice along its spec's
    dims (a copy, so the whole leaf can be freed); replicated leaves are
    the same tensors."""
    new = {}
    for path, x in tree_leaves(tree):
        dims = _sharded_dims(specs.get(path, ()))
        if not dims:
            continue
        for i, axis in dims:
            n = x.shape[i] // mesh.shape[axis]
            x = x.narrow(i, mesh.index(axis) * n, n)
        new[path] = x.clone()
    return tree_replace(tree, new)


def gather_tree(tree, mesh: Mesh, specs: dict):
    """The inverse of shard_tree: every sharded leaf gathered whole from
    the ranks of its spec's axes (each rank must call it)."""
    new = {}
    for path, x in tree_leaves(tree):
        dims = _sharded_dims(specs.get(path, ()))
        if not dims:
            continue
        for i, axis in dims:
            x = collectives.all_gather(x, i, mesh.group(axis))
        new[path] = x
    return tree_replace(tree, new)
