"""Native checkpoints: the port's param trees in safetensors, in the JAX
package's flattened layout (counterpart of moshi_tpu/models/native_ckpt.py),
so either package loads what the other saved.

Keys are '/'-joined tree paths.  A `QTensor` leaf is stored as `<path>#q` /
`<path>#scale`, a `QTensor4` as `<path>#q4` / `<path>#scale4`, a list's
length as `<path>#len`, an empty dict as a `<path>#empty` sentinel (Mimi
trees hold empty `output_projs` entries), and Mimi's conv weights in the
JAX package's [K, Cin/g, Cout] (`save_mimi_params` / `load_mimi_params`
convert).  A q4 leaf of the older
two-plane packing (its q has as many axes as its scale) is repacked on
load.  A `LoRAWeight` is stored as a `__lora__` node holding its base (in
the encodings above), a, b and an f32 scalar `scaling`, as the JAX package
writes it.
"""

from pathlib import Path

import torch

from .lora import LoRAWeight
from ..utils.quantize import QTensor, QTensor4, repack_legacy_q4
from ..utils.safetensors import load_file, save_file


def flatten_tree(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Tree (QTensor / QTensor4 / LoRAWeight leaves included) -> flat
    {path: tensor}."""
    out = {}
    if isinstance(tree, LoRAWeight):
        out.update(flatten_tree({"__lora__": {
            "base": tree.base, "a": tree.a, "b": tree.b,
            "scaling": torch.tensor(tree.scaling, dtype=torch.float32)}}, prefix))
    elif isinstance(tree, QTensor):
        out[prefix + "#q"], out[prefix + "#scale"] = tree.q, tree.scale
    elif isinstance(tree, QTensor4):
        out[prefix + "#q4"], out[prefix + "#scale4"] = tree.q, tree.scale
    elif isinstance(tree, dict):
        if not tree and prefix:
            out[prefix + "#empty"] = torch.tensor(0, dtype=torch.int32)
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        out[prefix + "#len"] = torch.tensor(len(tree), dtype=torch.int32)
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def unflatten_tree(flat: dict[str, torch.Tensor]) -> dict:
    """Inverse of flatten_tree."""
    root: dict = {}
    lists: dict = {}
    qts: dict = {}
    for key, value in flat.items():
        if "#" in key:
            base, field = key.rsplit("#", 1)
            if field == "len":
                lists[base] = int(value)
            elif field == "empty":
                _insert(root, base.split("/"), {})
            else:
                qts.setdefault(base, {})[field] = value
            continue
        _insert(root, key.split("/"), value)
    for base, parts in qts.items():
        if "q4" in parts:
            if parts["q4"].ndim == parts["scale4"].ndim:
                leaf = repack_legacy_q4(parts["q4"], parts["scale4"])
            else:
                leaf = QTensor4(parts["q4"], parts["scale4"])
        else:
            leaf = QTensor(parts["q"], parts["scale"])
        _insert(root, base.split("/"), leaf)
    for base in sorted(lists, key=len, reverse=True):
        node, last = _walk(root, base.split("/"))
        d = node.get(last, {})
        node[last] = [d[str(i)] for i in range(lists[base])]
    return _rebuild_lora(root)


def _rebuild_lora(tree):
    """Every `__lora__` node of an unflattened tree as a LoRAWeight."""
    if isinstance(tree, dict):
        if "__lora__" in tree:
            node = tree["__lora__"]
            missing = {"base", "a", "b", "scaling"} - set(node)
            if len(tree) > 1 or missing:
                raise ValueError(f"a __lora__ node without {sorted(missing)} or beside "
                                 f"{sorted(set(tree) - {'__lora__'})}")
            return LoRAWeight(_rebuild_lora(node["base"]), node["a"], node["b"],
                              float(node["scaling"]))
        return {k: _rebuild_lora(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild_lora(v) for v in tree]
    return tree


def save_params(path: str | Path, params: dict) -> int:
    """Write a param tree (on any device); returns the bytes written."""
    return save_file(flatten_tree(params), path)


def load_params(path: str | Path, device=None) -> dict:
    """The param tree of a native checkpoint, its leaves on `device` (views
    of the mapped file when None)."""
    return unflatten_tree(load_file(path, device))


def save_mimi_params(path: str | Path, mimi, params: dict) -> int:
    """Write a Mimi tree with its conv weights in the JAX package's layout,
    which native checkpoints hold (the caller's tree is left as it is);
    returns the bytes written."""
    tree = _copy_nodes(params)
    mimi.relayout_jax_convs(tree, to_jax=True)
    return save_params(path, tree)


def load_mimi_params(path: str | Path, mimi, device=None) -> dict:
    """A native Mimi tree, its conv weights in the port's layout."""
    params = load_params(path, device)
    mimi.relayout_jax_convs(params)
    return params


def _copy_nodes(tree):
    """New dicts and lists over the same leaves."""
    if isinstance(tree, dict):
        return {k: _copy_nodes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_nodes(v) for v in tree]
    return tree


def _insert(root, parts, value):
    node, last = _walk(root, parts)
    node[last] = value


def _walk(root, parts):
    node = root
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    return node, parts[-1]
