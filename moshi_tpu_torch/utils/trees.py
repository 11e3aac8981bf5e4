"""Helpers for batched streaming state (counterpart of
moshi_tpu/utils/trees.py).

Streaming state is a tree of dicts and lists whose leaves are tensors with a
batch axis, plus leaves without one (the batch's `torch.Generator`, None).
The batch axis is not always leading: stacked-layer caches are [L, B, ...],
and at B == num_layers a shape rule cannot tell the two apart.  So
`state_batch_axes` finds it structurally: it builds the state at batch
sizes 1 and 2 on the meta device (nothing is allocated) and takes the axis
whose size differs.

Per-slot reset, extraction and insertion work in place on the live tensors.
`masked_reset` writes fresh values into the masked slots from a state built
at batch size 1: it never builds a second full state next to the live one
(the JAX package had to jit its reset with donation to avoid exactly that
OOM at max batch, moshi_tpu serve/batched_moshi.py:153-158).
"""

import torch

META = torch.device("meta")


def _map(fn, *trees):
    """Apply fn leaf-wise over trees of the same structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(tr[k] for tr in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def batch_axes(tree_b1, tree_b2):
    """Leaf-wise batch axis from the same state built at two batch sizes;
    None for leaves without one (a generator, None, an equal shape)."""
    def axis(a, b):
        if not isinstance(a, torch.Tensor):
            return None
        if a.ndim != b.ndim:
            raise ValueError(f"leaf ranks differ: {tuple(a.shape)} vs {tuple(b.shape)}")
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diff) > 1:
            raise ValueError(f"several batch-dependent axes: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        return diff[0] if diff else None
    return _map(axis, tree_b1, tree_b2)


def state_batch_axes(init_fn):
    """Batch-axis tree of `init_fn(batch_size, device) -> state`, built at
    batch sizes 1 and 2 on the meta device."""
    return batch_axes(init_fn(1, META), init_fn(2, META))


def _slots(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long).reshape(-1).to(device)


def masked_reset(state, init_state, reset_mask, axes):
    """Where reset_mask[b] is True, overwrite slot b of every leaf of
    `state` in place with the values of `init_state`, a fresh state at
    batch size 1.  Leaves with axis None are left as they are.  Returns
    state."""
    mask = torch.as_tensor(reset_mask, dtype=torch.bool).reshape(-1).cpu()
    idx = mask.nonzero()[:, 0]
    if len(idx) == 0:
        return state

    def reset(s, fresh, ax):
        if ax is None:
            return s
        if fresh.shape[ax] != 1:
            raise ValueError(f"masked_reset: init_state leaf {tuple(fresh.shape)} is not "
                             f"at batch size 1 on axis {ax}")
        shape = list(s.shape)
        shape[ax] = len(idx)
        s.index_copy_(ax, idx.to(s.device), fresh.to(s.device, s.dtype).expand(shape))
        return s

    _map(reset, state, init_state, axes)
    return state


def copy_into(state, fresh):
    """Write every tensor leaf of `fresh` into the same leaf of `state`, in
    place, so that whatever holds state's tensors (a captured CUDA graph)
    sees the new values; other leaves (a generator) are left as they are.
    Returns state."""
    def put(s, f):
        if isinstance(s, torch.Tensor):
            s.copy_(f)
        return s
    _map(put, state, fresh)
    return state


def take_slots(state, idx, axes):
    """A new state holding slots `idx` ([N] ints) of every leaf, with a
    size-N batch axis; leaves with axis None are passed through whole."""
    def take(s, ax):
        return s if ax is None else s.index_select(ax, _slots(idx, s.device))
    return _map(take, state, axes)


def put_slots(state, slot_state, idx, axes):
    """Inverse of take_slots: write `slot_state` (a size-N batch axis) into
    slots `idx` of every leaf of `state`, in place.  Returns state."""
    def put(s, v, ax):
        if ax is not None:
            s.index_copy_(ax, _slots(idx, s.device), v.to(s.device, s.dtype))
        return s
    _map(put, state, slot_state, axes)
    return state


def map_tensors(state, fn):
    """`state` with every tensor leaf replaced by fn(leaf) (`torch.clone`:
    copies on their devices, in the current stream's order); other leaves
    are passed through."""
    return _map(lambda s: fn(s) if isinstance(s, torch.Tensor) else s, state)


def to_device(state, device):
    """`state` with every tensor leaf moved to `device` (a leaf already
    there is kept, not copied); other leaves are passed through."""
    return map_tensors(state, lambda s: s.to(device))
