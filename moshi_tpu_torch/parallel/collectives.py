"""The collectives a data-parallel train step needs, over one process
group: a sum, a gather along a dim and a summing scatter along a dim.

The group's backend carries them: NCCL for CUDA tensors, gloo for CPU
ones.  Gloo also takes CUDA tensors (two ranks sharing one card, where
NCCL refuses), and then moves them through host memory itself: the
trainer says so where it joins such a group (train.DataParallel).  A group
of None is a mesh axis of one rank, over which every collective returns
its input."""

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks, in place (t contiguous)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' t concatenated along `dim`, in rank order."""
    n = size(group)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along `dim` of the sum of t over the group (t's
    `dim` a multiple of the group's size)."""
    n = size(group)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()
