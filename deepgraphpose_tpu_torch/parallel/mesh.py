"""Data groups and sharding helpers, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/parallel/mesh.py``. The JAX
package is a single controller: one process drives a ``Mesh`` and XLA
inserts the collectives that ``NamedSharding`` implies. The torch idiom is
one process a device under ``torch.distributed`` with explicit
collectives, so the mesh becomes a :class:`DataGroup`: this process's
rank, the world size, its device and the process group. The unit of data
parallelism is the same, a batch's leading axis (DGP windows in training,
frames in streaming inference):

* :func:`shard_leading_axis` gives this rank its contiguous slice of a
  batch that every rank holds whole;
* :func:`replicate` broadcasts rank 0's values;
* :meth:`DataGroup.all_reduce_mean_` averages tensors in place over the
  ranks, flattened into one buffer a dtype (one ``all_reduce`` each);
* :meth:`DataGroup.all_sum` sums with autograd through the sum;
* :meth:`DataGroup.all_gather` is made from ``all_reduce``: each rank
  writes its rows into its own slot of a zeroed buffer, and adding zeros
  is exact. gloo has no ``all_gather`` on CUDA tensors, only
  ``all_reduce`` and ``broadcast``, so nothing else is used.

A group of world 1 runs no collective at all: that is how multi-window
updates run on one card.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"


class _AllSum(torch.autograd.Function):
    """Sum over the group's ranks; the gradient is summed the same way, so
    after the gradients are averaged over the ranks every rank holds the
    gradient of the mean of the ranks' losses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        group._all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.group._all_reduce(grad)
        return grad, None


class DataGroup:
    """The ranks of one data-parallel run, as this process sees them: the
    counterpart of ``make_mesh(n_devices)``.

    ``rank``/``world``: this process's place and the group's size;
    ``device``: where this rank computes; ``process_group``: the
    ``torch.distributed`` group (None: the default group, unused at
    world 1).
    """

    def __init__(self, rank: int = 0, world: int = 1, device=None,
                 process_group=None):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device("cpu" if device is None else device)
        self.process_group = process_group

    def __repr__(self) -> str:
        return (f"DataGroup(rank={self.rank}, world={self.world}, "
                f"device={self.device})")

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def shard(self, n_global: int) -> slice:
        """This rank's contiguous slice of a leading axis of ``n_global``."""
        per = n_global // self.world
        if per * self.world != n_global:
            raise ValueError(f"a leading axis of {n_global} does not split "
                             f"over {self.world} ranks")
        return slice(self.rank * per, (self.rank + 1) * per)

    # the collectives: all_reduce and broadcast only (what gloo offers on
    # CUDA tensors)
    def _all_reduce(self, t: torch.Tensor) -> None:
        import torch.distributed as dist

        dist.all_reduce(t, group=self.process_group)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, differentiable."""
        if self.world == 1:
            return x
        return _AllSum.apply(x, self)

    @staticmethod
    def _flat_by_dtype(tensors, op) -> None:
        """``op`` on one flat buffer for each dtype of ``tensors`` (in a
        fixed dtype order, the same on every rank), copied back."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dtype in sorted(by_dtype, key=str):
            ts = by_dtype[dtype]
            flat = torch.cat([t.reshape(-1) for t in ts])
            op(flat)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))

    @torch.no_grad()
    def all_reduce_mean_(self, tensors) -> None:
        """Average ``tensors`` over the ranks in place: one flat buffer and
        one ``all_reduce`` for each dtype."""
        if self.world > 1:
            def mean(flat):
                self._all_reduce(flat)
                flat /= self.world

            self._flat_by_dtype(tensors, mean)

    @torch.no_grad()
    def broadcast_(self, tensors, src: int = 0) -> None:
        """Overwrite ``tensors`` with rank ``src``'s, one flat buffer a
        dtype."""
        if self.world > 1:
            import torch.distributed as dist

            self._flat_by_dtype(tensors, lambda flat: dist.broadcast(
                flat, src=src, group=self.process_group))

    @torch.no_grad()
    def all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """(L, ...) on each rank -> (world * L, ...) in rank order on every
        rank, through one ``all_reduce`` of a zeroed (world, L, ...)
        buffer."""
        if self.world == 1:
            return local
        buf = local.new_zeros((self.world, *local.shape))
        buf[self.rank] = local
        self._all_reduce(buf)
        return buf.flatten(0, 1)

    def barrier(self) -> None:
        """Wait for every rank (an ``all_reduce`` of one number)."""
        if self.world > 1:
            self._all_reduce(torch.zeros(1, device=self.device))


def make_mesh(n_devices: int | None = None, device=None) -> DataGroup:
    """The data group of this process. ``n_devices=None`` is the process
    group's world (1 without one); 1 is a world of 1 on this process
    alone (multi-window updates on one device); any other count must be
    the process group's world. ``device`` defaults to the card (the one
    ``distributed.initialize`` made current for this rank)."""
    import torch.distributed as dist

    from deepgraphpose_tpu_torch.core.device import resolve_device

    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    device = resolve_device(device)
    if n_devices is None:
        n_devices = world
    n_devices = int(n_devices)
    if n_devices == 1:
        return DataGroup(0, 1, device)
    if n_devices != world:
        raise ValueError(
            f"a data group of {n_devices} needs a process group of "
            f"{n_devices} ranks (one a device), this one has {world}; "
            "start one process a device (distributed.initialize)")
    return DataGroup(dist.get_rank(), world, device)


def shard_leading_axis(tree, group: DataGroup):
    """This rank's contiguous slice of the leading axis of every leaf of
    ``tree`` (a tensor, a numpy array, or a dict / list / tuple of them),
    on the group's device."""
    def one(x):
        x = x[group.shard(x.shape[0])]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(group.device)

    return _tree_map(one, tree)


def replicate(tree, group: DataGroup):
    """Rank 0's values on every rank: a module's parameters and buffers
    (overwritten in place; returns the module), or each leaf of ``tree``
    as a tensor on the group's device."""
    if isinstance(tree, torch.nn.Module):
        group.broadcast_([t.data for t in (*tree.parameters(),
                                           *tree.buffers())])
        return tree

    def one(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(group.device).clone()

    out = _tree_map(one, tree)
    group.broadcast_(_leaves(out))
    return out


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``arr`` along ``axis`` to a multiple by repeating its last
    entry; returns (padded, n_valid)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(n - 1, n)
    pad_block = np.repeat(arr[tuple(idx)], rem, axis=axis)
    return np.concatenate([arr, pad_block], axis=axis), n


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
