"""Multi-process initialization and global-batch helpers, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/parallel/distributed.py``. The
JAX package stitches processes into one device list
(``jax.distributed``); here each process is one rank of a
``torch.distributed`` process group with one device, and
``mesh.make_mesh()`` gives its :class:`~.mesh.DataGroup`.

Usage, once per process before any other work (a ``torchrun``-style
launcher may set ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK`` instead of the arguments):

    from deepgraphpose_tpu_torch.parallel import distributed, mesh
    distributed.initialize(coordinator_address="10.0.0.1:8476",
                           num_processes=4, process_id=rank)
    group = mesh.make_mesh()                   # this rank's DataGroup
    fit_dgp(dlcpath=P, data_parallel=True)     # every rank calls it

Backends: NCCL where each rank owns its card, gloo on the CPU or where
ranks share a card (NCCL refuses two ranks on one device; gloo's
``all_reduce`` and ``broadcast`` take CUDA tensors).
"""

from __future__ import annotations

import os

import torch

from deepgraphpose_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, DataGroup, replicate)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, device=None,
               backend: str | None = None) -> torch.device:
    """Join the process group over ``tcp://coordinator_address`` and
    return this rank's device, made the current CUDA device (idempotent
    per process).

    Rank r computes on ``cuda:(local_rank % torch.cuda.device_count())``
    (``local_rank`` is ``LOCAL_RANK``, else r), or on
    ``cuda:local_device_ids[0]``; ``device="cpu"`` keeps it on the CPU.
    ``backend`` defaults to NCCL when each of the host's ranks
    (``LOCAL_WORLD_SIZE``, else ``num_processes``) has a card of its own,
    and to gloo on the CPU or when ranks share a card."""
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"] if num_processes is None
                else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device is not None:
        dev = torch.device(device)
    elif not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the process group on the CPU")
    else:
        cards = torch.cuda.device_count()
        index = (int(local_device_ids[0]) if local_device_ids
                 else local_rank % cards)
        dev = torch.device("cuda", index)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        shared = local_world > torch.cuda.device_count()
        backend = backend or ("gloo" if shared else "nccl")
    else:
        backend = backend or "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank)
    return dev


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def global_batch(group: DataGroup, local_tree):
    """This rank's part of a global batch, as tensors on its device: each
    process passes its own slice of the leading axis (the JAX package
    assembles one global array; here each rank keeps its slice)."""
    import numpy as np

    from deepgraphpose_tpu_torch.parallel.mesh import _tree_map

    def one(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(group.device)

    return _tree_map(one, local_tree)


def replicate_from_host0(group: DataGroup, tree):
    """Rank 0's values on every rank (a broadcast)."""
    return replicate(tree, group)


def local_slice(n_global: int, group: DataGroup | None = None) -> slice:
    """This process's contiguous slice of a leading global-batch axis."""
    if group is None:
        import torch.distributed as dist

        live = dist.is_available() and dist.is_initialized()
        group = DataGroup(dist.get_rank() if live else 0,
                          dist.get_world_size() if live else 1)
    return group.shard(n_global)
