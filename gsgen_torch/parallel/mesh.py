"""Process groups, the device mesh and batch sharding.

Port of the JAX package's ``parallel/mesh.py`` onto ``torch.distributed``.
Each rank is a process; a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes (``data``
for views, ``tile`` for image rows, ``gauss`` for scene rows).  Where the
JAX helpers place a global array with a sharding, the torch ones return
this rank's part of it: :func:`shard_batch` keeps the rank's rows of the
leading axis and :func:`replicate` broadcasts rank 0's tensors.
:func:`replicated` and :func:`batch_sharded` give the same layouts as
DTensor placements.

:func:`spawn_ranks` starts the ranks of a run on one host (start method
``spawn``) and joins them through a ``FileStore`` in a fresh temporary
directory, so that runs side by side never share a port.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(init_method: Optional[str] = None,
                     world_size: int = 1, rank: int = 0,
                     backend: Optional[str] = None) -> bool:
    """Join the process group; a no-op for one process without an
    ``init_method`` or when the group exists already.  ``backend``
    defaults to NCCL where CUDA is available, else gloo.  True when this
    call created the group."""
    if dist.is_initialized() or (world_size <= 1 and init_method is None):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    return True


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """A mesh over the group's ``n_devices`` ranks (all of them by
    default): 1-D ``data`` by default, ``axes=("data", "tile")`` with
    ``shape=(d, t)`` for 2-D sharding.  The group must exist
    (:func:`init_distributed`)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    n = n_devices or dist.get_world_size()
    if shape is None:
        if len(axes) != 1:
            raise ValueError("a mesh of several axes needs its shape")
        shape = (n,)
    if int(np.prod(shape)) != n or n != dist.get_world_size():
        raise ValueError(f"mesh shape {tuple(shape)} over {n} devices, "
                         f"world size {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def replicated(mesh):
    """DTensor placements of a fully replicated tensor."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def batch_sharded(mesh, axis: str = "data"):
    """DTensor placements of a tensor whose leading axis is split over
    ``axis``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if a == axis else Replicate()
                 for a in mesh.mesh_dim_names)


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor or array of dicts, lists, tuples (named ones
    too) and dataclasses; other leaves stay as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shard_rows(x, n_shards: int, index: int):
    """Rows ``[index * n / n_shards, (index + 1) * n / n_shards)`` of ``x``."""
    n = x.shape[0]
    if n % n_shards:
        raise ValueError(f"leading axis {n} does not divide by {n_shards}")
    k = n // n_shards
    return x[index * k:(index + 1) * k]


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of the leading axis of every tensor or array in
    ``batch`` (the JAX helper places [B, ...] arrays sharded over
    ``axis``)."""
    D, d = axis_size(mesh, axis), axis_rank(mesh, axis)
    return tree_map(lambda x: shard_rows(x, D, d) if x.ndim >= 1 else x,
                    batch)


def replicate(tree, mesh, axis: Optional[str] = None):
    """Every tensor of ``tree`` broadcast from rank 0 of the mesh (of
    ``axis`` only, where given); returns new tensors."""
    groups = ([axis_group(mesh, axis)] if axis is not None
              else [axis_group(mesh, a) for a in mesh.mesh_dim_names])

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        from .collectives import broadcast
        y = x.detach().clone()
        for g in groups:
            broadcast(y, g)
        return y
    return tree_map(bcast, tree)


def _rank_entry(rank: int, fn: Callable, world_size: int, store: str,
                backend: str, device_type: str, args: tuple) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args: Any,
                device_type: str = "cpu",
                backend: Optional[str] = None) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes that share
    one process group (NCCL for ``cuda``, gloo for ``cpu`` unless
    ``backend`` says otherwise; a CUDA rank uses card ``rank % count``).
    ``fn`` and ``args`` must pickle: ``fn`` is imported by name.  Returns
    when every rank has ended; a rank that raised raises here."""
    import torch.multiprocessing as mp
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    with tempfile.TemporaryDirectory(prefix="gsgen_ranks_") as tmp:
        mp.start_processes(
            _rank_entry, args=(fn, world_size, os.path.join(tmp, "store"),
                               backend, device_type, args),
            nprocs=world_size, join=True, start_method="spawn")
