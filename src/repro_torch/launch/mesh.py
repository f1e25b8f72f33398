"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

The reference's mesh is a grid of devices with named axes on which
``shard_map`` runs one program per device. Here the program is SPMD
processes, one rank per shard: every rank of an initialised default process
group calls the same functions on its own rows, and a :class:`Mesh` names
the grid the ranks form (row-major: rank r sits at
``np.unravel_index(r, shape)``), the process group of every slice of its
axes, the backend, and this rank's device.

The backend is an argument, never a guess:
  * ``"nccl"``: one rank per card;
  * ``"gloo"``: CPU ranks, or ranks that share one card (NCCL refuses two
    ranks on one device); the comm layer copies a CUDA tensor through
    pinned host memory for every collective (``distributed/comm.py``).
Nothing picks one backend after another failed.

:func:`spawn` starts the ranks of one group on this host: the ``spawn``
start method (the parent may have initialised CUDA), a ``FileStore`` in a
temporary directory for the rendezvous (no fixed TCP port), a timeout on
every collective (a rank that leaves a loop early fails the run instead of
hanging it), and a child's exception raised in the parent.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a named grid of ranks."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]            # axis name -> size (as ``jax.sharding.Mesh.shape``)
    backend: str
    device: torch.device
    rank: int
    groups: dict                     # frozenset of axes -> (process group, ranks in order)
    stats: object = None             # distributed.comm.CommStats: the layer's counters

    def group(self, axes) -> tuple:
        """(process group, global ranks ordered by their index along
        ``axes``) of the slice of the mesh through this rank that spans
        ``axes``."""
        return self.groups[frozenset(axes)]


def _slices(names, sizes, axes):
    """Every slice spanning ``axes``: lists of global ranks, each ordered by
    the row-major index over ``axes``, the slices in a fixed order."""
    rest = [a for a in names if a not in axes]
    grid = np.arange(math.prod(sizes)).reshape(sizes)
    order = [names.index(a) for a in rest] + [names.index(a) for a in axes]
    g = np.transpose(grid, order).reshape(math.prod(sizes[names.index(a)] for a in rest), -1)
    return [row.tolist() for row in g]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, backend: str,
              device: str | torch.device) -> Mesh:
    """A mesh over the initialised default process group, whose world size
    must be ``prod(shape)`` and whose backend must be ``backend``. Every
    rank calls it with the same arguments (it creates the process groups of
    the axis slices, a collective act)."""
    from repro_torch.distributed.comm import CommStats
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} must pair up, names distinct")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(launch.mesh.init_process_group, or spawn)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' runs on CUDA devices only")
    rank = dist.get_rank()
    groups = {}
    for r in range(len(axes) + 1):
        for sub in itertools.combinations(axes, r):
            members = _slices(list(axes), list(shape), list(sub))
            if len(members) == 1:            # the whole world
                groups[frozenset(sub)] = (None, members[0])
                continue
            for ranks in members:            # every rank creates every group
                pg = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[frozenset(sub)] = (pg, ranks)
    return Mesh(axes, dict(zip(axes, shape)), backend, dev, rank, groups, CommStats())


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production grids as shapes: (data 16, model 16), or
    (pod 2, data 16, model 16), seen from rank 0. No process group stands
    behind it (it takes no ranks to build): it serves the sharding
    arithmetic (``sharding.block_shape``), as the dry run uses it, and any
    collective on it fails."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, dict(zip(axes, shape)), "none", torch.device("meta"), 0, {})


def init_process_group(rank: int, world_size: int, store_path: str, *, backend: str,
                       timeout_s: float = 300.0) -> None:
    """Join the default process group through a ``FileStore`` at
    ``store_path`` (shared by the group's ranks, absent or empty before
    the first rank joins). Every collective fails after ``timeout_s``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
    dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank, fn, world, store_path, backend, timeout_s, args):
    init_process_group(rank, world, store_path, backend=backend, timeout_s=timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), *, backend: str, timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``nprocs`` new processes, each
    a rank of one fresh process group on ``backend``; returns when all have
    ended and raises if any failed. ``fn`` must be importable by name (a
    module-level function) and ``args`` picklable; CUDA tensors among them
    reach the children through CUDA IPC, CPU tensors through shared
    memory."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, nprocs, os.path.join(tmp, "store"), backend, timeout_s, args),
            nprocs=nprocs, join=True, start_method="spawn")
