"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Code names *logical* axes ("rows", "queries", ...); this module maps them to
the physical axes of a :class:`repro_torch.launch.mesh.Mesh`. One table
serves the single-pod (data, model) and multi-pod (pod, data, model) meshes:
"pod" is pure data parallelism, so an axis on "data" joins "pod" when the
mesh has one.

ANN index scheme (``core/shard.py``, ``core/search.py``,
``core/search_sharded.py``):
  * rows    -> data (+pod)  graph adjacency rows of a sharded build, and the
                            corpus rows of corpus-sharded serving
  * queries -> data (+pod)  query tiles of query-sharded serving

The reference's ``pspec`` and ``tree_pspecs`` build ``PartitionSpec``
objects for XLA's partitioner; here a rank holds a tensor whole or holds its
own block of it, and :func:`local_block` is that block: the counterpart of
placing a leaf with ``NamedSharding(mesh, pspec(mesh, *logical))``. Each
dim of the leaf splits over the physical axes its logical axis resolves to,
its blocks in the row-major order of those axes (("data", "model") puts
data outermost, as XLA does), and :func:`gather_block` reverses it. A dim
that the axes' count does not divide raises a ``ValueError`` that names the
leaf (the reference would need uneven shards). ``constrain`` has no
counterpart: the code that computes on a block says which.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# logical axis -> physical mesh axis (or tuple). None = replicated.
RULES: dict[str, object] = {
    "fsdp": ("data", "model"),   # ZeRO-3 param storage: flat 256/512-way
    "expert_ff": "data",         # MoE expert d_ff (experts already on model)
    "batch": "data",
    "seq": "model",          # sequence-parallel activations between blocks
    "seq_kv": None,          # gathered KV inside attention
    "kv_heads": None,
    "d_head": None,
    "d_model": None,
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "tokens_flat": ("data", "model"),   # flattened (B@data, S@model) tokens
    "layers": None,
    "edges": "data",         # GNN edge arrays (width goes on 'model')
    "nodes": None,
    "triplets": ("data", "model"),
    "table_rows": ("data", "model"),
    "embed_dim": None,
    "fields": None,
    "candidates": ("data", "model"),
    "cache_seq": "model",    # decode KV cache: flash-decoding split over seq
    "cache_batch": "data",
    "cache_seq_flat": ("data", "model"),
    "mlp_hidden": None,
    "none": None,
    # --- ANN index axes (sharded construction + serving) ---
    "rows": "data",          # graph adjacency rows (sharded build)
    "queries": "data",       # query tiles (sharded serving)
}


def physical_axes(mesh, logical: str):
    """The physical axis (or tuple of axes) ``logical`` resolves to on
    ``mesh``; None = replicated."""
    ax = RULES.get(logical, None)
    if ax is None:
        return None
    axes = ax if isinstance(ax, tuple) else (ax,)
    present = tuple(a for a in axes if a in mesh.axis_names)
    if not present:
        return None
    # 'pod' joins every data-parallel axis
    if "data" in present and "pod" in mesh.axis_names:
        present = ("pod",) + present
    return present if len(present) > 1 else present[0]


def mesh_axes(mesh, logical: str) -> tuple[str, ...]:
    """Physical mesh axis names a logical axis resolves to on ``mesh``, as a
    tuple (empty = replicated): the axes a collective spans."""
    ax = physical_axes(mesh, logical)
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def axis_count(mesh, logical: str) -> int:
    """Number of shards a logical axis splits into on ``mesh`` (1 = replicated)."""
    count = 1
    for a in mesh_axes(mesh, logical):
        count *= mesh.shape[a]
    return count


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(a, (str, type(None))) for a in v)


def dim_axes(mesh, logical_axes) -> list[tuple[str, ...]]:
    """Per dim of a leaf, the physical axes it splits over (empty: whole)."""
    return [mesh_axes(mesh, l) if l else () for l in logical_axes]


def sharded_axes(mesh, logical_axes) -> tuple[str, ...]:
    """The mesh axes a leaf with these logical axes splits over, in mesh
    order; the others hold copies of its blocks."""
    used = {a for ax in dim_axes(mesh, logical_axes) for a in ax}
    return tuple(a for a in mesh.axis_names if a in used)


def replicated_axes(mesh, logical_axes) -> tuple[str, ...]:
    """The mesh axes over which every rank holds the same block."""
    used = set(sharded_axes(mesh, logical_axes))
    return tuple(a for a in mesh.axis_names if a not in used)


def _count(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def coords(mesh, rank: int | None = None) -> dict[str, int]:
    """A rank's index along every axis of the mesh (row-major grid)."""
    rank = mesh.rank if rank is None else rank
    idx = np.unravel_index(rank, tuple(mesh.shape[a] for a in mesh.axis_names))
    return {a: int(i) for a, i in zip(mesh.axis_names, idx)}


def index_along(mesh, axes, rank: int | None = None) -> int:
    """A rank's row-major index over ``axes`` (in mesh order)."""
    c = coords(mesh, rank)
    axes = [a for a in mesh.axis_names if a in axes]
    return int(np.ravel_multi_index(tuple(c[a] for a in axes),
                                    tuple(mesh.shape[a] for a in axes))) if axes else 0


def block_shape(shape, mesh, logical_axes, name: str = "leaf") -> tuple[int, ...]:
    """The shape of one block of a leaf of ``shape`` placed by
    ``logical_axes`` (a ValueError naming ``name`` if a dim does not
    divide)."""
    shape = tuple(shape)
    if len(logical_axes) != len(shape):
        raise ValueError(f"{name}: {len(logical_axes)} logical axes for shape {shape}")
    out = []
    for n, axes in zip(shape, dim_axes(mesh, logical_axes)):
        d = _count(mesh, axes)
        if n % d:
            raise ValueError(f"{name}: dim of {n} does not split over {axes} ({d} ways); "
                             f"shape {shape}, logical axes {tuple(logical_axes)}")
        out.append(n // d)
    return tuple(out)


def local_block(t: torch.Tensor, mesh, logical_axes, name: str = "leaf",
                rank: int | None = None) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` (a view where slicing
    allows)."""
    bs = block_shape(t.shape, mesh, logical_axes, name)
    for dim, (axes, n) in enumerate(zip(dim_axes(mesh, logical_axes), bs)):
        if axes:
            t = t.narrow(dim, index_along(mesh, axes, rank) * n, n)
    return t


def gather_block(block: torch.Tensor, mesh, logical_axes, over=None) -> torch.Tensor:
    """The whole leaf from every rank's block (every rank calls it): an
    all_gather per split dim, the last dim first. ``over``: gather over
    these mesh axes only (the others stay split). Differentiable (the
    gradient comes back to the block, reduce-scattered)."""
    from repro_torch.distributed import comm
    per_dim = dim_axes(mesh, logical_axes)
    for dim in reversed(range(len(per_dim))):
        axes = per_dim[dim]
        if over is not None:
            axes = tuple(a for a in axes if a in over)
        if axes:
            block = comm.all_gather(block, mesh, axes, dim=dim)
    return block


def tree_map_axes(fn, tree, axes_tree, path: str = ""):
    """``fn(leaf, logical_axes, name)`` over the tensor leaves of ``tree``,
    with the logical axes at the same place of ``axes_tree`` (dicts by key,
    NamedTuples by field, lists by index; a tuple of names is a leaf's
    axes). Returns the same structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        if not _is_axes(axes_tree):
            raise ValueError(f"{path or 'leaf'}: no logical axes for a leaf of shape "
                             f"{tuple(tree.shape)}")
        return fn(tree, axes_tree, path or "leaf")
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_axes(fn, getattr(tree, f), getattr(axes_tree, f),
                                          f"{path}.{f}") for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map_axes(fn, v, axes_tree[k], f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_axes(fn, v, a, f"{path}[{i}]")
                          for i, (v, a) in enumerate(zip(tree, axes_tree)))
    raise TypeError(f"{path}: unexpected leaf {type(tree).__name__}")


def leaf_axes(axes_tree, like) -> list:
    """The logical axes of every tensor leaf of ``like``, in the flatten
    order of ``checkpoint.flatten``."""
    from repro_torch.checkpoint.checkpoint import flatten

    class _Ax:                         # an opaque leaf for flatten
        def __init__(self, ax):
            self.ax = ax

    held = tree_map_axes(lambda t, ax, name: _Ax(ax), like, axes_tree)
    return [a.ax for _, a in flatten(held)]


def tree_local_blocks(tree, mesh, axes_tree):
    """Every leaf's block on this rank, each a tensor of its own (the whole
    leaves can be freed)."""
    return tree_map_axes(lambda t, ax, name: local_block(t, mesh, ax, name).clone(),
                         tree, axes_tree)


def tree_gather_blocks(tree, mesh, axes_tree):
    """Every leaf whole again, on every rank."""
    return tree_map_axes(lambda t, ax, name: gather_block(t, mesh, ax), tree, axes_tree)
