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

The reference's ``pspec``, ``sharding``, ``constrain`` and the ``tree_*``
helpers build ``PartitionSpec``/``NamedSharding`` objects for XLA's
partitioner, which has no counterpart here: a rank holds a tensor whole or
holds its own block, and the code that slices it says which
(``core/shard.local_rows``, ``distributed/ann.place_rows``). Only the
table and the resolution of logical axes are ported.
"""
from __future__ import annotations

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
