"""Checkpointing with atomic commit, async flush and keep-k GC (port of
``repro.checkpoint``): numpy ``.npz`` shards and a JSON manifest, in the
reference's layout, so either package restores what the other saved.

Layout:
    <dir>/step_000000123.tmp/   (written)
        shard_00000.npz         (leaf arrays ``leaf_{i}``, in flatten order)
        manifest.json           (step, names, shapes, dtypes)
    <dir>/step_000000123/       (the atomic rename is the commit)

A crash mid-write leaves only ``*.tmp`` directories, which restore ignores
and GC removes. Leaves are named as ``jax.tree_util.keystr`` names them
(``".x"``, ``".graph.neighbors"``, ``".qx.codes"``, ``"['key']"``,
``"[0]"``) by a flattener over NamedTuples (field order), dicts (sorted
keys), lists and tuples, in which ``None`` has no leaf, as in JAX. Leaves
cross as host numpy arrays; restore places them on ``device``. A bfloat16
leaf is stored as the reference stores one (its 2-byte payload as a
``|V2`` array, manifest dtype ``"bfloat16"``) and restored as bfloat16 by
that dtype.

On a mesh of ranks (``mesh=`` with the tree's logical ``axes``) every leaf
is a rank's block (``distributed/sharding.local_block``): ``save`` gathers
the leaves one at a time and rank 0 writes them whole, in the layout above,
so a mesh checkpoint is the reference's global one; ``restore`` reads the
whole leaves and keeps this rank's blocks. So a state saved on one mesh
restores on another mesh or on one device, and the other way round (the
reference's elastic restore through ``shardings=``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import resolve_device


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten(tree, path: str = "") -> list[tuple[str, object]]:
    """(keystr name, leaf) pairs in JAX's flatten order."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``
    (an iterator, or an iterable of the leaves in flatten order)."""
    return _rebuild(like, iter(leaves))


def _rebuild(like, leaves):
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


# numpy has no bfloat16: such a leaf crosses as its 2-byte payload in a
# void array (``|V2``) with manifest dtype "bfloat16", the layout numpy
# gives the reference's bfloat16 arrays
_BF16 = "bfloat16"


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A copy of the leaf as a numpy array (taken now, so a later flush
    thread never reads memory the caller may reuse) and its manifest
    dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor, bfloat16 by the manifest's dtype."""
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def _gathered(tree, mesh, axes):
    """(name, whole leaf on the host) pairs of a tree of blocks, gathered one
    leaf at a time (every rank takes part; the host copies are rank 0's)."""
    from repro_torch.distributed import sharding as sh
    out = []
    for (name, t), ax in zip(flatten(tree), sh.leaf_axes(axes, tree)):
        whole = sh.gather_block(t.detach(), mesh, ax)
        out.append((name, _to_host(whole) if mesh.rank == 0 else None))
    return out


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         async_flush: bool = False, mesh=None, axes=None) -> threading.Thread | None:
    """Write one committed checkpoint. Returns the flush thread if async.
    On a ``mesh`` every rank calls it with its blocks (``axes``: the tree's
    logical axes); rank 0 writes, and every rank returns once the step is
    committed."""
    if mesh is not None:
        gathered = _gathered(tree, mesh, axes)
        thread = None
        if mesh.rank == 0:
            thread = _write(ckpt_dir, step, [n for n, _ in gathered],
                            [h for _, h in gathered], keep, async_flush=False)
        _barrier(mesh)
        return thread
    os.makedirs(ckpt_dir, exist_ok=True)
    pairs = flatten(tree)
    return _write(ckpt_dir, step, [name for name, _ in pairs],
                  [_to_host(leaf) for _, leaf in pairs], keep, async_flush)


def _barrier(mesh) -> None:
    from repro_torch.distributed import comm
    comm.psum(torch.zeros(1, device=mesh.device), mesh, mesh.axis_names)


def _write(ckpt_dir, step, names, hosted, keep, async_flush):
    os.makedirs(ckpt_dir, exist_ok=True)
    host_leaves = [a for a, _ in hosted]

    def _flush():
        tmp = os.path.join(ckpt_dir, f"step_{step:09d}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "shard_00000.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        manifest = {
            "step": step,
            "names": names,
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": [dt for _, dt in hosted],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                                # atomic commit
        _gc(ckpt_dir, keep)

    if async_flush:
        t = threading.Thread(target=_flush, daemon=True)
        t.start()
        return t
    _flush()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = committed_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"), ignore_errors=True)
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def committed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def manifest_names(ckpt_dir: str, step: int) -> list[str]:
    """Leaf names recorded in a committed step's manifest (keystr form, e.g.
    ``".qx.codes"``): a restorer reads them to find the saved tree's
    optional subtrees before it builds a ``like_tree``."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return list(json.load(f)["names"])


def restore(ckpt_dir: str, step: int, like_tree, device: str | torch.device = "cuda",
            mesh=None, axes=None):
    """Load a committed step into the structure of ``like_tree`` (its leaves
    are placeholders: only the structure is read), as tensors on
    ``device``. On a ``mesh``: this rank's blocks (by ``axes``) of the
    saved whole leaves, on the mesh's device."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    n_like = len(flatten(like_tree))
    if n_like != len(manifest["names"]):
        raise ValueError(
            f"like_tree has {n_like} leaves but step {step} holds "
            f"{len(manifest['names'])}: {manifest['names']}")
    with np.load(os.path.join(path, "shard_00000.npz")) as data:
        leaves = [_from_host(data[f"leaf_{i}"], dt)
                  for i, dt in zip(range(n_like), manifest["dtypes"])]
    if mesh is None:
        return unflatten(like_tree, (t.to(dev) for t in leaves))
    from repro_torch.distributed import sharding as sh
    tree = unflatten(like_tree, leaves)
    return sh.tree_map_axes(lambda t, ax, name: sh.local_block(t, mesh, ax, name).to(dev, copy=True),
                            tree, axes)
