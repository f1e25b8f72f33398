"""Carry state between the reference package and the port, through numpy.

The reference's arrays come across with ``np.asarray``; nothing here imports
the reference. Distance keys: the port's int32 key ``k`` and the reference's
uint32 ``dist_key`` ``u`` satisfy ``u == k ^ 0x80000000`` bit for bit.
Recsys parameters cross as the reference's nested dicts of arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import Graph
from repro_torch.models import recsys as rs
from repro_torch.quant import QuantizedCorpus


def graph_from_numpy(neighbors, dists, flags, device: str | torch.device = "cuda") -> Graph:
    """(n, M) int32 ids, f32 dists, uint8 flags -> the port's Graph on ``device``."""
    dev = resolve_device(device)
    return Graph(
        torch.tensor(np.asarray(neighbors, np.int32), device=dev),
        torch.tensor(np.asarray(dists, np.float32), device=dev),
        torch.tensor(np.asarray(flags, np.uint8), device=dev),
    )


def graph_to_numpy(g: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(t.cpu().numpy() for t in g)


def quantized_from_numpy(qx, device: str | torch.device = "cuda") -> QuantizedCorpus:
    """``(codes, scale, zero, codebooks)`` arrays (the reference's
    ``QuantizedCorpus`` has these fields in this order; unused ones None)
    -> the port's coded corpus on ``device``."""
    dev = resolve_device(device)
    return QuantizedCorpus(*(None if a is None else torch.tensor(np.asarray(a), device=dev)
                             for a in qx))


def quantized_to_numpy(qx: QuantizedCorpus) -> tuple:
    """(codes, scale, zero, codebooks) as numpy arrays (None where unused)."""
    return tuple(None if a is None else a.cpu().numpy() for a in qx)


def store_from_numpy(st, device: str | torch.device = "cuda"):
    """A streaming store of the reference (its ``Store`` fields in order:
    x, graph, occupied, tombstone, epoch, qx, remap; arrays or None) -> the
    port's :class:`repro_torch.streaming.store.Store` on ``device``, the
    same arrays."""
    from repro_torch.streaming.store import Store
    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a), device=dev)
    return Store(t(st.x), graph_from_numpy(*st.graph, device=dev), t(st.occupied),
                 t(st.tombstone), t(st.epoch),
                 None if st.qx is None else quantized_from_numpy(st.qx, device=dev),
                 t(st.remap))


def key_to_reference(k) -> np.ndarray:
    """Port int32 key (tensor or array) -> the reference's uint32 key."""
    a = k.cpu().numpy() if isinstance(k, torch.Tensor) else np.asarray(k)
    return a.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)


def key_from_reference(u) -> torch.Tensor:
    """The reference's uint32 key -> the port's int32 key (CPU tensor)."""
    a = np.asarray(u, np.uint32) ^ np.uint32(0x80000000)
    return torch.from_numpy(a.view(np.int32).copy())


def recsys_params_from_numpy(params, cfg: rs.RecsysConfig,
                             device: str | torch.device = "cuda") -> dict:
    """The reference's recsys ``init`` tree (nested dicts of arrays: ``table``,
    ``wide``, ``bias``, ``dense_proj.w``, ``mlp.fc{i}.w`` / ``mlp.b{i}``,
    ``cin.w{i}``, ``cin_out.w``) -> the port's parameters, f32 on ``device``.
    Every leaf must have the shape ``cfg`` gives it, and no leaf may be
    missing or extra."""
    dev = resolve_device(device)
    # the port's own init on the meta device: shapes only, nothing allocated
    want = rs.init(None, cfg, device="meta")

    def walk(p, ref, path):
        if isinstance(ref, dict):
            if not isinstance(p, dict) or set(p) != set(ref):
                got = sorted(p) if isinstance(p, dict) else type(p).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, expected {sorted(ref)}")
            return {k: walk(p[k], ref[k], f"{path}.{k}".lstrip(".")) for k in ref}
        a = np.asarray(p, np.float32)
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {tuple(ref.shape)}")
        return torch.tensor(a, device=dev)

    return walk(params, want, "")


def recsys_params_to_numpy(params: dict) -> dict:
    """The port's recsys parameters -> the same tree of f32 numpy arrays."""
    return {k: recsys_params_to_numpy(v) if isinstance(v, dict) else v.float().cpu().numpy()
            for k, v in params.items()}

