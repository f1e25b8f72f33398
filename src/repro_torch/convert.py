"""Carry state between the reference package and the port, through numpy.

The reference's arrays come across with ``np.asarray``; nothing here imports
the reference. Distance keys: the port's int32 key ``k`` and the reference's
uint32 ``dist_key`` ``u`` satisfy ``u == k ^ 0x80000000`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import Graph


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


def key_to_reference(k) -> np.ndarray:
    """Port int32 key (tensor or array) -> the reference's uint32 key."""
    a = k.cpu().numpy() if isinstance(k, torch.Tensor) else np.asarray(k)
    return a.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)


def key_from_reference(u) -> torch.Tensor:
    """The reference's uint32 key -> the port's int32 key (CPU tensor)."""
    a = np.asarray(u, np.uint32) ^ np.uint32(0x80000000)
    return torch.from_numpy(a.view(np.int32).copy())
