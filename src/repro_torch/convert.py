"""Carry state between the reference package and the port, through numpy.

The reference's arrays come across with ``np.asarray``; nothing here imports
the reference. Distance keys: the port's int32 key ``k`` and the reference's
uint32 ``dist_key`` ``u`` satisfy ``u == k ^ 0x80000000`` bit for bit.
Recsys, transformer and DimeNet parameters and train states cross as the
reference's nested dicts of arrays; a bfloat16 leaf crosses as its bits
(the reference's ``ml_dtypes`` array, or a ``|V2`` payload, to a
``torch.bfloat16`` tensor; back as a ``|V2`` array, which
``a.view(jnp.bfloat16)`` reads).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import Graph
from repro_torch.models import dimenet as dm
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import OptState
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



def _leaf_from_numpy(a, dev: torch.device) -> torch.Tensor:
    """An array as a tensor of its own dtype on ``dev``; a 2-byte bfloat16
    (``ml_dtypes``' or a ``|V2`` payload) as ``torch.bfloat16`` bits."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and (a.dtype.name == "bfloat16" or a.dtype.kind == "V"):
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _tree_from_numpy(tree, want: dict, dev: torch.device, path: str = ""):
    """A nested dict of arrays -> tensors, every leaf of the shape ``want``
    (a tree of meta tensors) gives it, no key missing or extra."""
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'params'}: keys {got}, expected {sorted(want)}")
        return {k: _tree_from_numpy(tree[k], want[k], dev, f"{path}.{k}".lstrip("."))
                for k in want}
    t = _leaf_from_numpy(tree, dev)
    if tuple(t.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(t.shape)}, expected {tuple(want.shape)}")
    return t


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    return _leaf_to_numpy(tree)


def transformer_params_from_numpy(params, cfg: tf.TransformerConfig,
                                  device: str | torch.device = "cuda") -> dict:
    """The reference's transformer ``init`` tree (``embed.table``,
    ``head.w``, ``layers.*`` stacked (L, ...), ``ln_f``) -> the port's
    parameters on ``device``, each leaf in its own dtype (f32, or bfloat16
    bits), every shape checked against ``param_table(cfg)``."""
    return _tree_from_numpy(params, tf.init(None, cfg, device="meta"), resolve_device(device))


def transformer_params_to_numpy(params: dict) -> dict:
    """The port's transformer parameters -> the same tree of numpy arrays
    (bfloat16 leaves as ``|V2`` bits)."""
    return _tree_to_numpy(params)


def dimenet_params_from_numpy(params, cfg: dm.DimeNetConfig,
                              device: str | torch.device = "cuda") -> dict:
    """The reference's DimeNet ``init`` tree (``node_in.w``, ``edge_in.w``,
    ``blocks.*`` stacked (B, ...), ``out_node.w``, ``out_final.w``) -> the
    port's parameters on ``device``, every shape checked against
    ``param_table(cfg)``."""
    return _tree_from_numpy(params, dm.init(None, cfg, device="meta"), resolve_device(device))


def dimenet_params_to_numpy(params: dict) -> dict:
    """The port's DimeNet parameters -> the same tree of numpy arrays."""
    return _tree_to_numpy(params)


def _model_shapes(cfg) -> dict:
    if isinstance(cfg, tf.TransformerConfig):
        return tf.init(None, cfg, device="meta")
    if isinstance(cfg, dm.DimeNetConfig):
        return dm.init(None, cfg, device="meta")
    return rs.init(None, cfg, device="meta")


def train_state_from_numpy(state, cfg, device: str | torch.device = "cuda"):
    """The reference's ``TrainState(params, OptState(step, m, v, master),
    residual)`` of a transformer, DimeNet or recsys model (``cfg`` says
    which) -> the port's ``train.step.TrainState`` on ``device``; ``None``
    subtrees stay ``None``, bfloat16 leaves cross as their bits."""
    from repro_torch.train.step import TrainState
    dev = resolve_device(device)
    want = _model_shapes(cfg)
    conv = lambda t: None if t is None else _tree_from_numpy(t, want, dev)
    opt = state.opt
    return TrainState(conv(state.params),
                      OptState(_leaf_from_numpy(opt.step, dev), conv(opt.m), conv(opt.v),
                               conv(opt.master)),
                      conv(state.residual))


def train_state_to_numpy(state):
    """The port's ``TrainState`` -> the same NamedTuples of numpy trees."""
    from repro_torch.train.step import TrainState
    conv = lambda t: None if t is None else _tree_to_numpy(t)
    opt = state.opt
    return TrainState(conv(state.params),
                      OptState(_leaf_to_numpy(opt.step), conv(opt.m), conv(opt.v),
                               conv(opt.master)),
                      conv(state.residual))
