"""Dry run: what a cell costs and whether it fits one card, without running
it on the card (the intent of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dimenet --shape molecule
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--include-ann] [--json] \
        [--out PATH]

For each (arch, shape) cell, ``launch.steps.bind`` on ``torch.device("meta")``
gives the state (``init_fn``) and the batch (from ``input_specs``) as
tensors with shapes and dtypes and no storage behind them. Reported:
  * ``params`` (count), ``param_bytes``, ``state_bytes`` (the train
    state's params, moments and master, or the serving params),
    ``batch_bytes``;
  * one step run on the meta device: ``flops``, the matmul FLOPs of
    ``torch.utils.flop_counter.FlopCounterMode`` (forward, backward and
    remat's recomputation; elementwise work is not counted);
    ``saved_bytes``, the bytes of the distinct storages autograd saves for
    the backward (``torch.autograd.graph.saved_tensors_hooks``), the
    state's and the batch's own left out; ``peak_bytes``, the high-water
    mark of the live bytes over the step, the state and the batch counted
    (:class:`LiveBytes`: every storage an op makes is counted from then
    until it is freed); ``temp_bytes`` = ``peak_bytes`` - state - batch,
    the counterpart of the reference's compiled ``temp_bytes``. A serving
    step runs under ``torch.no_grad()`` (it has no backward: nothing is
    saved). ``hand_kernels`` names the hand kernels the step launches on
    the card; ``fm_interact`` (FM and DeepFM) has a meta path, so those
    cells are stepped. The ``ann`` cells (``rng_prune``, or
    ``rng_prune_int8`` for an int8-coded build, and ``beam_score``) are
    not: their sweeps and beam loops end on data, which the meta device
    does not hold. Their ``flops``, ``saved_bytes``, ``peak_bytes``
    and ``temp_bytes`` are null;
  * ``per_rank``: for each of the reference's production meshes
    (``launch.mesh.make_production_mesh``: 16 x 16, 2 x 16 x 16), the
    bytes one rank holds of the state and of the batch when every leaf is
    placed by the cell's ``state_axes`` and ``batch_axes`` (computed from
    the shapes: no ranks are spawned), and the leaves whose dims do not
    split evenly (counted at the larger block, as XLA pads them); and for
    a stepped cell whose leaves all split evenly, rank 0's ``peak_bytes``
    and ``temp_bytes`` from one step of the cell bound on that mesh
    (``bind(mesh=)``) on its blocks, every collective giving a meta output
    of its shape (``distributed/comm.py``). ``not_stepped`` says why a mesh
    was not stepped: a hand kernel, uneven leaves, or the model's own
    refusal of the mesh (DimeNet's bilinear width of 8 over 16 ``model``
    ranks);
  * ``fits_one_card``: ``peak_bytes`` against the card's memory
    (``torch.cuda.get_device_properties(0).total_memory``, or 80 GiB when
    there is no card); for a cell that is not stepped, ``total_bytes`` =
    state + batch + saved bytes, a lower bound.

The reference lowers and compiles each cell on a 256- or 512-device mesh
and parses its HLO for collective bytes (``hlo_analysis.py``); the port
runs on one device, and its collective bytes are the explicit counts of
``analysis.collectives``. ``--out`` writes the JSON of every cell to PATH
and nowhere else.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import weakref

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.obs import trace

CARD_BYTES_DEFAULT = 80 * 2**30
# hand kernels whose wrapper gives a meta tensor a meta output
META_KERNELS = {"fm_interact"}


def hand_kernels(arch_id: str, cfg, kind: str) -> list[str]:
    """The hand kernels a cell's step launches on the card."""
    family = configs.get(arch_id).family
    if family == "ann":
        if kind != "ann_build":
            return ["beam_score"]
        prune = "rng_prune_int8" if cfg.quant.mode == "int8" else "rng_prune"
        return [prune, "bucket_scatter", "bucket_row_merge"]
    if family == "recsys" and kind in ("train", "serve") and \
            cfg.interaction in ("fm", "fm-2way"):
        return ["fm_interact"]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten(tree))


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for _, t in flatten(tree)}


def _meta_batch(specs: dict, device: torch.device) -> dict:
    return {k: _meta_batch(v, device) if isinstance(v, dict) else
            torch.empty(v[0], dtype=v[1], device=device) for k, v in specs.items()}


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive while it is on: ``base`` (what lives
    throughout, e.g. the state and the batch) plus every storage an op's
    output brings that is not ``own`` (the storages behind ``base``) and not
    already live, from the op until the storage is freed (a finalizer on
    it). ``peak`` is the high-water mark. Each counted storage has a serial
    number, so a freed storage's address taken again is a new one."""

    def __init__(self, base: int = 0, own=frozenset()):
        super().__init__()
        self.live, self.peak, self.own = base, base, set(own)
        self.alive: dict = {}           # storage key -> (serial, bytes)
        self.serial = 0

    def _free(self, key, serial, nbytes):
        if self.alive.get(key, (None,))[0] == serial:
            del self.alive[key]
            self.live -= nbytes

    def serial_of(self, storage):
        """The serial of a live counted storage (None: not counted)."""
        return self.alive.get(storage._cdata, (None,))[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.own or key in self.alive:
                continue
            self.serial += 1
            nbytes = st.nbytes()
            self.alive[key] = (self.serial, nbytes)
            self.live += nbytes
            weakref.finalize(st, self._free, key, self.serial, nbytes).atexit = False
        self.peak = max(self.peak, self.live)
        return out


def measure_step(bound, state, batch, base: int | None = None) -> dict:
    """One ``bound.step_fn(state, batch)``: the matmul FLOPs it counts, the
    bytes of the distinct storages autograd saves (the state's and the
    batch's own left out) and the live bytes' peak (:class:`LiveBytes`,
    from ``base``: by default the state's and the batch's bytes). Train
    steps run with grad on, the others under ``no_grad``."""
    own = _storages(state) | _storages(batch)
    base = _nbytes(state) + _nbytes(batch) if base is None else base
    saved: dict = {}
    live = LiveBytes(base, own)

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in own:
            saved[live.serial_of(st) or ("untracked", st._cdata)] = st.nbytes()
        return t

    grad = torch.enable_grad() if bound.kind == "train" else torch.no_grad()
    with grad, FlopCounterMode(display=False) as fc, live, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        bound.step_fn(state, batch)
    return {"flops": int(fc.get_total_flops()), "saved_bytes": int(sum(saved.values())),
            "peak_bytes": int(live.peak), "temp_bytes": int(live.peak - base)}


def _rank_leaves(tree, axes, path=""):
    """(name, leaf, logical axes) of a state or batch; a batch key without
    axes is replicated."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            sub = axes.get(k) if isinstance(axes, dict) else None
            yield from _rank_leaves(tree[k], sub, f"{path}[{k!r}]")
        return
    if isinstance(tree, torch.Tensor):
        yield path, tree, axes if axes is not None else (None,) * tree.dim()
        return
    for (name, t), ax in zip(flatten(tree), sh.leaf_axes(axes, tree)):
        yield path + name, t, ax


def per_rank_bytes(tree, axes, mesh) -> tuple[int, list[str]]:
    """Bytes of one rank's blocks of ``tree`` on ``mesh`` (a dim that does
    not split evenly counts its larger block) and the uneven leaves."""
    total, uneven = 0, []
    for name, t, ax in _rank_leaves(tree, axes):
        n = t.element_size()
        for size, dim_ax in zip(t.shape, sh.dim_axes(mesh, ax)):
            d = math.prod(mesh.shape[a] for a in dim_ax)
            n *= -(-size // d)
            if size % d:
                uneven.append(name)
        total += n
    return total, sorted(set(uneven))


def _local_batch(bound, batch, mesh) -> dict:
    """The batch a step bound on ``mesh`` takes: a train step the global
    batch, a serving step this rank's blocks (a key without axes whole)."""
    if bound.kind == "train":
        return batch
    return {k: sh.tree_map_axes(lambda t, ax, name: sh.local_block(t, mesh, ax, name),
                                v, bound.batch_axes[k]) if k in bound.batch_axes else v
            for k, v in batch.items()}


def rank_step(arch_id: str, shape_name: str, mesh, reduced: bool = False, cfg=None) -> dict:
    """Rank ``mesh.rank``'s ``peak_bytes`` and ``temp_bytes`` over one step
    of the cell bound on ``mesh`` (a meta-device mesh, e.g. a production
    grid), on its blocks of the state (``init_fn`` gives them) and the
    batch (a train step is handed the global batch and narrows it to views
    of the rank's block: the base counts the block)."""
    bound = steps.bind(arch_id, shape_name, reduced=reduced, device="meta", mesh=mesh, _cfg=cfg)
    state = bound.init_fn(None)
    batch = _meta_batch(bound.input_specs, torch.device("meta"))
    base = _nbytes(state) + per_rank_bytes(batch, bound.batch_axes or {}, mesh)[0]
    got = measure_step(bound, state, _local_batch(bound, batch, mesh), base=base)
    return {"peak_bytes": got["peak_bytes"], "temp_bytes": got["temp_bytes"]}


def _per_rank(bound, state, batch, stepped: bool) -> dict | None:
    if bound.state_axes is None:
        return None
    out = {}
    for name, multi in (("16x16", False), ("2x16x16", True)):
        mesh = M.make_production_mesh(multi_pod=multi)
        st, st_uneven = per_rank_bytes(state, bound.state_axes, mesh)
        bt, bt_uneven = per_rank_bytes(batch, bound.batch_axes or {}, mesh)
        uneven = st_uneven + bt_uneven
        out[name] = {"state_bytes": st, "batch_bytes": bt, "uneven": uneven,
                     "peak_bytes": None, "temp_bytes": None, "not_stepped": None}
        if not stepped or uneven:
            out[name]["not_stepped"] = "hand kernel" if not stepped else "uneven leaves"
            continue
        try:
            out[name].update(rank_step(bound.arch_id, bound.shape.name, mesh, cfg=bound.cfg))
        except ValueError as e:          # the model refuses this mesh (e.g. a width over model)
            out[name]["not_stepped"] = str(e)
    return out


def card_bytes() -> int:
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return CARD_BYTES_DEFAULT


def run_cell(arch_id: str, shape_name: str, reduced: bool = False) -> dict:
    """The dry-run record of one cell, built and stepped on the meta
    device."""
    dev = torch.device("meta")
    with trace.timed("dryrun/cell", arch=arch_id, shape=shape_name) as tm:
        bound = steps.bind(arch_id, shape_name, reduced=reduced, device=dev)
        state = bound.init_fn(None)
        batch = _meta_batch(bound.input_specs, dev)
        params = state.params if bound.kind == "train" else state
        kernels = hand_kernels(arch_id, bound.cfg, bound.kind)
        stepped = set(kernels) <= META_KERNELS
        out = {"arch": arch_id, "shape": shape_name, "kind": bound.kind, "reduced": reduced,
               "params": sum(t.numel() for _, t in flatten(params)),
               "param_bytes": _nbytes(params), "state_bytes": _nbytes(state),
               "batch_bytes": _nbytes(batch), "hand_kernels": kernels,
               "flops": None, "saved_bytes": None, "peak_bytes": None, "temp_bytes": None,
               "per_rank": _per_rank(bound, state, batch, stepped and not reduced)}
        if stepped:
            out.update(measure_step(bound, state, batch))
    total = out["state_bytes"] + out["batch_bytes"] + (out["saved_bytes"] or 0)
    need = total if out["peak_bytes"] is None else out["peak_bytes"]
    out.update(total_bytes=total, card_bytes=card_bytes(), fits_one_card=need <= card_bytes(),
               seconds=tm.seconds)
    return out


def _line(r: dict) -> str:
    gib = lambda b: "-" if b is None else f"{b / 2**30:.3f}"
    flops = "-" if r["flops"] is None else f"{r['flops']:.3e}"
    note = f"  hand kernel: {', '.join(r['hand_kernels'])}" if r["hand_kernels"] else ""
    if r.get("per_rank"):
        pr = r["per_rank"]["16x16"]
        note += (f"  16x16 rank: state {gib(pr['state_bytes'])} GiB batch "
                 f"{gib(pr['batch_bytes'])} GiB peak {gib(pr['peak_bytes'])} GiB")
    return (f"{r['arch'] + '/' + r['shape']:34s} {r['kind']:10s} params {r['params']:>14,d}  "
            f"state {gib(r['state_bytes']):>9s} GiB  batch {gib(r['batch_bytes']):>9s} GiB  "
            f"saved {gib(r['saved_bytes']):>9s} GiB  peak {gib(r['peak_bytes']):>9s} GiB  "
            f"flops {flops:>10s}  fits {'yes' if r['fits_one_card'] else 'NO'}{note}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-ann", action="store_true")
    ap.add_argument("--json", action="store_true", help="one JSON line a cell")
    ap.add_argument("--out", default="", help="write every cell's record to this JSON file")
    args = ap.parse_args(argv)
    if args.all:
        cells = configs.all_cells(include_ann=args.include_ann)
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    results = {}
    for arch_id, shape in cells:
        r = run_cell(arch_id, shape)
        results[f"{arch_id}/{shape}"] = r
        print(json.dumps(r) if args.json else _line(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
