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
  * for a step that launches no hand kernel, one step run on the meta
    device: ``flops``, the matmul FLOPs of
    ``torch.utils.flop_counter.FlopCounterMode`` (forward, backward and
    remat's recomputation; elementwise work is not counted), and
    ``saved_bytes``, the bytes of the distinct storages autograd saves for
    the backward (``torch.autograd.graph.saved_tensors_hooks``), the
    state's and the batch's own left out. A serving step runs under
    ``torch.no_grad()`` (it has no backward: nothing is saved);
  * a step that launches a hand kernel (FM and DeepFM through
    ``fm_interact``, the ``ann`` cells through ``rng_prune`` or
    ``beam_score``) is not run (no kernel wrapper has a meta path): its
    ``flops`` and ``saved_bytes`` are null and ``hand_kernels`` names the
    kernel;
  * ``per_rank``: for each of the reference's production meshes
    (``launch.mesh.make_production_mesh``: 16 x 16, 2 x 16 x 16), the
    bytes one rank holds of the state and of the batch when every leaf is
    placed by the cell's ``state_axes`` and ``batch_axes`` (computed from
    the shapes: no ranks are spawned), and the leaves whose dims do not
    split evenly (counted at the larger block, as XLA pads them);
  * ``fits_one_card``: state + batch + saved bytes against the card's
    memory (``torch.cuda.get_device_properties(0).total_memory``, or 80 GiB
    when there is no card). Where ``saved_bytes`` is null the sum is a lower
    bound. Transient peaks (a step's temporaries, the backward's
    gradients) are not counted.

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

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.obs import trace

CARD_BYTES_DEFAULT = 80 * 2**30


def hand_kernels(arch_id: str, cfg, kind: str) -> list[str]:
    """The hand kernels a cell's step launches on the card."""
    family = configs.get(arch_id).family
    if family == "ann":
        return ["rng_prune"] if kind == "ann_build" else ["beam_score"]
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


def measure_step(bound, state, batch) -> dict:
    """One ``bound.step_fn(state, batch)``: the matmul FLOPs it counts and
    the bytes of the distinct storages autograd saves (the state's and the
    batch's own left out). Train steps run with grad on, the others under
    ``no_grad``."""
    own = _storages(state) | _storages(batch)
    saved: dict = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in own:
            saved[st._cdata] = st       # held: a key stays unique while counted
        return t

    grad = torch.enable_grad() if bound.kind == "train" else torch.no_grad()
    with grad, FlopCounterMode(display=False) as fc, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        bound.step_fn(state, batch)
    return {"flops": int(fc.get_total_flops()),
            "saved_bytes": int(sum(st.nbytes() for st in saved.values()))}


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


def _per_rank(bound, state, batch) -> dict | None:
    if bound.state_axes is None:
        return None
    out = {}
    for name, multi in (("16x16", False), ("2x16x16", True)):
        mesh = M.make_production_mesh(multi_pod=multi)
        st, st_uneven = per_rank_bytes(state, bound.state_axes, mesh)
        bt, bt_uneven = per_rank_bytes(batch, bound.batch_axes or {}, mesh)
        out[name] = {"state_bytes": st, "batch_bytes": bt, "uneven": st_uneven + bt_uneven}
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
        out = {"arch": arch_id, "shape": shape_name, "kind": bound.kind, "reduced": reduced,
               "params": sum(t.numel() for _, t in flatten(params)),
               "param_bytes": _nbytes(params), "state_bytes": _nbytes(state),
               "batch_bytes": _nbytes(batch), "hand_kernels": kernels,
               "flops": None, "saved_bytes": None,
               "per_rank": _per_rank(bound, state, batch)}
        if not kernels:
            out.update(measure_step(bound, state, batch))
    total = out["state_bytes"] + out["batch_bytes"] + (out["saved_bytes"] or 0)
    out.update(total_bytes=total, card_bytes=card_bytes(), fits_one_card=total <= card_bytes(),
               seconds=tm.seconds)
    return out


def _line(r: dict) -> str:
    gib = lambda b: "-" if b is None else f"{b / 2**30:.3f}"
    flops = "-" if r["flops"] is None else f"{r['flops']:.3e}"
    note = f"  hand kernel: {', '.join(r['hand_kernels'])}" if r["hand_kernels"] else ""
    if r.get("per_rank"):
        pr = r["per_rank"]["16x16"]
        note += f"  16x16 rank: state {gib(pr['state_bytes'])} GiB batch {gib(pr['batch_bytes'])} GiB"
    return (f"{r['arch'] + '/' + r['shape']:34s} {r['kind']:10s} params {r['params']:>14,d}  "
            f"state {gib(r['state_bytes']):>9s} GiB  batch {gib(r['batch_bytes']):>9s} GiB  "
            f"saved {gib(r['saved_bytes']):>9s} GiB  flops {flops:>10s}  "
            f"fits {'yes' if r['fits_one_card'] else 'NO'}{note}")


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
