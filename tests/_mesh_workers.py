"""Rank functions of the port's mesh-training tests (numpy, torch and
repro_torch only: the children never import JAX or the reference).

``train_jobs`` runs as ``fn(rank, world, jobs, out_dir)`` under
``repro_torch.launch.mesh.spawn`` on gloo ranks: CPU ranks, or with a job's
``device`` "cuda" ranks sharing the card. Each job whose mesh
has ``world`` ranks binds its cell on that mesh, takes this rank's blocks of
the given whole initial state, and records: the first batch's loss and the
whole gradients (the blocks gathered), the losses and the whole state after
one bound step per batch, this rank's state bytes by part, the collective
counters, and with ``moe`` layer 0's MoE on this rank's block of ``y3``
(outputs and routing gathered in the reference's shard order). Rank r
writes ``rank{r}.pt``.
"""
import os

import torch

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.distributed import comm, fsdp
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import dimenet as dm
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.train import value_and_grad

LOSS = {"lm": tf.loss_fn, "recsys": rs.loss_fn, "gnn": dm.loss_fn}


def _flat(tree):
    return {name: t.detach().cpu().clone() for name, t in flatten(tree)}


def _moe(bound, mesh, state, y3):
    cfg = bound.cfg
    par = tf._par(cfg, mesh, None)
    p = {k: v[0] for k, v in state.params["layers"].items()}
    b, s = y3.shape[0] // par.dp, y3.shape[1] // par.ml
    tile = y3[par.di * b:(par.di + 1) * b, par.mi * s:(par.mi + 1) * s]
    with torch.no_grad():
        y, aux, top_e = tf._moe_ffn_split(p, tile.to(mesh.device), cfg, par)
        y = comm.all_gather(comm.all_gather(y, mesh, ("model",), dim=1), mesh, ("data",))
        top_e = comm.all_gather(top_e.reshape(-1, top_e.shape[-1]), mesh, ("data", "model"))
    return {"y": y.cpu(), "aux": float(aux), "top_e": top_e.cpu()}


def train_jobs(rank, world, jobs, out_dir):
    torch.set_num_threads(1)
    res = {}
    for key, job in jobs.items():
        d, m = job["mesh"]
        if d * m != world:
            continue
        card = job.get("device", "cpu") == "cuda"
        if card:
            torch.cuda.set_device(0)
        mesh = M.make_mesh((d, m), ("data", "model"), backend="gloo",
                           device="cuda:0" if card else "cpu")
        bound = steps.bind(job["arch"], job["shape"], reduced=True, mesh=mesh, _cfg=job["cfg"])
        state = sh.tree_map_axes(
            lambda t, ax, name: sh.local_block(t, mesh, ax, name).to(mesh.device, copy=True),
            job["state"], bound.state_axes)
        batches = [{k: v.to(mesh.device) for k, v in b.items()} for b in job["batches"]]
        params_axes = bound.state_axes.params
        loss_fn = LOSS[job["family"]]
        local = sh.tree_map_axes(lambda t, ax, name: sh.local_block(t, mesh, ax, name),
                                 batches[0], bound.batch_axes)
        loss, grads = value_and_grad(lambda p, b: loss_fn(p, b, bound.cfg, mesh=mesh),
                                     state.params, local)
        out = {"loss": float(loss), "launches": dict(LAUNCHES),
               "grads": _flat(sh.tree_gather_blocks(grads, mesh, params_axes)),
               "bytes": {part: fsdp.state_bytes(t) for part, t in
                         (("params", state.params), ("m", state.opt.m), ("v", state.opt.v),
                          ("master", state.opt.master))}}
        if "moe" in job:
            out["moe"] = _moe(bound, mesh, state, job["moe"]["y3"])
        mesh.stats.reset()
        losses = []
        for b in batches:
            state, metrics = bound.step_fn(state, b)
            losses.append(float(metrics["loss"]))
        out["losses"] = losses
        out["stats"] = mesh.stats.summary()
        out["state"] = _flat(sh.tree_gather_blocks(state, mesh, bound.state_axes))
        res[key] = out
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
