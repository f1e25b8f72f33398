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

``serve_jobs`` runs the serving cells the same way (``fn(rank, world,
jobs, out_dir)``): each job binds its cell on its mesh, takes this rank's
blocks of the given whole params and batch, and records its outputs
gathered whole, this rank's cache blocks and resident bytes.
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


# ------------------------------------------------------------------ serving
def _gathered(t, mesh, axes):
    return sh.gather_block(t, mesh, axes).clone()


def _serve_lm(job, mesh):
    """Prefill of ``prompt`` (this rank's rows) into a zero cache of
    ``cache_len`` (``bound``: through the bound prefill step, a cache of the
    prompt's length), or the given ``cache`` placed ``cache_seq_flat``;
    then one bound decode step per token vector of ``decode``."""
    cfg, arch = job["cfg"], job["arch"]
    pre = steps.bind(arch, "prefill_32k", reduced=True, mesh=mesh, _cfg=cfg)
    params = sh.tree_local_blocks(job["params"], mesh, pre.state_axes)
    out = {"param_bytes": fsdp.state_bytes(params), "decode": []}
    if "prompt" in job:
        tokens = sh.local_block(job["prompt"], mesh, pre.batch_axes["tokens"])
        if job.get("bound"):
            logits, cache = pre.step_fn(params, {"tokens": tokens})
        else:
            cache = tf.init_cache(cfg, job["prompt"].shape[0], job["cache_len"],
                                  device=mesh.device, mesh=mesh)
            logits, cache = tf.prefill(params, tokens, cache, cfg, mesh)
        out["prefill"] = {"logits": _gathered(logits, mesh, pre.out_axes[0]),
                          **{k: v.clone() for k, v in cache.items()}}
        dec = steps.bind(arch, "decode_32k", reduced=True, mesh=mesh, _cfg=cfg)
    else:
        dec = steps.bind(arch, "long_500k", reduced=True, mesh=mesh, _cfg=cfg)
        cache = sh.tree_local_blocks(job["cache"], mesh, dec.batch_axes["cache"])
    for tok in job["decode"]:
        tok = sh.local_block(tok, mesh, dec.batch_axes["tokens"])
        logits, cache = dec.step_fn(params, {"tokens": tok, "cache": cache})
        out["decode"].append(_gathered(logits, mesh, dec.out_axes[0]))
    out["cache"] = {k: v.clone() for k, v in cache.items()}
    out["cache_bytes"] = fsdp.state_bytes(cache)
    if "moe" in job:
        par = tf._par(cfg, mesh, None, split=(True, False))
        p0 = {k: v[0] for k, v in params["layers"].items()}
        y3 = sh.local_block(job["moe"], mesh, ("batch", None, None))
        with torch.no_grad():
            y, _, top_e = tf._moe_ffn_split(p0, y3, cfg, par)
        out["moe"] = {"y": _gathered(y, mesh, ("batch", None, None)),
                      "top_e": _gathered(top_e, mesh, ("batch", None, None))}
    out["stats"] = mesh.stats.summary()
    return out


def _serve_recsys(job, mesh):
    """The bound ``serve`` step on this rank's blocks, counting the
    ``fm_interact`` calls it makes."""
    from repro_torch.kernels.fm_interact import ops as fm_ops
    bound = steps.bind(job["arch"], job["shape"], reduced=True, mesh=mesh, _cfg=job["cfg"])
    params = sh.tree_local_blocks(job["params"], mesh, bound.state_axes)
    batch = {k: sh.local_block(v, mesh, bound.batch_axes[k]) for k, v in job["batch"].items()}
    calls, fm = [], fm_ops.fm_interact
    fm_ops.fm_interact = lambda emb: calls.append(emb.shape[0]) or fm(emb)
    try:
        scores = bound.step_fn(params, batch)
    finally:
        fm_ops.fm_interact = fm
    return {"scores": _gathered(scores, mesh, bound.out_axes), "fm_rows": calls,
            "param_bytes": fsdp.state_bytes(params)}


def _serve_retrieval(job, mesh):
    """The bound ``retrieval`` step (top-100), and ``score_candidates`` with
    ``k`` and ``n_valid``, on this rank's block of the candidates."""
    bound = steps.bind("deepfm", "retrieval_cand", reduced=True, mesh=mesh)
    cand = sh.local_block(job["cand"], mesh, bound.batch_axes["cand_embs"])
    top, ids = bound.step_fn({}, {"query_emb": job["query"], "cand_embs": cand})
    vtop, vids = rs.score_candidates(job["query"], cand, k=job["k"], mesh=mesh,
                                     n_valid=job["n_valid"])
    return {"top": top, "ids": ids, "valid_top": vtop, "valid_ids": vids,
            "rows": cand.shape[0]}


SERVE = {"lm": _serve_lm, "recsys": _serve_recsys, "retrieval": _serve_retrieval}


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree


def serve_jobs(rank, world, jobs, out_dir):
    """Each job whose (data, model) mesh has ``world`` ranks, bound on that
    mesh of gloo ranks (CPU ranks, or with a job's ``device`` "cuda" ranks
    sharing the card) and run by its family's function above; rank r
    writes ``rank{r}.pt``, its tensors on the host."""
    torch.set_num_threads(1)
    res = {}
    for key, job in jobs.items():
        d, m = job["mesh"]
        if d * m != world:
            continue
        dev = "cuda:0" if job.get("device", "cpu") == "cuda" else "cpu"
        if dev != "cpu":
            torch.cuda.set_device(0)
        mesh = M.make_mesh((d, m), ("data", "model"), backend="gloo", device=dev)
        res[key] = _to(SERVE[job["family"]](_to(job, mesh.device), mesh), "cpu")
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
