"""Rank functions of the port's spawned tests (numpy, torch and repro_torch
only: the children never import JAX or the reference).

Each runs as ``fn(rank, world, ...)`` under ``repro_torch.launch.mesh.spawn``
on gloo CPU ranks, and writes ``rank{r}.pt`` (a dict of results) into the
directory it is given; the test process reads and checks them.
"""
import os

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import search as S
from repro_torch.core import shard
from repro_torch.launch import mesh as M


def _mesh(world, shape=None, axes=("data",)):
    return M.make_mesh(shape or (world,), axes, backend="gloo", device="cpu")


def _graph(g):
    return tuple(t.clone() for t in g)


def builds(rank, world, cases, extra, out_dir):
    """Sharded builds of every case from its initial graph, the sharded
    reverse pass, the sort merge refused, both exchanges, the build's own
    RandomGraph(S) and a (D/2, 2) mesh whose rows shard over "data"."""
    torch.set_num_threads(1)
    mesh = _mesh(world)
    res = {}
    fns = {"rnn": shard.build_rnn_descent, "nnd": shard.build_nn_descent}
    for name, (kind, x, cfg, init, qx, entry) in cases.items():
        if kind == "nsg":
            res[name] = _graph(shard.build_nsg_style(x, cfg, None, mesh, entry=entry, init=init))
        elif kind == "rnn":
            res[name] = _graph(fns[kind](x, cfg, None, mesh, qx=qx, init=init))
        else:
            res[name] = _graph(fns[kind](x, cfg, None, mesh, init=init))

    g_in, r, n_buckets = extra["reverse"]
    res["reverse"] = _graph(shard.gather_rows(
        shard.add_reverse_edges(shard.local_rows(g_in, mesh), r, mesh, n_buckets),
        g_in.n, mesh))

    g_in, (src, dst, dist) = extra["merge"]
    part = slice(rank, None, world)          # each rank passes its share of the list
    res["merge"] = _graph(shard.gather_rows(shard.merge_candidate_edges(
        shard.local_rows(g_in, mesh), src[part], dst[part], dist[part], mesh), g_in.n, mesh))

    x, cfg_sort = extra["sort"]
    try:
        shard.build_rnn_descent(x, cfg_sort, torch.Generator().manual_seed(0), mesh)
        res["sort_raises"] = False
    except ValueError:
        res["sort_raises"] = True

    # the all_to_all form of the exchange against the ring, on one rank's
    # share of a candidate list
    src, dst, dist, prio, n, b = extra["exchange"]
    n_pad = shard._padded(n, world)
    part = slice(rank, None, world)
    flags = torch.full(dst[part].shape, G.NEW, dtype=torch.uint8)
    scat = shard.block_scatter(src[part], dst[part], dist[part], flags, b, prio=prio[part])
    ring = shard.exchange_scatter(mesh, n_pad, scat)
    a2a = shard.exchange_bucket_tables(mesh, scat(0, n_pad))
    res["exchange_equal"] = all(torch.equal(u, v) for u, v in zip(ring, a2a))
    res["exchange_block"] = tuple(t.clone() for t in ring)

    from repro_torch.core import rnn_descent as rd
    x, cfg = extra["route"]
    res["route"] = _graph(rd.build(x, cfg, torch.Generator().manual_seed(5), mesh=mesh))
    res["route_single"] = _graph(rd.build(x, cfg, torch.Generator().manual_seed(5)))

    if world == 4:
        mesh2 = _mesh(world, (2, 2), ("data", "model"))
        res["mesh_2x2"] = _graph(rd.build(x, cfg, torch.Generator().manual_seed(5), mesh=mesh2))
    res["stats"] = mesh.stats.summary()

    # a traced build, and the collectives pass's counts, on a mesh of their
    # own (the counters above stay the untraced builds')
    from repro_torch import obs
    from repro_torch.analysis import collectives
    from repro_torch.obs import trace
    mesh_obs = _mesh(world)
    _, x, cfg, init, qx, _ = cases["rnn_l2"]
    obs.reset()
    obs.enable(install_hooks=False)
    try:
        g = shard.build_rnn_descent(x, cfg, None, mesh_obs, qx=qx, init=init)
        res["traced"] = (_graph(g), [(e["name"], e["attrs"]) for e in trace.events()
                                     if e["name"].startswith("rnn_descent/")])
    finally:
        obs.disable()
    res["collectives"] = collectives.measure(mesh_obs)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def searches(rank, world, x, g, cases, coded, out_dir):
    """Both search shardings for every (name -> queries, eps, cfg, valid)
    case, and the coded cases (name -> queries, eps, cfg, qx) with
    ``shard="corpus"`` and ``"queries"``."""
    torch.set_num_threads(1)
    mesh = _mesh(world)
    res = {}
    for name, (q, eps, cfg, valid) in cases.items():
        for sh in ("queries", "corpus"):
            ids, dists, stats = S.search_tiled(x, g, q, eps, cfg, tile_b=8, mesh=mesh,
                                               shard=sh, valid=valid, with_stats=True)
            res[name, sh] = (ids.clone(), dists.clone(), stats["work"])
    for name, (q, eps, cfg, qx) in coded.items():
        for sh in ("queries", "corpus"):
            ids, dists = S.search_tiled(x, g, q, eps, cfg, tile_b=8, mesh=mesh, shard=sh, qx=qx)
            res[name, sh] = (ids.clone(), dists.clone())
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def ann_build_save(rank, world, x, cfg, q, scfg, ckpt_dir, out_dir):
    """ShardedANN built row-sharded, served corpus-sharded, saved."""
    from repro_torch.distributed.ann import ShardedANN
    torch.set_num_threads(1)
    mesh = _mesh(world)
    ann = ShardedANN.build(x, "rnn-descent", cfg, torch.Generator().manual_seed(3), mesh=mesh,
                           serve_shard="corpus")
    ids, dists = ann.search(q, scfg, tile_b=8)
    ann.save(ckpt_dir)
    res = {"ids": ids, "dists": dists, "resident": ann.device_resident_bytes(),
           "rows": ann.x.shape[0]}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def ann_restore(rank, world, x, q, scfg, ckpt_dir, out_dir):
    """ShardedANN restored onto this group's mesh, served both ways."""
    from repro_torch.distributed.ann import ShardedANN
    torch.set_num_threads(1)
    mesh = _mesh(world)
    res = {}
    for sh in ("corpus", "queries"):
        ann = ShardedANN.restore(ckpt_dir, x, mesh=mesh, serve_shard=sh)
        res[sh] = ann.search(q, scfg, tile_b=8)
        res[sh, "resident"] = ann.device_resident_bytes()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def card_ranks(rank, world, x, q, g_ref, ref_ids, ref_dists, cfg, out_dir):
    """On the card, gloo ranks sharing it: the comm layer's collectives on
    CUDA tensors (results and staged bytes), ``rnn_descent.build(mesh=)``
    against the single-device graph ``g_ref``, and both search shardings
    (dense) against the single-device results."""
    from repro_torch.core import rnn_descent as rd
    from repro_torch.distributed import comm as C
    torch.cuda.set_device(0)
    mesh = M.make_mesh((world,), ("data",), backend="gloo", device="cuda:0")
    ax = ("data",)
    res = {}
    t = torch.arange(6, dtype=torch.int32, device="cuda") + 100 * rank
    blocks = (torch.arange(world * 2, dtype=torch.int64, device="cuda") + 1000 * rank).view(world, 2)
    got = {
        "ppermute": C.ppermute(t, mesh, ax, 1),
        "all_to_all": C.all_to_all(blocks, mesh, ax),
        "all_gather": C.all_gather(t, mesh, ax),
        "pmin": C.pmin(t, mesh, ax),
        "psum": C.psum(t, mesh, ax),
    }
    peer = (rank - 1) % world
    want = {
        "ppermute": torch.arange(6, dtype=torch.int32) + 100 * peer,
        "all_to_all": torch.stack([torch.arange(rank * 2, rank * 2 + 2) + 1000 * s
                                   for s in range(world)]),
        "all_gather": torch.cat([torch.arange(6, dtype=torch.int32) + 100 * s
                                 for s in range(world)]),
        "pmin": torch.arange(6, dtype=torch.int32),
        "psum": sum(torch.arange(6, dtype=torch.int32) + 100 * s for s in range(world)).int(),
    }
    res["comm_equal"] = {k: bool(got[k].is_cuda and torch.equal(got[k].cpu(), want[k]))
                         for k in got}
    res["comm_staged"] = {k: v["staged_bytes"] for k, v in mesh.stats.summary().items()}
    mesh.stats.reset()
    g = rd.build(x, cfg, torch.Generator(device="cuda").manual_seed(1), mesh=mesh)
    res["build_equal"] = all(torch.equal(a, b) for a, b in zip(g, g_ref))
    st = mesh.stats.summary()["ppermute"]
    res["sent"], res["staged"] = st["sent_bytes"], st["staged_bytes"]
    dense = S.SearchConfig(l=64, k=64, topk=10, visited="dense")
    ep = S.default_entry_point(x)
    for sh in ("queries", "corpus"):
        ids, dists = S.search_tiled(x, g, q, ep, dense, tile_b=64, mesh=mesh, shard=sh)
        res[sh + "_equal"] = bool(torch.equal(ids, ref_ids) and torch.equal(dists, ref_dists))
    torch.cuda.synchronize()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


class ManualClock:
    """Deterministic monotonic clock for replaying sessions."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def dense_seeding():
    """Inserts seed through dense visited, as the reference's parity tests
    run them: hashed inserts racing for one slot pick the winner in an order
    XLA and PyTorch do not share."""
    import dataclasses

    from repro_torch.streaming import updates as U
    orig = U.StreamingConfig.seed_search_cfg
    U.StreamingConfig.seed_search_cfg = \
        lambda self: dataclasses.replace(orig(self), visited="dense")


def store_leaves(st) -> list:
    """(name, leaf) of every leaf of a store, cloned (the checkpoint's
    flatten order)."""
    from repro_torch.checkpoint.checkpoint import flatten
    return [(name, t.clone()) for name, t in flatten(st)]


def replay_session(fe_cls, ann, cfg, q, pool):
    """Submit ``q`` in order (the clock 4 ms on a request, a pump after
    each), with an insert and a delete batch after requests 10, 25 and 40;
    drain. Returns (results, telemetry summary); on a mesh the ranks other
    than 0 follow rank 0's session and return None."""
    fe = fe_cls(ann, cfg, clock=ManualClock())
    if not getattr(fe, "leader", True):
        fe.follow()
        return None
    writes = {10: 0, 25: 1, 40: 2}
    rids = []
    for i, row in enumerate(q):
        rids.append(fe.submit(row))
        if i in writes:
            e = writes[i]
            fe.submit_insert(pool[4 * e:4 * e + 4])
            fe.submit_delete(np.arange(30 + 6 * e, 36 + 6 * e))   # 6: a tail stays
        fe.clock.advance(0.004)
        fe.pump()
    fe.drain()
    if getattr(fe, "mesh", None) is not None:
        fe.close()
    return [fe.result(r) for r in rids], fe.telemetry.summary()


def streaming(rank, world, cases, session, ckpt_save, ckpt_restore, out_dir):
    """The streaming index on this group's mesh: for each case (name ->
    store, config, ops) a StreamingANN over the store runs the ops (insert
    rows, delete ids, compact), each store and output kept; the first
    case's last store saved to ``ckpt_save`` (rank 0 writes) and
    ``ckpt_restore`` restored onto this mesh; the ``session`` (store,
    config, serving config, queries, pool) replayed under shard="queries"
    and "corpus". Inserts seed through dense visited."""
    import dataclasses

    from repro_torch.serving import ServingFrontend
    from repro_torch.streaming import StreamingANN
    torch.set_num_threads(1)
    dense_seeding()
    mesh = _mesh(world)
    res = {}
    for name, (store, cfg, ops) in cases.items():
        ann = StreamingANN(store=store, cfg=cfg, mesh=mesh)
        for i, (op, arg) in enumerate(ops):
            out = ann.compact() if op == "compact" else getattr(ann, op)(arg)
            res[name, i] = (store_leaves(ann.store), out)
        if ckpt_save is not None and name == next(iter(cases)):
            ann.save(ckpt_save)
    if ckpt_restore is not None:
        cfg = next(iter(cases.values()))[1]
        res["restored"] = store_leaves(StreamingANN.restore(ckpt_restore, cfg, mesh=mesh).store)
    store, cfg, scfg, q, pool = session
    for shard_mode in ("queries", "corpus"):
        ann = StreamingANN(store=store, cfg=cfg, mesh=mesh)
        out = replay_session(ServingFrontend, ann, dataclasses.replace(scfg, shard=shard_mode),
                             q, pool)
        res["session", shard_mode] = (out, store_leaves(ann.store))
    res["stats"] = mesh.stats.summary()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def card_streaming(rank, world, store, cfg, new_x, dels, want, out_dir):
    """On the card, gloo ranks sharing it: a StreamingANN over ``store``
    inserts ``new_x`` and deletes ``dels`` row-sharded (seeding dense),
    each store held leaf for leaf to the single device's ``want``."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.streaming import StreamingANN
    torch.cuda.set_device(0)
    dense_seeding()
    mesh = M.make_mesh((world,), ("data",), backend="gloo", device="cuda:0")
    ann = StreamingANN(store=store, cfg=cfg, mesh=mesh)
    reset_launches()
    ann.insert(new_x)
    res = {"insert": [torch.equal(t, w) for (_, t), w in zip(store_leaves(ann.store), want[0])]}
    ann.delete(dels)
    res["delete"] = [torch.equal(t, w) for (_, t), w in zip(store_leaves(ann.store), want[1])]
    torch.cuda.synchronize()
    res["launches"] = {k: v for k, v in LAUNCHES.items() if v}
    res["ring"] = mesh.stats.summary().get("ppermute", {}).get("calls", 0)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def run(fn, world, *args):
    """Spawn ``fn`` on ``world`` gloo CPU ranks; returns the ranks' result
    dicts in rank order."""
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        M.spawn(fn, world, (*args, out), backend="gloo", timeout_s=120)
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
