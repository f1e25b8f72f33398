"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \
        --shape train_batch --steps 20 --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b \
        --shape train_4k --steps 4 --reduced --device cpu --ranks 4 --mesh 2x2

``--reduced`` runs the smoke-size config; without it the full config. With
``--ranks N --mesh DxM`` the loop runs on N ranks spawned on this host
(``launch.mesh.spawn``) over a (data D, model M) mesh, through
``bind(mesh=)``: ZeRO-3 blocks of the state on every rank, each rank its
block of every batch; ``--backend gloo`` for CPU ranks or ranks sharing one
card, ``nccl`` only with one card per rank (rank r on ``cuda:r``). Rank 0
prints. Either way the batches are the cell's smoke batches (``configs.base.lm_smoke_batch`` /
``gnn_smoke_batch`` / ``recsys_smoke_batch``) drawn from (``--seed``, step) by
``data.pipeline.step_generator``, as the reference feeds them. Fault
tolerance: with ``--ckpt-dir`` the loop runs under
``distributed.fault.run_with_restarts`` (a checkpoint every
``--ckpt-every`` steps, restore on start and after a failure), so a rerun
resumes where the last commit left off (under ranks: rank 0 writes the
whole leaves, each rank restores its blocks, so a run resumes on another
mesh too). The exit code is 0 only if the last loss is below the first.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch import configs, resolve_device
from repro_torch.configs import base as cb
from repro_torch.data import pipeline
from repro_torch.distributed import fault
from repro_torch.launch import steps as steps_mod
from repro_torch.obs import trace


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=0,
                    help="spawn this many ranks and train over --mesh")
    ap.add_argument("--mesh", default="", help="DxM: the ranks' (data, model) grid")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if bool(args.ranks) != bool(args.mesh):
        ap.error("--ranks and --mesh go together")
    if args.ranks:
        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
        if len(shape) != 2 or shape[0] * shape[1] != args.ranks:
            ap.error(f"--mesh {args.mesh} is not a DxM grid of {args.ranks} ranks")
        args.mesh_shape = shape
    return args


def run(argv=None) -> dict:
    """The training loop of :func:`main`. Returns ``{"losses": [...] (this
    run's steps), "state": the final TrainState (None under ranks),
    "seconds": loop time, "first_step": the step this run started at}``."""
    args = parse_args(argv)
    if not args.ranks:
        return _loop(args, resolve_device(args.device), None)
    from repro_torch.launch import mesh as M
    with tempfile.TemporaryDirectory() as tmp:
        M.spawn(_rank_main, args.ranks, (args, tmp), backend=args.backend)
        with open(os.path.join(tmp, "rank0.json")) as f:
            return dict(json.load(f), state=None)


def _rank_main(rank, world, args, out_dir):
    from repro_torch.launch import mesh as M
    device = f"cuda:{rank}" if args.backend == "nccl" else args.device
    if device == "cpu":                # the host's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = M.make_mesh(args.mesh_shape, ("data", "model"), backend=args.backend, device=device)
    out = _loop(args, mesh.device, mesh)
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump({k: v for k, v in out.items() if k != "state"}, f)


def _loop(args, dev: torch.device, mesh) -> dict:
    arch = configs.get(args.arch)
    bound = steps_mod.bind(args.arch, args.shape, reduced=args.reduced, device=dev, mesh=mesh)
    if bound.kind != "train":
        raise ValueError(f"{args.shape} is not a training shape")
    smoke_batch = cb.smoke_batch(arch.family)
    talk = mesh is None or mesh.rank == 0

    def batch_for(step: int) -> dict:
        return smoke_batch(pipeline.step_generator(args.seed, step, dev), bound.cfg,
                           bound.shape, dev)

    def make_state():
        return bound.init_fn(torch.Generator(device=dev).manual_seed(args.seed + 1))

    losses, steps_run = [], []

    def one_step(state, step):
        state, metrics = bound.step_fn(state, batch_for(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        steps_run.append(step)
        if talk and step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"grad_norm {float(metrics.get('grad_norm', 0)):.3f}", flush=True)
        return state, {"loss": loss}

    with trace.timed("train/loop", steps=args.steps) as tm:
        if args.ckpt_dir:
            state, _ = fault.run_with_restarts(
                make_state, one_step, n_steps=args.steps, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=dev, mesh=mesh,
                axes=None if mesh is None else bound.state_axes)
        else:
            state = make_state()
            for step in range(args.steps):
                state, _ = one_step(state, step)
    return {"losses": losses, "state": state, "seconds": tm.seconds,
            "first_step": steps_run[0] if steps_run else args.steps}


def main(argv=None) -> int:
    out = run(argv)
    losses, dt = out["losses"], out["seconds"]
    if not losses:
        print("done: nothing to run (the checkpoint is at the last step)")
        return 1
    print(f"done: {len(losses)} steps in {dt:.1f}s ({len(losses) / dt:.2f} steps/s); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
