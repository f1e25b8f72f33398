"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \
        --shape train_batch --steps 20 --reduced --device cpu

``--reduced`` runs the smoke-size config; without it the full config runs
on the one device (the port has no production mesh). Either way the batches
are the cell's smoke batches (``configs.base.lm_smoke_batch`` /
``gnn_smoke_batch`` / ``recsys_smoke_batch``) drawn from (``--seed``, step) by
``data.pipeline.step_generator``, as the reference feeds them. Fault
tolerance: with ``--ckpt-dir`` the loop runs under
``distributed.fault.run_with_restarts`` (a checkpoint every
``--ckpt-every`` steps, restore on start and after a failure), so a rerun
resumes where the last commit left off. The exit code is 0 only if the
last loss is below the first.
"""
from __future__ import annotations

import argparse

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
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """The training loop of :func:`main`. Returns ``{"losses": [...] (this
    run's steps), "state": the final TrainState, "seconds": loop time,
    "first_step": the step this run started at}``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    arch = configs.get(args.arch)
    bound = steps_mod.bind(args.arch, args.shape, reduced=args.reduced, device=dev)
    if bound.kind != "train":
        raise ValueError(f"{args.shape} is not a training shape")
    smoke_batch = cb.smoke_batch(arch.family)

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
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"grad_norm {float(metrics.get('grad_norm', 0)):.3f}", flush=True)
        return state, {"loss": loss}

    with trace.timed("train/loop", steps=args.steps) as tm:
        if args.ckpt_dir:
            state, _ = fault.run_with_restarts(
                make_state, one_step, n_steps=args.steps, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=dev)
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
