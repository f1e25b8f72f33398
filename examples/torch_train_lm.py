"""End-to-end LM training on the PyTorch/CUDA port: train a ~100M-parameter
dense transformer for a few hundred steps on synthetic token streams, with
checkpoints.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cuda|cpu] [--steps 300]
        [--ckpt-dir DIR] [--tiny]

The port of ``examples/train_lm.py``. It runs on the card unless ``--device
cpu`` is given; without a card and without ``--device cpu`` it raises.
``--tiny`` trains a 2-layer, 64-wide model on 2 x 32 tokens (seconds on a
CPU). Checkpoints go through ``repro_torch.checkpoint`` (the reference's
on-disk format) every 100 steps, the last two kept. The run fails unless the
loss falls.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import resolve_device
from repro_torch.data.synthetic import token_batch
from repro_torch.models import nn
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import init_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--tiny", action="store_true", help="2 layers x 64 wide, 2 x 32 tokens")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.tiny:
        cfg = T.TransformerConfig(name="lm-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                  d_ff=128, vocab=512, d_head=16, q_chunk=32, ce_chunk=32)
        batch, seq = 2, 32
    else:   # ~100M params: 8L x 768d x 12H, vocab 32k
        cfg = T.TransformerConfig(name="lm-100m", n_layers=8, d_model=768, n_heads=12,
                                  n_kv_heads=4, d_ff=2048, vocab=32000, d_head=64, q_chunk=256,
                                  ce_chunk=128)
        batch, seq = 8, 256
    print(f"model: {cfg.name}, {cfg.n_params / 1e6:.1f}M params")

    params = T.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    print(f"materialized: {nn.count_params(params) / 1e6:.1f}M on {dev}")

    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt_cfg)
    state = init_state(params)

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        tb = token_batch(torch.Generator(device=dev).manual_seed(1000 + i), batch, seq,
                         cfg.vocab, dev)
        state, metrics = step(state, tb)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  lr {float(metrics['lr']):.2e}")
        if (i + 1) % 100 == 0:
            ckpt.save(args.ckpt_dir, i, state, keep=2)

    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s ({args.steps / dt:.2f} steps/s)")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    if not losses[-1] < losses[0]:
        raise AssertionError("training must reduce loss")
    return {"losses": losses, "seconds": dt, "device": str(dev)}


if __name__ == "__main__":
    main()
