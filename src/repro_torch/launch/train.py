"""The trainer CLI: the reference's (``repro/launch/train.py``) on the
port, one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4_mini_3_8b \\
        --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --resume

Same flags, messages and checkpoint/resume behaviour as the reference's,
plus ``--device`` (``cuda`` by default; ``cpu`` to run the plain path on
the CPU). Batches come from ``data.tokens.make_batch`` (the port's draws,
not ``jax.random``'s, so the losses differ from the reference's run).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data.tokens import make_batch
from ..device import resolve_device
from ..dist import checkpoint as ckpt_lib
from ..dist.fault_tolerance import StepWatchdog
from ..models import get_model
from ..train import (AdamWConfig, TrainConfig, init_train_state,
                     make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="phi4_mini_3_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr, warmup_steps=10),
                       accum_steps=args.accum, grad_dtype=args.grad_dtype)
    step_fn = make_train_step(model, tcfg)

    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(args.seed), dev)
    start = 0
    if args.resume and args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir):
        state, start = ckpt_lib.restore(args.ckpt_dir, state, device=dev)
        print(f"resumed from step {start}")

    watchdog = StepWatchdog()
    losses = []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = make_batch(cfg, batch=args.batch, seq=args.seq, step=step,
                           seed=args.seed, device=dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])           # waits for the step
        dt = time.time() - t0
        status = watchdog.check(dt)
        losses.append(loss)
        print(f"step {step:5d} loss {loss:.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms"
              + (f" [{status}]" if status != "ok" else ""), flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, step + 1, state)
    if not losses:                  # resumed at or past --steps: no-op run
        print(f"nothing to do: resumed at step {start} >= --steps "
              f"{args.steps}")
        return losses
    if args.ckpt_dir:
        ckpt_lib.save(args.ckpt_dir, args.steps, state)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
