"""Training launcher of the port: ``python -m repro_torch.launch.train --arch <id>``.

Trains a configuration on the synthetic ``topic`` stream (weights random
from ``--seed``) with AdamW: the reduced config by default, the published
widths with ``--full-width`` and the first N layers with ``--layers N`` (the
config's unit repeated). ``--device`` defaults to ``cuda``; a missing card
is an error, never a quiet fall back to the CPU. The run resumes from the
latest committed checkpoint under ``--ckpt-dir``/<config name> (so a killed
run relaunched continues where its last checkpoint left it, bit for bit),
keeps the last ``--keep`` checkpoints, logs loss, gradient norm and
learning rate every ``--log-every`` steps, and ends with steps/s, tokens/s
and, on the card, MFU: ``model_flops`` (6 x active parameters x tokens) per
second over 989 TFLOP/s, the H100's dense bf16 peak. These are timed over
the steps after the first (whose time is the warm-up's, printed apart), so
they compare with a steady step; the wait for the last checkpoint's write
after the last step is printed on its own line.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import time

import numpy as np

H100_BF16_FLOPS = 989e12


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64, help="positions a row (frontend included)")
    ap.add_argument("--full-width", action="store_true",
                    help="train the config's published widths (default: reduced)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to the first N units (0 = the config's)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--keep", type=int, default=3, help="checkpoints kept")
    ap.add_argument("--micro", type=int, default=1, help="microbatches a step")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="dots_saveable", choices=["none", "full", "dots_saveable"])
    ap.add_argument("--moe-impl", default="sorted", choices=["dense", "sorted"])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import RunConfig, ShardingConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import resolve_device
    from repro_torch.data import Loader, SyntheticSpec
    from repro_torch.models.params import model_flops
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.training import init_train_state, make_train_step, train_loop

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduce_for_smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, segments=((cfg.segments[0][0], args.layers),))
    run = RunConfig(learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1), checkpoint_every=args.ckpt_every,
                    log_every=args.log_every)
    rt = Runtime(sharding=ShardingConfig(remat_policy=args.remat, moe_impl=args.moe_impl))
    mgr = CheckpointManager(os.path.join(args.ckpt_dir, cfg.name), keep=args.keep)

    state = init_train_state(cfg, init_params(cfg, args.seed, device))
    start = 0
    got = mgr.restore_latest(state)
    if got is not None:
        start, state, _ = got
        print(f"resumed from step {start}")

    n_front = cfg.frontend_len if cfg.frontend else 0
    spec = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=args.seq - n_front,
                         global_batch=args.batch, kind="topic", seed=args.seed)
    step_fn = make_train_step(cfg, rt, run, num_micro=args.micro)
    if cfg.frontend:
        fe = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (args.batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)).to(device)
        base_fn = step_fn
        step_fn = lambda s, t, l: base_fn(s, t, l, fe)  # noqa: E731

    def log(step, m):
        print(f"step {step:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
              f"lr {m['lr']:.2e}", flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    steps = args.steps - start
    metrics: dict = {}
    marks = []                       # wall clock before the first step, after it, after the last
    with Loader(spec, device, start_step=start) as loader:
        for n in (min(steps, 1), steps - 1):
            sync()
            marks.append(time.perf_counter())
            if n > 0:
                state, metrics = train_loop(cfg, state, step_fn, loader, run, num_steps=n,
                                            ckpt_manager=mgr, log=log)
        sync()
        marks.append(time.perf_counter())
        mgr.wait()
        wait_s = time.perf_counter() - marks[-1]
    first_s, rest_s = marks[1] - marks[0], marks[2] - marks[1]
    print(f"done: {steps} steps, final loss {metrics.get('loss', float('nan')):.4f}; "
          f"first step {first_s:.2f} s (warm-up)")
    if steps > 1:
        n, dt = steps - 1, max(rest_s, 1e-9)
        tokens = n * args.batch * args.seq
        line = (f"the {n} steps after the first: {dt:.2f} s, {n / dt:.3f} steps/s, "
                f"{tokens / dt:.1f} tokens/s")
        if device.type == "cuda":
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip().splitlines()
            mfu = model_flops(cfg, tokens) / dt / H100_BF16_FLOPS
            line += f", MFU {100 * mfu:.2f}% of 989 TFLOP/s bf16 ({card[0] if card else 'card'})"
        else:
            line += ", MFU not measured (CPU run)"
        print(line)
    print(f"checkpoint write finished {wait_s:.2f} s after the last step")


if __name__ == "__main__":
    main()
