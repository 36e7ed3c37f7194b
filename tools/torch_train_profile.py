#!/usr/bin/env python3
"""Where a training step's time goes on the card.

    python3 tools/torch_train_profile.py [--paths train-qwen36,train-recurrentgemma-2b]
                                         [--steps 3] [--out FILE]

Each of ``chip_smoke.py``'s training paths (its config, depth, batch,
sequence, remat policy and MoE dispatch) builds its train state from the
seed, takes two warm steps of the ``topic`` stream, then ``--steps`` more
split by CUDA events into the loss forward, the backward (autograd,
recomputation included) and the AdamW update, and ``--steps`` more under
``torch.profiler`` (CPU and CUDA activity): the device time per step by
kernel name (the top ones, and summed into GEMMs and the rest), its share
of the wall time (the busy share) and the device operations per step.
Prints the card's ``nvidia-smi`` name and power limit and one JSON line
per path (also to ``--out``).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile_path(dev, spec, steps):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.config import RunConfig, ShardingConfig, get_config
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.models import transformer as tfm
    from repro_torch.training import adamw_update, init_train_state
    from repro_torch.tree import leaves
    from tools.torch_dense_profile import _device_split

    cfg = get_config(spec.arch)
    if spec.layers:
        cfg = dataclasses.replace(cfg, segments=((cfg.segments[0][0], spec.layers),))
    rt = tfm.Runtime(sharding=ShardingConfig(remat_policy="dots_saveable", moe_impl="sorted"))
    run = RunConfig(**cs.TRAIN_LR)
    data = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=spec.seq, global_batch=spec.batch)
    state = init_train_state(cfg, tfm.init_params(cfg, 0, dev))
    params = state["params"]
    batches = [tuple(torch.from_numpy(a).to(dev) for a in batch_at_step(data, i))
               for i in range(2 + 2 * steps)]

    def step(i, marks=None):
        tokens, labels = batches[i]
        loss, _ = tfm.lm_loss(cfg, params, tokens, labels, rt)
        if marks:
            marks[1].record()
        grads = torch.autograd.grad(loss, leaves(params))
        if marks:
            marks[2].record()
        adamw_update(params, grads, state["opt"], run)

    for i in range(2):
        step(i)
    parts = []
    for i in range(2, 2 + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        step(i, ev)
        ev[3].record()
        torch.cuda.synchronize()
        parts.append((time.perf_counter() - t0,
                      *(ev[j].elapsed_time(ev[j + 1]) for j in range(3))))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(2 + steps, 2 + 2 * steps):
            step(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    dev_ms, ops, top, classes = _device_split(prof, steps)
    med = np.median(np.array(parts), axis=0)
    out = dict(path=spec.label, arch=cfg.name, layers=cfg.num_layers,
               tokens=spec.batch * spec.seq, step_ms=float(med[0] * 1e3),
               forward_ms=float(med[1]), backward_ms=float(med[2]), adamw_ms=float(med[3]),
               profiled_wall_ms=wall, device_ms=dev_ms, busy=dev_ms / wall,
               device_ops=ops, classes=classes,
               top=top)
    print(f"{spec.label}: step {out['step_ms']:.1f} ms (forward {out['forward_ms']:.1f}, "
          f"backward {out['backward_ms']:.1f}, AdamW {out['adamw_ms']:.1f}); profiled "
          f"{wall:.1f} ms a step, device {dev_ms:.1f} ms (busy {100 * dev_ms / wall:.0f}%), "
          f"{ops:.0f} device operations a step; by class {classes}", flush=True)
    for row in out["top"]:
        print(f"    {row['ms']:8.2f} ms  {row['calls']:7.0f}x  {row['name']}", flush=True)
    del state, params, batches, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="train-qwen36,train-recurrentgemma-2b")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    by_label = {s.label: s for s in cs.TRAIN_PATHS}
    rows = [profile_path(torch.device("cuda"), by_label[p], args.steps)
            for p in args.paths.split(",") if p]
    for r in rows:
        line = json.dumps(r)
        print(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
