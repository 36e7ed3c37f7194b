#!/usr/bin/env python3
"""Where the dense families' time goes on the card.

    python3 tools/torch_dense_profile.py [--serve qwen3-4b,starcoder2-7b,phi3-mini-3.8b]
                                         [--eager pixtral-12b:16,musicgen-large]
                                         [--ticks 6] [--steps 8] [--out FILE]

``--serve``: each arch at its published widths and full depth in a
``ServingEngine`` as ``chip_smoke.py`` builds it (4 rows, cache_len 1024,
pages of 16, windows up to 4, the window graphs captured by ``warmup``).
Four requests of 300 prompt tokens and 64 new ones are submitted; after the
admission tick (timed: its four eager prefills and its first window) and
``--ticks`` warm ticks, ``--ticks`` more ticks are profiled, each one window
graph replay over the 4 rows plus its blocking pull.

``--eager``: each ``arch[:layers]`` (its first N layers, else all) through
``prefill_model`` (with its frontend's embeddings) and ``--steps`` greedy
``decode_model`` steps run eagerly, as chip_smoke's frontend paths run
them; a second prefill of the same prompt and the steps after two warm
ones are profiled (``xlstm-350m``: its cells run a position at a time).

For each: wall ms per tick or step (host clock, ending in a pull), and
under ``torch.profiler`` (CPU and CUDA activity) the device time per tick
or step by kernel name (the top ones, and summed into GEMMs, attention
kernels and the rest), its share of the wall time (the busy share) and
the device operations per tick or step. Prints the card's ``nvidia-smi``
name and power limit and one JSON line per arch (also to ``--out``).
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


def _device_split(prof, n):
    """(device ms per unit, ops per unit, top rows, ms by class) of the
    device's own events in ``prof`` over ``n`` units."""
    import torch

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((ev.key, dt / 1e3 / n, ev.count / n))
    rows.sort(key=lambda r: -r[1])
    classes = {"gemm": 0.0, "attention (K2, K4)": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitkreduce")):
            classes["gemm"] += ms
        elif "decode_" in low or "flash_fwd" in low:
            classes["attention (K2, K4)"] += ms
        else:
            classes["other"] += ms
    top = [dict(name=k[:80], ms=ms, calls=c) for k, ms, c in rows[:10]]
    return sum(r[1] for r in rows), sum(r[2] for r in rows), top, classes


def profile_serving(dev, arch, ticks):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(arch)
    spec = cs.ServeSpec(f"serve-{arch}", None, 0, False, arch=arch)
    engine = cs.make_server(dev, cfg, init_params(cfg, 0, dev), spec)
    engine.warmup()
    rng = np.random.default_rng(0)
    for _ in range(cs.SERVE_ROWS):
        engine.submit(rng.integers(0, cfg.vocab_size, 300).astype(np.int32), 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.tick()                           # the admissions' prefills and the first window
    torch.cuda.synchronize()
    admit_ms = 1e3 * (time.perf_counter() - t0)
    for _ in range(ticks):
        engine.tick()
    w0, c0 = engine.stats.windows, engine.stats.tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.tick()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / ticks
    tokens = (engine.stats.tokens - c0) / ticks
    windows = engine.stats.windows - w0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_prof = 1e3 * (time.perf_counter() - t0) / ticks
    dev_ms, ops, top, classes = _device_split(prof, ticks)
    out = dict(arch=arch, kind="serving", layers=cfg.num_layers, admit_tick_ms=admit_ms,
               wall_ms_per_tick=wall, tokens_per_tick=tokens,
               windows=windows, profiled_wall_ms_per_tick=wall_prof,
               device_ms_per_tick=dev_ms, device_busy_share=dev_ms / wall_prof,
               device_ops_per_tick=ops, device_ms_by_class=classes, top_device=top)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_eager(dev, arch, layers, steps):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.models import transformer as tfm

    full = get_config(arch)
    cfg = (dataclasses.replace(full, segments=((full.segments[0][0], layers),)) if layers
           else full)
    params = tfm.init_params(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fe = None
    if cfg.frontend:
        fe = (torch.randn((1, cfg.frontend_len, cfg.frontend_dim), generator=gen, device=dev)
              * 0.02).to(tfm.torch_dtype(cfg))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 512)))
    cache = 2048 if cfg.frontend_len + 512 > 1024 else 1024
    logits, state = tfm.prefill_model(cfg, params, tokens.to(dev), cache, frontend=fe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tfm.prefill_model(cfg, params, tokens.to(dev), cache, frontend=fe)[0].float().cpu()
        prefill_wall = 1e3 * (time.perf_counter() - t0)
    prefill_dev, prefill_ops, _, _ = _device_split(prof, 1)
    cur = cfg.frontend_len + 512
    tok = [int(logits.float().argmax())]

    def step():
        lg, _ = tfm.decode_model(cfg, params, torch.tensor([tok[-1]], device=dev), state,
                                 cur + len(tok) - 1)
        tok.append(int(lg.float().argmax().cpu()))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        wall_prof = 1e3 * (time.perf_counter() - t0) / steps
    dev_ms, ops, top, classes = _device_split(prof, steps)
    out = dict(arch=arch, kind="eager decode_model", layers=cfg.num_layers,
               prefill_wall_ms=prefill_wall, prefill_device_ms=prefill_dev,
               prefill_busy_share=prefill_dev / prefill_wall, prefill_device_ops=prefill_ops,
               wall_ms_per_step=wall, profiled_wall_ms_per_step=wall_prof,
               device_ms_per_step=dev_ms, device_busy_share=dev_ms / wall_prof,
               device_ops_per_step=ops, device_ms_by_class=classes, top_device=top)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", default="qwen3-4b,starcoder2-7b,phi3-mini-3.8b")
    ap.add_argument("--eager", default="pixtral-12b:16,musicgen-large")
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_dense_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.build import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    results = [profile_serving(dev, a, args.ticks) for a in args.serve.split(",") if a]
    for item in (e for e in args.eager.split(",") if e):
        arch, _, layers = item.partition(":")
        results.append(profile_eager(dev, arch, int(layers or 0), args.steps))
    for r in results:
        print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for r in results:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
