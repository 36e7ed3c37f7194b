#!/usr/bin/env python3
"""Where a decode token's time goes, path by path, on the card.

    python3 tools/torch_decode_profile.py [--paths full,bf16,bf16-prefetch,int4-prefetch]
                                          [--tokens 24] [--warm 4] [--prefills 1]
                                          [--out FILE] [--tree DIR]

Imports the port and ``chip_smoke.py`` of the tree at ``DIR`` (default: this
checkout) and builds each named path of its ``chip_smoke.py`` (``PATHS``:
qwen36-35b-a3b at its published widths, 8 layers, the path's residency,
slot format and decode switches: prefetch, the hot walk, host routing, LRU,
speculative windows; the same random weights), prefills one prompt of 512
tokens ``--prefills`` times (each timed: the path's prefill, legacy walk or
chunked, from the residency the one before left) and decodes ``--warm``
tokens (a windowed path: one window of each
size, so every graph is captured before the measurement), then measures
``--tokens`` decode tokens, in one decode call, twice:

1. host split: the wall time per token spent inside the engine's pieces,
   each timed inclusively by a wrapper (a piece's time includes the pieces
   it calls): a fused launch (device LUT rewrites, pointer check, graph
   replay), the blocking pulls (every ``Tensor.cpu``: the wait for the
   card), the hot walk's waits on its routing events, the suffix replays
   (fused step, window position, hot walk), the relaunches (step, window),
   ``ensure_resident``, the sync walk's layers and its LUT resolves (LRU's
   blocking uploads), the walk's pre-gating transitions (``prepare_layer``,
   also inside the rotations), the KV rollback, the upload calls
   (``SlotStore.write_batch``), the host miss GEMM, the rotations (step,
   window), ``begin_prefetch``, and on a sampled path the windows (launch to
   rotation) and the draw between them (``RotaryEngine._draw``: the
   logits' upload, a graph replay and the pull; a tree from before that
   graph draws eagerly, timed as ``sampling.sample_step``; the draws inside
   a window are graph replays);
2. device split: the same number of tokens under ``torch.profiler`` (CPU and
   CUDA activity): device time per token by kernel or copy name (the top
   ones), the device's total (kernels and copies, summed over streams), its
   share of the wall time (the busy share; idle = 1 - busy where the
   streams do not overlap) and the device operations (kernels, copies,
   memsets) per token.

Prints the card's ``nvidia-smi`` name and power limit, one block per path,
and one JSON line per path (also written to ``--out FILE`` when given). To
compare two trees on one card, run this on both, one after the other on the
same card: older, newer, newer, older (a tree from before speculative
windows were ported has its own copy of this tool: run that one on it).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _timers(engine, acc):
    """Wrap the engine's pieces (and the blocking pull) with inclusive wall
    timers accumulating into ``acc``; returns an undo function."""
    import torch

    from repro_torch.core import slots as slots_mod
    from repro_torch.models import transformer as tfm

    undo = []

    def wrap(owner, name, label):
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[label] += time.perf_counter() - t0

        setattr(owner, name, timed)
        undo.append(lambda: setattr(owner, name, fn))

    for name, label in (("_launch", "launch (LUT rewrite + replay)"),
                        ("_replay_fused", "suffix replay"), ("_relaunch_fused", "relaunch"),
                        ("_relaunch_window", "window relaunch"),
                        ("_replay_step", "hot-walk replay"),
                        ("_run_layers", "sync walk (layers)"),
                        ("_host_correct", "host miss GEMM")):
        wrap(engine, name, label)
    m = engine.manager
    for name, label in (("ensure_resident", "ensure_resident"),
                        ("rotate_from_telemetry", "rotation"),
                        ("rotate_window_from_telemetry", "window rotation"),
                        ("resolve", "LUT resolve (LRU loads)"),
                        ("prepare_layer", "prepare_layer (pre-gating)"),
                        ("begin_prefetch", "begin_prefetch")):
        wrap(m, name, label)
    wrap(tfm, "rollback_kv_window", "KV rollback")
    if hasattr(engine, "_window_launch"):              # trees with sampled decode
        from repro_torch.models import sampling

        wrap(engine, "_decode_window_fused", "window (launch to rotation)")
        if hasattr(engine, "_draw"):
            wrap(engine, "_draw", "draw between windows (upload, graph, pull)")
        else:
            wrap(sampling, "sample_step", "draw between windows (eager)")
    wrap(torch.cuda.Event, "synchronize", "routing waits (event)")
    wrap(slots_mod.SlotStore, "write_batch", "upload calls")
    wrap(torch.Tensor, "cpu", "blocking pulls (.cpu)")
    return lambda: [u() for u in reversed(undo)]


def profile_path(dev, cfg, depth, spec, tokens, warm, prefills=1):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import init_params

    import chip_smoke as cs

    params = init_params(cfg, 0, dev, expert_device="cpu")
    engine = cs.make_engine(dev, cfg, params, spec)
    del params
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, cs.PROMPT)).astype(np.int32)
    # a sampled path draws its tokens (trees older than sampled decode have no sampler_of)
    kw = {"sampler": cs.sampler_of(spec)} if getattr(spec, "sample", None) else {}
    prefill_ms = []
    for _ in range(max(prefills, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = engine.prefill(prompt)
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
    engine.decode(logits, warm, **kw)
    for k in range(getattr(spec, "spec_k", 1) - 1, 0, -1):      # capture every window size
        engine.decode(engine.last_logits, k, **kw)
    st = engine.stats

    def counters():
        return dict(replayed=st.replayed_steps, relaunched=st.relaunched_steps,
                    bytes=st.bytes_uploaded, converted=st.host_dequant_experts,
                    windows=st.spec_windows, drafted=st.drafted_tokens,
                    accepted=st.accepted_tokens, pulls=st.sync_pulls,
                    loads=sum(l.loads for l in st.layers.values()))

    # 1. host split
    acc = defaultdict(float)
    undo = _timers(engine, acc)
    c0 = counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode(engine.last_logits, tokens, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    undo()
    c1 = counters()
    host = {k: 1e3 * v / tokens for k, v in sorted(acc.items(), key=lambda kv: -kv[1])}

    # 2. device split
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode(engine.last_logits, tokens, **kw)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # the device's own events (kernels, copies, memsets); a CPU op's
        # device time repeats the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((ev.key, dt / 1e3 / tokens, ev.count / tokens))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    out = dict(
        path=spec.label, tokens=tokens, prefill_ms=prefill_ms,
        wall_ms_per_token=1e3 * wall / tokens,
        host_ms_per_token=host,
        per_token=dict(replayed=(c1["replayed"] - c0["replayed"]) / tokens,
                       relaunched=(c1["relaunched"] - c0["relaunched"]) / tokens,
                       mb_uploaded=(c1["bytes"] - c0["bytes"]) / 2**20 / tokens,
                       experts_converted=(c1["converted"] - c0["converted"]) / tokens,
                       windows=(c1["windows"] - c0["windows"]) / tokens,
                       sync_pulls=(c1["pulls"] - c0["pulls"]) / tokens,
                       loads=(c1["loads"] - c0["loads"]) / tokens),
        accepted_of_drafted=[c1["accepted"] - c0["accepted"], c1["drafted"] - c0["drafted"]],
        profiled_wall_ms_per_token=1e3 * wall_prof / tokens,
        device_ms_per_token=device_ms,
        device_busy_share=device_ms / (1e3 * wall_prof / tokens),
        device_ops_per_token=sum(r[2] for r in rows),
        top_device=[dict(name=n[:80], ms_per_token=ms, calls_per_token=c) for n, ms, c in rows[:14]],
    )
    del engine
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="full,bf16,bf16-prefetch,int4-prefetch")
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--prefills", type=int, default=1)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.kernels.build import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    print(cs.card_line(), flush=True)
    full = get_config("qwen36-35b-a3b")
    cfg = dataclasses.replace(full, segments=((("attn_moe",), cs.LAYERS),))
    specs = {p.label: p for p in cs.PATHS}
    results = []
    for label in args.paths.split(","):
        r = profile_path(torch.device("cuda"), cfg, full.num_layers, specs[label], args.tokens,
                         args.warm, args.prefills)
        results.append(r)
        r["tree"] = tree.name
        print(f"[{tree.name}/{label}] prefill ms {r['prefill_ms']}; "
              f"wall {r['wall_ms_per_token']:.2f} ms/token; per token: "
              f"{r['per_token']}; host (inclusive ms/token): "
              + ", ".join(f"{k} {v:.2f}" for k, v in r["host_ms_per_token"].items()), flush=True)
        print(f"  device {r['device_ms_per_token']:.3f} ms/token of "
              f"{r['profiled_wall_ms_per_token']:.2f} (busy share {r['device_busy_share']:.3f}), "
              f"{r['device_ops_per_token']:.0f} device operations a token; "
              f"top: " + "; ".join(f"{t['name']} {t['ms_per_token']:.3f} ms x{t['calls_per_token']:.0f}"
                                   for t in r["top_device"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for r in results:
                fh.write(json.dumps(r) + "\n")
    for r in results:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
