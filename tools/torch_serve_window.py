#!/usr/bin/env python3
"""Serving window time of one request alone and of four at once, on the card.

    python3 tools/torch_serve_window.py [--tree DIR] [--arch A --layers N]...

Builds ``ServingEngine`` (4 rows, pages of 16, windows up to 4, cache_len
1024, weights at published widths from seed 0) for each ``--arch`` (cut to
``--layers`` of its unit; 0 keeps every layer), captures its window graphs
(``warmup``), then serves one request of 445 prompt tokens + 32 new alone
and then four such requests at once, and prints the median wall ms of a
serving window (``window_ms``: launch, pull and the host's bookkeeping) and
the median time to the first token (the admission prefill) for each, with
the card's name and power limit. ``--tree DIR`` imports the
package from another checkout (``DIR/src``): run a parent tree and this one
in one call to compare the two on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


PROMPT = 445               # a serving prompt length under its power-of-two bucket (512)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--layers", type=int, action="append", default=None)
    args = ap.parse_args()
    archs = args.arch or ["qwen36-35b-a3b", "starcoder2-7b"]
    layers = args.layers or [8, 0]
    sys.path.insert(0, str(Path(args.tree) / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_window: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.config import get_config
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.serving import ServingEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = {"tree": args.tree, "card": card}
    for arch, n in zip(archs, layers):
        cfg = get_config(arch)
        if n:
            cfg = dataclasses.replace(cfg, segments=((cfg.segments[0][0], n),))
        params = init_params(cfg, 0, "cuda", expert_device="cpu")
        eng = ServingEngine(cfg, params, rt=Runtime(cache_len=1024), num_slots=4, spec_cap=4,
                            kv_page_size=16, device="cuda")
        del params
        eng.warmup()
        rng = np.random.default_rng(0)
        row = {}
        for live in (1, 4):
            hist = eng.metrics.histogram("window_ms", "wall ms per serving window")
            hist.reset()
            reqs = [eng.submit(rng.integers(0, cfg.vocab_size, PROMPT), 32) for _ in range(live)]
            eng.run()
            torch.cuda.synchronize()
            row[f"window_ms_{live}_live"] = hist.percentile(50)
            row[f"windows_{live}_live"] = hist.count
            row[f"ttft_ms_{live}_live"] = float(np.median(
                [1e3 * (r.first_token_at - r.submitted_at) for r in reqs]))
        out[f"{arch}/{cfg.num_layers}"] = row
        print(f"{card}: {arch} ({cfg.num_layers} layers): {row}", flush=True)
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
