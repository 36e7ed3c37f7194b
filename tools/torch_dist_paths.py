#!/usr/bin/env python3
"""``chip_smoke.py``'s sharded paths alone, on the cards of this machine.

    python3 tools/torch_dist_paths.py [--paths ep-qwen36,sp-recurrentgemma-2b,pod-train-qwen36,
                                               tp-qwen3-4b,mp-rotary-qwen36,dp-train-qwen36,
                                               mp-train-qwen36,sp-train-qwen3-4b] [--no-rows]

Builds the kernels, runs the phase-3 rows at the sharded paths' shapes
(``chip_smoke.sharded_rows``: K1's tiled grouped entry as
``moe_epsum_local`` calls it, K4's chunk entry as ``_sp_attention`` calls
it, K2's partial entry at ``tp-qwen3-4b``'s cache slice, K4's partial chunk
entry at ``mp-rotary-qwen36``'s straddling chunk; ``--no-rows``
skips them), then each path of ``--paths`` (default: every sharded path of
``chip_smoke.DIST_PATHS``) exactly as
``chip_smoke.py`` runs it (``chip_smoke.run_dist_path``: its ranks through
``distributed/world.py``, then the check against the unsharded run), and
prints each path's line with the cards' names and power limits. The
backend follows the cards: on one card the ranks share it through
``gloo``; on a machine with as many cards as ranks each rank takes its
own card through ``nccl``. The last line is a JSON object of
the paths' figures.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default=None)
    ap.add_argument("--no-rows", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("torch_dist_paths: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.build import build

    torch.backends.cuda.matmul.allow_tf32 = False
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    cs.log(f"cards: {cards}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build()
    dev = torch.device("cuda")
    out = {"cards": cards, "rows": {}, "paths": {}}
    if not args.no_rows:
        g = torch.Generator(device=dev).manual_seed(1)
        for name, r in cs.sharded_rows(dev, g).items():
            cs.log(f"  {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3e}; kernel "
                   f"{r['ms']:.4f} / {r['device_ms']:.4f} ms, plain {r['plain_ms']:.4f}, library "
                   f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f}; bound "
                   f"{r['bound_ms']:.5f} ({r['bound_by']})")
            out["rows"][name] = {k: r[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                                   "plain_device_ms", "library_ms",
                                                   "library_device_ms", "bound_ms", "bound_by")}
    specs = {s.label: s for s in cs.DIST_PATHS}
    for label in (args.paths.split(",") if args.paths else list(specs)):
        r = cs.run_dist_path(dev, specs[label])
        cs.log(f"  {cards[0]}: {cs.dist_line(r)}")
        out["paths"][label] = {k: v for k, v in r.items() if k not in ("symbols",)}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
