#!/usr/bin/env python3
"""Time K4's partial chunk entry and K2's bf16 decode at dh 96 / 160 of a
tree of this repository on the card.

    python3 tools/torch_attention_ab.py [--tree DIR]

Imports the port (``src/repro_torch``) and ``chip_smoke.py`` of the tree at
``DIR`` (default: this checkout), builds its two attention sources, and runs
that tree's own phase-3 rows for them: ``chunk_partial_row`` (a 128-token
chunk of qwen36's 32 heads on 4 KV heads, dh 128, at positions 512-639
against a rank's 576-position slice, offset 0) and ``k2_rows`` at phi3's
dh 96 g 1 and pixtral's dh 160 g 4 (4 rows of a 1024-position cache at
lengths 37 / 300 / 576 / 1024, contiguous and paged). Each row is held to
its plain version inside those functions. Prints the card's ``nvidia-smi``
name and power limit, then one line a row: device ms (calls replayed from
a CUDA graph) of the kernel, its plain version and the library call, the
wall ms per call, and the bound.

To compare two commits on one card, unpack the older one (``git archive``)
into a directory that ``.gitignore`` lists and run this on both trees, one
after the other on the same card: older, newer, newer, older.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    tree = Path(ap.parse_args().tree).resolve()
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.kernels.build import build

    build(["flash_attention.cu", "decode_attention.cu"])
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {"flash_attention_chunk_partial": cs.chunk_partial_row(dev, g)}
    for tag, dh, h, hkv, _ in cs.K2_WIDTHS[:2]:
        for entry, r in cs.k2_rows(dev, g, dh, h, hkv).items():
            rows[f"{entry}_{tag}"] = r
    for name, r in rows.items():
        print(f"{tree.name} {name}: device kernel {r['device_ms']:.4f}, plain "
              f"{r['plain_device_ms']:.4f}, library {r['library_device_ms']:.4f} ms; wall "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} "
              f"ms; bound {r['bound_ms']:.5f} ms ({r['bound_by']}); max_abs_err "
              f"{r['max_abs_err']:.3e}; {r['shape']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
