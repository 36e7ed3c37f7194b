#!/usr/bin/env python3
"""Time one MoE layer's routing call of a tree of this repository on the card.

    python3 tools/torch_routing_call.py [--tree DIR]

Imports the port (``src/repro_torch``) of the tree at ``DIR`` (default: this
checkout), builds its gate kernel, and times the call its model code makes
to route one MoE layer of qwen36-35b-a3b (D 2048, E 128, top-8,
renormalized): ``moe.route`` where the tree has it (one fused launch),
else ``moe.topk_route(moe.router_logits(...))`` (the cast, cuBLAS's f32
GEMM, then the logits-in gate). h2 is bf16 [T, 2048] at T = 1 (decode) and
512 (prefill), the router f32, both made from fixed seeds. Prints the card's
``nvidia-smi`` name and power limit, then one line a T: wall ms per call
(calls issued back to back between CUDA events) and device ms (the calls
replayed from a CUDA graph), both from the tree's own ``chip_smoke.py``.

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
        print("torch_routing_call: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.kernels.build import build
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    build(["topk_gate.cu"])
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    mcfg = get_config("qwen36-35b-a3b").moe
    g = torch.Generator(device=dev).manual_seed(7)
    d, e = 2048, mcfg.num_experts
    p = {"router": torch.randn((d, e), generator=g, device=dev) * d ** -0.5}
    fused = hasattr(moe, "route")
    for t in (1, 512):
        h2 = torch.randn((t, d), generator=g, device=dev).to(torch.bfloat16)
        if fused:
            call = lambda: moe.route(p, h2, mcfg)                        # noqa: E731
        else:
            call = lambda: moe.topk_route(moe.router_logits(p, h2), mcfg)  # noqa: E731
        iters = 50 if t == 1 else 20
        print(f"routing call of {tree.name} ({'fused' if fused else 'three calls'}), h2 [{t},{d}] "
              f"bf16 @ router [{d},{e}] f32, top-{mcfg.top_k}: {cs.time_ms(call, iters):.4f} ms per "
              f"call (wall), {cs.device_ms(call, iters):.4f} ms device", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
