"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id>``.

The ``--engine rotary`` path of ``repro.launch.serve`` on the card: host
warehouse, rotating device slots, pre-gated rotation, host miss correction.
Weights are random from ``--seed``. Like the reference CLI it runs the
reduced config by default; ``--full-width`` keeps the published widths and
``--layers N`` cuts the depth to the first N layers. ``--device`` defaults to
``cuda``; a missing card is an error.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--residency", default="rotary", choices=["full", "rotary", "static"])
    ap.add_argument("--slots", type=int, default=0, help="residency slots per layer")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--batch", type=int, default=1,
                    help="decode batch (requests served per group)")
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--full-width", action="store_true",
                    help="run the config's published widths (default: reduced)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to the first N layers (0 = the config's)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import RotaryEngine, resolve_device
    from repro_torch.models.transformer import Runtime, init_params

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduce_for_smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, segments=((("attn_moe",), args.layers),))
    params = init_params(cfg, args.seed, device, expert_device="cpu")
    slots = args.slots or cfg.moe.num_experts * 3 // 4
    b = max(1, args.batch)
    eng = RotaryEngine(
        cfg, params, ResidencyConfig(mode=args.residency, num_slots=slots),
        rt=Runtime(cache_len=args.cache_len), batch=b, seed=args.seed, device=device,
    )
    rng = np.random.default_rng(args.seed)
    for g0 in range(0, args.requests, b):
        n = min(b, args.requests - g0)
        prompt = rng.integers(0, cfg.vocab_size, (b, args.prompt_len)).astype(np.int32)
        out = eng.generate(prompt, args.max_new)
        for i in range(n):
            print(f"req {g0 + i}: {out[i].tolist()}")
    print("stats:", eng.stats.summary())
    print("per-layer residency:")
    print(eng.stats.per_layer_table())


if __name__ == "__main__":
    main()
