"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id>``.

The ``--engine rotary`` path of ``repro.launch.serve`` on the card: host
warehouse, rotating device slots, pre-gated rotation, host miss correction.
Weights are random from ``--seed``. Like the reference CLI it runs the
reduced config by default; ``--full-width`` keeps the published widths and
``--layers N`` cuts the depth to the first N layers. ``--quantization
int8|int4`` (with ``--quant-group``) serves from quantized slot stores.
``--prefetch`` serves with double-buffered predictive prefetch and the miss
relaunch; ``--no-prefetch`` (the default) keeps synchronous rotation.
``--spec-k K`` decodes in K-position speculative windows. The reference's
other decode paths: ``--no-fused-decode`` walks the layers on the device
(the per-layer hot walk), ``--host-routing`` routes every layer on the host
(the seed baseline) and ``--residency lru`` answers misses with blocking
loads (both the per-layer sync walk). ``--prefill-chunk C`` ingests each
prompt in power-of-two chunks of at most C tokens (the fused engine: one
launch per chunk; the walks: the same chunks layer by layer).
``--temperature T`` (> 0) samples, with ``--top-k``, ``--top-p`` and
``--sample-seed`` (default ``--seed``); draws are keyed by request row and
cache position, so a seed reproduces its tokens bit for bit. ``--device``
defaults to ``cuda``; a missing card is an error. On the card the decode
step, each window size and sampler, and each chunk length run as CUDA graph
replays.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np


# CLI spelling -> ResidencyConfig.quantization
QUANT_CHOICES = {"none": None, "int8": "int8", "int4": "int4"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--residency", default="rotary", choices=["full", "rotary", "lru", "static"])
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
    ap.add_argument("--quantization", default="none", choices=sorted(QUANT_CHOICES),
                    help="slot-store weight format (int4 = grouped "
                         "two-nibbles-per-byte, ~4x smaller rotations)")
    ap.add_argument("--quant-group", type=int, default=64,
                    help="int4 rows per scale/min group (Q4_K_M-style)")
    ap.add_argument("--prefetch", action=argparse.BooleanOptionalAction, default=False,
                    help="double-buffered predictive prefetch (shadow-generation uploads "
                         "on a copy stream under the in-flight step, boundary = "
                         "confirm/correct/flip) and the miss relaunch; --no-prefetch "
                         "(the default) keeps the synchronous rotation path")
    ap.add_argument("--host-routing", action="store_true",
                    help="seed-style per-layer host routing (benchmark baseline)")
    ap.add_argument("--fused-decode", action=argparse.BooleanOptionalAction, default=None,
                    help="require the fused whole-stack step (--fused-decode) or force the "
                         "per-layer hot walk (--no-fused-decode); default: fused where the "
                         "routing and the policy allow it")
    ap.add_argument("--spec-k", type=int, default=1,
                    help="speculative window (tokens per fused launch; 1 = single-token "
                         "decode)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: power-of-two chunk length (0 = the legacy "
                         "full-sequence layer walk); one launch and one rotation per chunk")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax; > 0 draws from the warped "
                         "distribution through the same windows, kept exact by stochastic "
                         "acceptance)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits before sampling (0 = no cut)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling: keep the smallest prefix of probability mass "
                         ">= p (1.0 = no cut)")
    ap.add_argument("--sample-seed", type=int, default=None,
                    help="seed of the sampling streams (default: --seed); draws are keyed "
                         "per row and position, so a seed reproduces its tokens bitwise")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import RotaryEngine, resolve_device
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.serving.sampler import SamplerConfig

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
        cfg, params, ResidencyConfig(mode=args.residency, num_slots=slots,
                                     quantization=QUANT_CHOICES[args.quantization],
                                     quant_group_size=args.quant_group),
        rt=Runtime(cache_len=args.cache_len), batch=b, seed=args.seed,
        host_routing=args.host_routing, fused_decode=args.fused_decode,
        spec_k=max(1, args.spec_k), prefetch=args.prefetch,
        prefill_chunk=args.prefill_chunk or None, device=device,
    )
    sampler = None
    if args.temperature > 0.0:
        sampler = SamplerConfig(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed if args.sample_seed is None else args.sample_seed)
    rng = np.random.default_rng(args.seed)
    for g0 in range(0, args.requests, b):
        n = min(b, args.requests - g0)
        prompt = rng.integers(0, cfg.vocab_size, (b, args.prompt_len)).astype(np.int32)
        out = eng.generate(prompt, args.max_new, sampler=sampler)
        for i in range(n):
            print(f"req {g0 + i}: {out[i].tolist()}")
    print("stats:", eng.stats.summary())
    print("per-layer residency:")
    print(eng.stats.per_layer_table())


if __name__ == "__main__":
    main()
