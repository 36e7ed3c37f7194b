"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id>``.

``--engine batch`` serves through ``ServingEngine``, continuous batching
over a paged KV pool (the reference's default engine): ``--requests`` of
mixed prompt lengths (drawn in 4..``--prompt-len``, as the reference draws
them) decode in ``--batch-slots`` rows, with per-row speculative windows up
to ``--spec-cap``, a pool of ``--kv-pages`` pages of ``--kv-page-size``
positions, optional ``--warmup`` (captures the window graphs first) and
``--arrival-rate`` (a seeded Poisson replay on the wall clock: requests
join between ticks); it prints each request's tokens, then ``summary()``
(TTFT and inter-token p50/p99, windows, pages high-water mark, misses).
``--residency``, ``--slots``, ``--quantization``, ``--prefetch`` and the
sampling flags apply as to the rotary engine. A dense arch (``attn_mlp``
stacks: ``starcoder2-3b``, ``qwen3-4b``, ...) serves with every weight on
the device and no residency; ``--engine rotary`` refuses it, as the
reference's assert does. A recurrent arch (``recurrentgemma-2b``) serves
through the group tick, a fixed batch of ``--batch-slots`` rows, as the
reference chooses it (``ServingEngine(paged=None)``).

The ``--engine rotary`` path (the default) of ``repro.launch.serve`` on the card: host
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

Observability, as in the reference CLI: ``--trace-out PATH`` (either
engine) records the run with a ``repro_torch.obs.Tracer`` and writes its
Chrome trace-event JSON (Perfetto; ``python -m repro_torch.obs PATH``
audits it); ``--metrics-port PORT`` (``--engine batch``) serves the
engine's Prometheus exposition on ``127.0.0.1:PORT/metrics`` while it runs,
scrapes it once at the end and stops the server.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


# CLI spelling -> ResidencyConfig.quantization
QUANT_CHOICES = {"none": None, "int8": "int8", "int4": "int4"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--engine", default="rotary", choices=["rotary", "batch"],
                    help="rotary: RotaryEngine, one group of --batch requests at a time; "
                         "batch: ServingEngine, continuous batching over a paged KV pool")
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
    ap.add_argument("--batch-slots", type=int, default=4,
                    help="batch engine: rows decoding at once")
    ap.add_argument("--spec-cap", type=int, default=4,
                    help="batch engine: per-row speculative length cap (1 disables "
                         "speculation)")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="batch engine: KV pool size in pages (0 = batch-slots full rows)")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="batch engine: KV pool page size in cache positions")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="batch engine: Poisson arrival rate (requests/s); requests are "
                         "submitted on a seeded arrival trace while the engine ticks")
    ap.add_argument("--warmup", action="store_true",
                    help="batch engine: capture the window graphs before serving")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the run's events and write Chrome trace-event JSON to PATH "
                         "(Perfetto; audit with `python -m repro_torch.obs PATH`)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="batch engine: serve Prometheus metrics on 127.0.0.1:PORT/metrics "
                         "while the run is in flight (0 = off)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(list(argv) if argv is not None else None)

    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import RotaryEngine, resolve_device
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.obs import Tracer
    from repro_torch.serving.sampler import SamplerConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduce_for_smoke(cfg)
    if args.layers:
        unit = cfg.segments[0][0]          # the config's own unit, repeated
        cfg = dataclasses.replace(cfg, segments=((unit, args.layers),))
    if args.engine == "rotary" and not cfg.has_moe:
        raise ValueError(f"--engine rotary requires an MoE arch; {cfg.name} has no MoE "
                         f"layers (serve it with --engine batch)")
    params = init_params(cfg, args.seed, device, expert_device="cpu")
    slots = args.slots or (cfg.moe.num_experts * 3 // 4 if cfg.has_moe else 0)
    rescfg = ResidencyConfig(mode=args.residency, num_slots=slots,
                             quantization=QUANT_CHOICES[args.quantization],
                             quant_group_size=args.quant_group)
    tracer = Tracer() if args.trace_out else None
    if args.engine == "batch":
        _serve_batch(args, cfg, params, rescfg if cfg.has_moe else None, device, tracer)
        return
    b = max(1, args.batch)
    eng = RotaryEngine(
        cfg, params, rescfg,
        rt=Runtime(cache_len=args.cache_len), batch=b, seed=args.seed,
        host_routing=args.host_routing, fused_decode=args.fused_decode,
        spec_k=max(1, args.spec_k), prefetch=args.prefetch,
        prefill_chunk=args.prefill_chunk or None, trace=tracer, device=device,
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
    _write_trace(tracer, args.trace_out)


def _write_trace(tracer, path) -> None:
    if tracer is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        tracer.write(path)
        print(f"trace: {len(tracer)} events -> {path}")


def _serve_batch(args, cfg, params, rescfg, device, tracer) -> None:
    """``--engine batch``: the ServingEngine over mixed prompt lengths."""
    from repro_torch.models.transformer import Runtime
    from repro_torch.obs import serve_metrics
    from repro_torch.serving import SamplerConfig, ServingEngine

    eng = ServingEngine(
        cfg, params, rt=Runtime(cache_len=args.cache_len), num_slots=args.batch_slots,
        residency=rescfg,
        sampler=SamplerConfig(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p,
                              seed=args.seed if args.sample_seed is None else args.sample_seed),
        spec_cap=max(1, args.spec_cap), kv_page_size=args.kv_page_size,
        kv_pages=args.kv_pages or None, prefetch=args.prefetch, trace=tracer, device=device)
    metrics_server = None
    if args.metrics_port:
        metrics_server = serve_metrics(eng.metrics_registry, args.metrics_port)
        print(f"metrics: http://127.0.0.1:{args.metrics_port}/metrics")
    if args.warmup:
        print(f"warmup: {eng.warmup()} graphs captured")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, args.prompt_len + 1)))
               for _ in range(args.requests)]
    if args.arrival_rate > 0:
        # live Poisson replay: requests join the window at their arrival
        # times and the engine ticks between joins
        at = np.cumsum(rng.exponential(1.0 / args.arrival_rate, args.requests))
        at -= at[0]
        i, t0 = 0, time.perf_counter()
        while i < len(prompts) or not eng.scheduler.idle:
            now = time.perf_counter() - t0
            while i < len(prompts) and at[i] <= now:
                eng.submit(prompts[i], args.max_new)
                i += 1
            if not eng.scheduler.idle:
                eng.tick()
            elif i < len(prompts):
                time.sleep(min(1e-3, max(0.0, at[i] - now)))
        eng.stats.wall_s += time.perf_counter() - t0
        done = eng.scheduler.completed
    else:
        for p in prompts:
            eng.submit(p, args.max_new)
        done = eng.run()
    for r in done:
        print(f"req {r.uid}: prompt_len={len(r.prompt)} -> {r.output}")
    print("stats:", eng.summary())
    if metrics_server is not None:
        # one scrape of the live exposition, then the server stops
        from urllib.request import urlopen

        try:
            body = urlopen(f"http://127.0.0.1:{args.metrics_port}/metrics").read().decode()
        finally:
            metrics_server.shutdown()
            metrics_server.server_close()
        hists = sorted(line.split()[2] for line in body.splitlines()
                       if line.startswith("# TYPE ") and line.endswith(" histogram"))
        print(f"metrics: scraped {len(body.splitlines())} exposition lines; histograms "
              f"{', '.join(hists)}")
    _write_trace(tracer, args.trace_out)


if __name__ == "__main__":
    main()
