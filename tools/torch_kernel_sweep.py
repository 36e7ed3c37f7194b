#!/usr/bin/env python3
"""Sweep the plans of the port's CUDA kernels on one card.

    python3 tools/torch_kernel_sweep.py [--only gemv,flash,host,decode,widths,tiled,router]

* K1's GEMV body (``slot_gmm`` with C = 1, 8 picks through the LUT, 97 slots
  cycled over 16 LUTs as in ``chip_smoke.py``) at the decode gate/up and
  down widths of qwen36-35b-a3b, in bf16, int8 and int4 (groups of 64): the
  device time of the wrapper's plan and of every other run length a warp
  could take (the splits follow from the run, at most a cluster of 8).
* K4 (``flash_attention``, bf16, dh 128, 32 heads on 4 KV heads) at the
  prefill shape and longer prompts, beside one
  ``scaled_dot_product_attention`` call on the same inputs.
* K2 (``decode_attention``, bf16, 32 heads on 4 KV heads, dh 128) at
  lengths 64, 576 and 1024 of a 1024-position cache and at 4096 of 4096:
  every plan of 4, 8 or 16 spans, tiles of 32 or 64 positions, on tensor
  cores or CUDA cores, beside one ``scaled_dot_product_attention`` call on
  the valid positions.
* ``widths``: K2 the same way at the dense families' serving shape (4 rows
  of a 1024-position cache at lengths 37 / 300 / 576 / 1024, bf16, 32 query
  heads) at dh 96 g 1 (phi3), dh 160 g 4 (pixtral), dh 64 g 1 (musicgen)
  and dh 128 g 4 (qwen3-4b); at tp-qwen3-4b's slice (2 rows of 512, both
  full, dh 128 g 4); and one row at length 576 for dh 96 g 1 and dh 160
  g 4; each beside SDPA (GQA) with a length mask.
* K1's tiled body at the prefill shape of ``chip_smoke.py`` (96 used slots,
  50 rows each, x [96,50,2048] @ [97,2048,768]) in bf16, int8 and int4
  (groups of 64): every tensor-core tile shape (D step 32 or 64, N tile 64
  or 128) and the CUDA-core body.
* The host's cost of one call of K1's bf16 GEMV at the decode gate/up
  shape, and of its parts: the wrapper (``ops.slot_gmm``), the launcher
  object with its arguments ready (``CudaKernel.__call__``), the bare
  ctypes launch, ``torch.empty`` of the output and
  ``torch.cuda.current_stream().cuda_stream`` (median of 5 rounds of 200
  calls on the host clock, no synchronization inside a round).

* K3's fused entry (``router_topk``: router GEMM + gate, D 2048, E 128,
  k 8, h2 bf16, as on the main path of qwen36-35b-a3b) at T = 1 and 512:
  spans of D (4, 8 or 16 blocks a cluster), every row tile (rows x columns
  a thread, rows a block) that fits, and the E-split variant (2 or 4 E
  tiles, each its own clusters); beside them the logits-in entry on the
  same logits, the three calls the fused entry replaced (``h2.float()``,
  the f32 GEMM, the logits-in gate) and the library composite (softmax of
  the GEMM, ``torch.topk``, renormalization). Then the host's cost of one
  fused call against the three it replaced (``ops.router_topk`` against
  ``ops.topk_gate(h2.float() @ router)``), and of one bare launch.

Kernel times are device times from ``chip_smoke.device_ms`` (repeated
calls in a CUDA graph). The card's ``nvidia-smi`` name and power limit come first.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core.slots import quantize_int8_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels.build import build
    from repro_torch.quant import quantize_int4_batch

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="gemv,flash,host,decode,widths,tiled,router",
                    help="comma-separated parts to run")
    only = set(ap.parse_args().only.split(","))
    print(cs.card_line(), flush=True)
    build(["moe_gmm.cu", "flash_attention.cu", "decode_attention.cu", "topk_gate.cu"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    luts = [torch.randperm(96, generator=g, device=dev)[:8].to(torch.int32) for _ in range(16)]
    cyc = iter(range(10 ** 9))
    plan_of = gmm.gemv_plan
    for d, f in ((2048, 768), (768, 2048)) if "gemv" in only else ():
        w = randn(97, d, f, scale=d ** -0.5)
        stores = {"bf16": (w, None, None), "int8": tuple(quantize_int8_batch(w)) + (None,),
                  "int4": tuple(quantize_int4_batch(w, 64))}
        x = randn(8, 1, d)
        for kind, (ww, sc, mn) in stores.items():
            base = plan_of(d, f, ww.dtype)
            cells = []
            for rw in (4, 8, 12, 16, 24, 32, 48, 64):
                rows = d // 2 if kind == "int4" else d
                splits = -(-rows // (gmm.GEMV_WARPS * rw))
                if splits > gmm.GEMV_MAX_SPLITS:
                    continue
                plan = dataclasses.replace(base, rows_per_warp=rw, splits=splits)
                gmm.gemv_plan = lambda *_, p=plan: p
                try:
                    ms = cs.device_ms(lambda: gmm.slot_gmm(x, ww, luts[next(cyc) % 16], sc, mn))
                finally:
                    gmm.gemv_plan = plan_of
                mark = "*" if rw == base.rows_per_warp else ""
                cells.append(f"{mark}run {rw}/{splits} splits {ms:.4f}")
            print(f"gemv {kind} x [8,1,{d}] @ [97,{d},{f}]: " + ", ".join(cells) + " ms "
                  "(* the wrapper's plan)", flush=True)
    flash_shapes = ((512, True), (512, False), (1024, True), (2048, True))
    for s, causal in flash_shapes if "flash" in only else ():
        q, k, v = randn(1, s, 32, 128), randn(1, s, 4, 128), randn(1, s, 4, 128)
        t = cs.device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 20)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ts = cs.device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        flops = 4 * 32 * 128 * (s * (s + 1) // 2 if causal else s * s)
        print(f"flash_attention s={s} causal={causal}: {t:.4f} ms ({flops / t / 1e9:.1f} "
              f"TFLOP/s), sdpa {ts:.4f} ms ({flops / ts / 1e9:.1f} TFLOP/s)", flush=True)

    if "decode" in only:
        decode_sweep(cs, randn)
    if "widths" in only:
        decode_width_sweep(cs, randn)
    if "tiled" in only:
        tiled_sweep(cs, randn, g, dev)
    if "router" in only:
        router_sweep(cs, g, dev)
    if "host" not in only:
        return 0
    x, w, lut = randn(8, 1, 2048), randn(97, 2048, 768), luts[0]
    out = torch.empty((8, 1, 768), dtype=torch.bfloat16, device=dev)
    plan = gmm.gemv_plan(2048, 768, torch.bfloat16)
    args = (x.data_ptr(), w.data_ptr(), lut.data_ptr(), 8, 1, 2048, 768, plan.rows_per_warp,
            plan.splits, int(plan.vector), out.data_ptr())
    gmm.KERNEL("slot_gmm_gemv_bf16", dev, *args)
    launcher = gmm.KERNEL._fns["slot_gmm_gemv_bf16"]
    stream = torch.cuda.current_stream().cuda_stream
    parts = {
        "ops.slot_gmm": lambda: ops.slot_gmm(x, w, lut),
        "CudaKernel call, arguments ready": lambda: gmm.KERNEL("slot_gmm_gemv_bf16", dev, *args),
        "ctypes launch": lambda: launcher(*args, stream),
        "torch.empty": lambda: torch.empty((8, 1, 768), dtype=torch.bfloat16, device=dev),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
    }
    for name, fn in parts.items():
        print(f"host per call, bf16 GEMV x [8,1,2048] @ [97,2048,768], {name}: "
              f"{host_us(fn):.2f} us", flush=True)
    return 0


def decode_sweep(cs, randn) -> None:
    """K2's plans at the decode shape, each beside SDPA on the valid positions."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec

    for s, length in ((1024, 64), (1024, 576), (1024, 1024), (4096, 4096)):
        caches = [(randn(1, s, 4, 128), randn(1, s, 4, 128)) for _ in range(8)]
        q = randn(1, 32, 128)
        lens = torch.tensor([length], dtype=torch.int32, device=q.device)
        lay = iter(range(10 ** 9))

        def kv():
            return caches[next(lay) % 8]

        def sdpa():
            k, v = kv()
            return F.scaled_dot_product_attention(
                q[:, :, None], k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2),
                enable_gqa=True)

        cells = plan_cells(cs, s, 128, 8, lambda: dec.decode_attention(q, *kv(), lens))
        print(f"decode_attention S={s} length={length}: " + ", ".join(cells)
              + f" ms; sdpa {cs.device_ms(sdpa):.4f} ms (* the wrapper's plan)", flush=True)


def plan_cells(cs, s, dh, g, call) -> list:
    """Device ms of ``call`` under every K2 plan of 4, 8 or 16 spans, tiles
    of 32 or 64, on tensor cores or CUDA cores (the wrapper's marked *)."""
    import torch

    from repro_torch.kernels import decode_attention as dec

    plan_of = dec.decode_plan
    base = plan_of(s, dh, g, torch.bfloat16)
    cells = []
    for tc in (True, False):
        for splits in (4, 8, 16):
            for tile in (32, 64):
                span = -(-(-(-s // splits)) // tile) * tile
                plan = dec.DecodePlan(-(-s // span), tile, span, tc)
                dec.decode_plan = lambda *_, p=plan: p
                try:
                    ms = cs.device_ms(call)
                finally:
                    dec.decode_plan = plan_of
                mark = "*" if plan == base else ""
                cells.append(f"{mark}{'tc' if tc else 'cc'} {plan.splits}x{span}/{tile} {ms:.4f}")
    return cells


def decode_width_sweep(cs, randn) -> None:
    """K2's plans at the dense families' serving shape, beside SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec

    serve = (cs.CACHE, cs.PAGED_LENS)
    shapes = [serve + (96, 32), serve + (160, 8), serve + (64, 32), serve + (128, 8),
              (512, (512, 512), 128, 8), (cs.CACHE, (576,), 96, 32), (cs.CACHE, (576,), 160, 8)]
    for s, lens_h, dh, hkv in shapes:
        b, h = len(lens_h), 32
        k, v, q = randn(b, s, hkv, dh), randn(b, s, hkv, dh), randn(b, h, dh)
        lens = torch.tensor(lens_h, dtype=torch.int32, device=q.device)
        mask = (torch.arange(s, device=q.device)[None, :] < lens[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask,
                                                  enable_gqa=True)

        cells = plan_cells(cs, s, dh, h // hkv, lambda: dec.decode_attention(q, k, v, lens))
        print(f"decode_attention dh={dh} g={h // hkv} [{b},{s}] lengths "
              f"{'/'.join(map(str, lens_h))}: " + ", ".join(cells)
              + f" ms; sdpa {cs.device_ms(sdpa):.4f} ms (* the wrapper's plan)", flush=True)


def tiled_sweep(cs, randn, g, dev) -> None:
    """K1's tiled body at chip_smoke's prefill grouping, every tile shape."""
    import torch

    from repro_torch.core.slots import quantize_int8_batch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.quant import quantize_int4_batch

    d, f = 2048, 768
    w = randn(97, d, f, scale=d ** -0.5)
    used = torch.randperm(96, generator=g, device=dev).to(torch.int32)
    x = randn(96, 50, d)
    stores = {"bf16": (w, None, None), "int8": tuple(quantize_int8_batch(w)) + (None,),
              "int4": tuple(quantize_int4_batch(w, 64))}
    for kind, (ww, sc, mn) in stores.items():
        plan_of = gmm.tiled_plan
        base = plan_of(d, f, torch.bfloat16, ww.dtype, 64 if kind == "int4" else 0)
        cells = []
        for plan in [gmm.TiledPlan(True, bk, bn) for bk in (32, 64) for bn in (64, 128)] + [
                gmm.TiledPlan(False)]:
            gmm.tiled_plan = lambda *_, p=plan: p
            try:
                ms = cs.device_ms(lambda: gmm.slot_gmm(x, ww, used, sc, mn), 20)
            finally:
                gmm.tiled_plan = plan_of
            name = f"tc k{plan.block_k} n{plan.block_n}" if plan.tensor_cores else "cuda cores"
            cells.append(f"{'*' if plan == base else ''}{name} {ms:.4f}")
        print(f"tiled {kind} x [96,50,{d}] @ [97,{d},{f}]: " + ", ".join(cells)
              + " ms (* the wrapper's plan)", flush=True)


def router_sweep(cs, g, dev) -> None:
    """K3's fused entry: plans, row tiles and the E-split variant at T = 1
    and 512, beside the calls it replaced; then the host's cost per call."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_gate as tk

    d, e, k = 2048, 128, 8
    router = torch.randn((d, e), generator=g, device=dev) * d ** -0.5
    for t in (1, 512):
        h = (torch.randn((t, d), generator=g, device=dev)).to(torch.bfloat16)
        base, tile = tk.router_plan(d, e), tk.router_tile(t, e)
        cells = []
        for splits in (4, 8, 16):
            plan = tk.RouterPlan(splits, d // splits, 1, e)
            ms = cs.device_ms(lambda: tk.router_topk(h, router, k, plan=plan))
            cells.append(f"{'*' if plan == base else ''}{splits} spans {ms:.4f}")
        print(f"router_topk T={t} spans of D: " + ", ".join(cells) + " ms (* the plan)", flush=True)
        cells = []
        for cand in [(1, 1, 1), (1, 1, 2), (2, 1, 4), (1, 4, 4), (2, 4, 16), (4, 4, 16),
                     (4, 4, 32)]:
            r, cv, rows = cand
            if rows > max(t, r) * 2 and rows > 4 or (rows // r) * (e // cv) > tk.ROUTER_THREADS:
                continue
            ms = cs.device_ms(lambda: tk.router_topk(h, router, k, tile=cand))
            cells.append(f"{'*' if cand == tile else ''}R{r} x {cv} cols, {rows} rows {ms:.4f}")
        print(f"router_topk T={t} row tiles: " + ", ".join(cells) + " ms (* the wrapper's)",
              flush=True)
        cells = []
        for etiles in (2, 4):
            plan = tk.RouterPlan(base.splits, base.span, etiles, e // etiles)
            cells.append(f"{etiles} E tiles {cs.device_ms(lambda: tk.router_topk(h, router, k, plan=plan)):.4f}")
        print(f"router_topk T={t} E-split: " + ", ".join(cells)
              + f" ms; one cluster per row tile {cs.device_ms(lambda: tk.router_topk(h, router, k)):.4f}",
              flush=True)
        lg = (h.float() @ router).contiguous()
        parts = {
            "fused": lambda: tk.router_topk(h, router, k),
            "logits-in gate": lambda: tk.topk_gate(lg, k),
            "three calls (cast, f32 GEMM, logits-in gate)": lambda: tk.topk_gate(h.float() @ router, k),
            "library composite": lambda: torch.topk(torch.softmax(h.float() @ router, -1), k),
        }
        print(f"router_topk T={t} device: " + ", ".join(
            f"{n} {cs.device_ms(fn):.4f}" for n, fn in parts.items()) + " ms", flush=True)
    h = torch.randn((1, d), generator=g, device=dev).to(torch.bfloat16)
    ids = torch.empty((1, k), dtype=torch.int32, device=dev)
    w = torch.empty((1, k), dtype=torch.float32, device=dev)
    plan, (r, cv, rows) = tk.router_plan(d, e), tk.router_tile(1, e)
    args = (h.data_ptr(), router.data_ptr(), 1, d, e, k, 1, plan.splits, plan.span, r, cv, rows,
            1, e, 0, 0, ids.data_ptr(), w.data_ptr())
    tk.KERNEL("router_topk_bf16", dev, *args)
    launcher = tk.KERNEL._fns["router_topk_bf16"]
    stream = torch.cuda.current_stream().cuda_stream
    parts = {
        "ops.router_topk (one fused call)": lambda: ops.router_topk(h, router, k),
        "the three calls it replaced (h2.float(), @ router, ops.topk_gate)":
            lambda: ops.topk_gate(h.float() @ router, k),
        "bare ctypes launch of the fused entry": lambda: launcher(*args, stream),
    }
    for name, fn in parts.items():
        print(f"host per call, routing x [1,{d}] bf16 @ [{d},{e}] f32, {name}: "
              f"{host_us(fn):.2f} us", flush=True)


def host_us(fn, calls: int = 200, rounds: int = 5) -> float:
    """Median over ``rounds`` of the host's microseconds per call of ``fn``,
    ``calls`` calls a round, the card synchronized between rounds."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(per)[rounds // 2]


if __name__ == "__main__":
    sys.exit(main())
