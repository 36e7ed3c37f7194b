#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (nothing is caught):

1. require a CUDA device; print the card's name and power limit;
2. build the kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all at once) and print each one's ptxas report;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and time kernel, plain version, one
   library call computing the same function (for the int8/int4 bodies of
   the grouped matmul no single call does: a composite of dequantize +
   ``index_select`` + ``bmm`` stands in), and the card's bound. Each is
   timed two ways: ``ms`` is the wall time per call issued back to back
   from Python between CUDA events (the device time, or the host's cost of
   a call where that is larger: the yardstick of every earlier run), and
   ``device_ms`` the device time alone (the calls captured in a CUDA graph
   and replayed). The GB/s, TFLOP/s and share of the bound each kernel
   reached are printed for both. The GEMV bodies are also timed at the
   decode down-projection. K3 has two entries, one kernel source and one
   launch count: the logits-in gate (the Pallas function's counterpart)
   and the fused router GEMM + gate that the model calls (``router_topk``),
   held at T = 1 and 512 and timed beside its plain version, the library
   composite and the three calls it replaced. Chunked prefill's entries:
   K4's chunk-append entry at C in {1, 4, 128} and cur_len in {0, 384}
   (timed at 128 / 384 beside SDPA with an explicit causal-offset mask) and
   K1's ragged entry, a 128-token chunk's 1,024 picks over 97 slots in
   bf16, int8 and int4 (beside index_select (+ dequantize) + bmm over the
   rows padded by slot; its plain version reads the offsets on the host, so
   only its wall time is taken). At the dense families' widths (``base``:
   the kernel or entry a row is a width of): K4's causal entry at 512
   queries for dh 64 (32/32 heads), 96 (32/32), 160 (32/8) and 256 (10/1),
   its chunk entry at dh 160, and K2's contiguous and paged entries at dh 96
   g 1, dh 160 g 4, dh 128 g 9 and g 12, each held to its plain version and
   timed beside SDPA; the JSON row gives ``width_launches``, the launches on
   the paths that run that width. At the sharded paths' shapes: K1's tiled
   grouped entry as ``moe_epsum_local`` calls it (a rank's 64 experts at
   capacity 80, x [64, 80, 2048] @ W [64, 2048, 768], beside ``bmm`` over
   the gathered experts) and K4's chunk entry as ``_sp_attention`` calls it
   (768 queries of 10 heads at dh 256 at offsets 0 and 2,304 against 3,072
   keys, window 2,048, beside band-masked SDPA), K2's partial entry at
   ``tp-qwen3-4b``'s slice and K4's partial chunk entry as ``_tp_chunk``
   calls it on ``mp-rotary-qwen36`` (the 128-token chunk at 512-639 against
   a rank's 576 of 1,152 positions, at offsets 0 and 576 and merged over
   the two slices against the chunk entry, beside the aten
   memory-efficient SDPA with lse and a causal-offset bias);
4. run twenty paths of ``RotaryEngine.generate`` on ``qwen36-35b-a3b`` at
   its published widths, cut to the first 8 of its 48 layers (the depth is
   the only cut: 8 layers of host warehouse are 9.7 GB, the whole model's
   would be 58 GB, made at random on every run), batch 1, cache_len 1024,
   each decode step, window size and sampler, and prefill chunk length one
   CUDA graph (captured on first use), greedy unless said:
   * ``bf16``: rotary residency with 96 of 128 expert slots in bf16,
     synchronous rotation, 2 requests of 512 prompt tokens and 64 new
     tokens;
   * ``int4``: the same in int4 slots (groups of 64);
   * ``int8``: int8 slots, 1 request of 512 + 16 tokens;
   * ``full``: all 128 experts resident in bf16, 1 request of 512 + 64: it
     must make no miss and no replay, and exactly one blocking pull per
     decode token (prefill's pulls counted apart): the graph's miss-free
     per-token floor;
   * ``bf16-prefetch``: 96/128 bf16 slots with ``prefetch=True`` (shadow
     uploads on a copy stream under the replay, the miss relaunch), the
     ``bf16`` path's requests: it must relaunch some step, replay a smaller
     share of its steps than ``bf16`` did, and give ``bf16``'s greedy ids up
     to the first position whose truth top-2 margin is under phase 5's
     guard;
   * ``int4-prefetch``: the same in int4 slots, 1 request of 512 + 16, held
     to ``int4`` the same way (its packed shadow planes);
   * the walks and windows: ``bf16-walk`` (the per-layer hot walk),
     ``bf16-hostroute`` (host routing), ``bf16-lru`` (LRU), ``bf16-spec4``
     and ``bf16-prefetch-spec4`` (windows of 4), each held to ``bf16``'s
     greedy ids, and ``full-spec4`` to ``full``'s;
   * chunked prefill (``prefill_chunk=128``): ``full-chunk`` (the same 512
     + 16 request twice, the second without the graphs' captures: no miss,
     no replay, one graph replay and one blocking pull a chunk),
     ``bf16-chunk`` (96/128, prompts of 512 and 509, whose plan ends in 4-
     and 1-token chunks, + 32), ``bf16-chunk-walk`` (the same requests
     walked layer by layer: each prompt's prefill logits from the
     warm-start residency must equal ``bf16-chunk``'s bit for bit; the
     first request's is the run's own, each later one is prefilled again
     on a fresh engine of each path, since the fused step and the hot walk
     leave other slots after they decode), ``int8-chunk`` and
     ``int4-chunk-prefetch`` (512 + 16);
     each held to its legacy path's greedy ids on the prompts both served,
     and K4's chunk entry must launch on each (and on no legacy path). On
     every path the prefill sorts its picks by slot through the format's
     K1 ragged entry (the tiled body's grouped entry launches on none);
   * sampled decode (temperature 0.8, top-k 50, top-p 0.95, seed 7):
     ``full-sample`` (the same 512 + 64 request twice: the two streams must
     be equal), ``full-sample-spec4`` (windows of 4: its stream must equal
     ``full-sample``'s) and ``bf16-sample-spec4`` (96/128, its accept rate
     printed).
   Then five ``ServingEngine`` paths on the same cut of qwen36 (4 rows,
   pages of 16, windows up to 4, eight requests of prompts drawn in 64-512
   from the run's seed + 32 new tokens each, all submitted at once:
   ``serve-full``, ``serve-bf16``, ``serve-int4``, ``serve-int4-prefetch``,
   ``serve-sample``), and the other families, each model made from the
   run's seed and freed before the next:
   * ``serve-qwen3-4b`` (36 layers), ``serve-starcoder2-7b`` (32) and
     ``serve-phi3-mini`` (32): dense ``attn_mlp`` stacks at their published
     widths and full depth through ``ServingEngine``, the serving paths'
     traffic; every request's tokens equal the same request served alone
     (margin guard), accept rate 1.000, no miss and no MoE kernel;
   * ``pixtral-frontend`` (the first 16 of 40 layers, so that the f32
     truth fits beside it) and ``musicgen-frontend`` (48 layers):
     ``prefill_model`` with 1,024 (256) frontend embeddings drawn from the
     seed before 512 (256) tokens, cache_len 2048 (1024), then 32 greedy
     ``decode_model`` steps;
   * ``serve-full-group``, ``serve-recurrentgemma-2b`` and
     ``decode-xlstm-350m`` (4 rows of 512 tokens, 31 greedy
     ``decode_model`` steps; each row run again alone inside the batch's
     allocation, ``prefill_model(rows=4)``, must give the batch's logits
     bit for bit);
   * the training paths, ``train-qwen36`` (the first 4 of 48 layers, 3.11
     B parameters, MoE through the sorted dispatch at capacity factor 1.25,
     so assignments drop) and ``train-recurrentgemma-2b`` (26 layers): 4 x
     512 ``topic`` tokens a step, bf16, AdamW, ``dots_saveable``. Step 0's
     loss and grad norm against an f32 recomputation on the card (the
     weights upcast, the bf16 routing replayed: |loss diff| <= 0.002 nats,
     |grad norm ratio - 1| <= 1%); 12 straight steps with a checkpoint
     after 6, the last loss below the first; 6 steps again from the seed,
     the parameters bitwise the straight run's there; the checkpoint
     restored into a fresh state and 6 more steps, bitwise the straight
     run's end; no kernel launched (none has a backward). Each prints
     median step ms, tokens/s, MFU (``model_flops`` over 989 TFLOP/s),
     peak memory, and the checkpoint's MB and save / write / restore ms;
   * the sharded paths, each a world of ranks on the card started by
     ``repro_torch.distributed.world.run_world`` (spawned processes, a
     FileStore rendezvous, gloo: the ranks share the card; a rank that
     fails or outlives DIST_TIMEOUT fails the path), then checked in this
     process against an unsharded run of the same weights:
     ``ep-qwen36`` (qwen36's 8-layer cut, mesh data 2 x model 2, each rank
     64 of 128 experts a layer: ``prefill_model`` of 4 x 512 tokens, two rows
     a data rank, through ``moe_epsum_local``, then 16 greedy
     ``decode_model`` steps through ``moe_epsum_decode_local``; the model
     ranks of a data rank bitwise equal; against one process holding the
     whole store, ``moe_sorted`` at the epsum capacity in prefill and
     ``moe_apply_routed`` in decode, fed the sharded run's greedy ids and
     top-k choices: each step's RMS(diff) / RMS(logits) <= EP_RMS_TOL and
     the greedy ids equal wherever the unsharded top-2 margin exceeds twice
     the step's largest |diff|), ``sp-recurrentgemma-2b`` (26 layers, mesh
     1 x 4, one 3,072-token prompt: each ``local_attn`` layer's queries split
     over the ranks, ``_sp_attention`` through K4's chunk entry at window
     2,048; logits and every KV cache against the unsharded
     ``prefill_model``, within the kernel tolerance, bitwise printed) and
     ``pod-train-qwen36`` (1 of 48 layers, 2 pods, 2 x 512 topic tokens a
     pod, 3 steps of ``make_train_step(pod_compression=True)``: the pods'
     parameters bitwise equal after every step,
     step 0's int8 payloads of every leaf up to 2**24 elements bitwise a
     plain numpy recomputation, and step 0's loss within TRAIN_LOSS_TOL of
     one process taking the 4 x 512 batch uncompressed in two
     microbatches), ``mp-train-qwen36`` (1 of 48 layers, mesh data 2 x
     model 2, 4 x 512 topic tokens, 3 steps of ``make_train_step`` over
     the model axis: heads, experts (``moe_epsum_train``) and the
     vocabulary split, ZeRO-1; then 3 steps from the same seed with FSDP
     storage) and ``sp-train-qwen3-4b`` (1 of 36 layers, mesh 1 x 3, one
     row of 3,072 tokens, 2 steps: 32 heads do not divide 3, so attention
     trains sequence-parallel), each held to one process training the
     same global batch unsharded (run before the world): step 0's loss
     and cross-entropy within MP_LOSS_TOL, its gradient norm within
     MP_GNORM_TOL, the parameters after step 0
     within MP_RMS_TOL relative RMS, the leaves every model rank holds
     whole bitwise equal across the model ranks and the data ranks'
     parameters bitwise equal after step 0, FSDP's losses and final
     parameters against the run without it (MP_FSDP_TOL); no kernel
     launched (none has a backward); and ``mp-rotary-qwen36`` (the first 4
     of 48 layers, mesh data 1 x model 2: ``RotaryEngine`` over the model
     axis, each rank's slots split on F (384 of 768 expert columns), its
     heads, vocabulary columns and 576 of 1,152 cache positions; one
     640-token prompt in chunks of 128, the fifth straddling the slices,
     then 32 greedy steps, for full residency, rotary at ROT_SLOTS and
     rotary in windows of 4, each held to the ranks bitwise (tokens,
     logits, telemetry, routing, transitions), to the f32 truth under
     ``judge`` fed the run's committed routing (its top-k apart: a pick
     only at a near-tie), rotary to full's and spec 4 to spec 1's greedy
     ids under the margin guard, a miss corrected and a suffix replayed,
     and rotary's logits to the unsharded RotaryEngine on the card at the
     positions both route alike, within ROT_RMS_TOL). Every ep rank must
     launch K3's fused entry and K1's tiled grouped entry, every sp rank
     K4's chunk entry, every mp-rotary rank K3's fused entry, K1's GEMV
     and ragged entry and the partial entries of K2 and K4; the ranks'
     launches count with the run's. Each prints its backend, ranks, mesh,
     prefill / decode / step times, peak GiB a rank, and the collectives'
     host-timed ms;
   * ``dbrx-int4``: dbrx-132b at published widths, the first 2 of 40
     layers (its 16 experts of 198M parameters are 12.7 GB a layer pair
     in bf16), RotaryEngine with 12 of 16 int4 slots, 1 request of 512 +
     32 tokens (K1 at D 6144 / F 10752, K3 at E 16, k 4).
   Each path starts from the same random weights and frees its engine, and
   its warehouse, before the next; the kernels' launch counters are zeroed
   just before each path and read just after (a graph replay adds the
   launches its capture recorded), and every kernel must have launched on
   some path; K3's fused entry must have launched on every path and its
   logits-in entry on none (every routing site is fused). K1's tiled body
   counts its two entries (grouped, ragged) as one kernel, as K3 does; the
   JSON line gives each entry's own launches beside the kernel's. A quantized path
   also checks that the card's quantization of layer 0 equals the CPU
   quantizer's byte for byte (dbrx: its first expert), and that every
   upload shipped exactly one packed expert (qwen36: 2,654,208 bytes int4,
   4,732,928 int8; dbrx: 111,476,736 int4). Each path prints
   its graph captures and replays, relaunched and replayed steps, MB
   uploaded per decode token, missed experts converted on the host, the
   prefetch counters (with the copy stream's event-timed upload time) and
   its peak device memory.
   Every ``RotaryEngine`` and ``ServingEngine`` path runs with a
   ``repro_torch.obs.Tracer``; its trace of the path's measured run is
   written to ``build/traces/<label>.json`` and audited right after it
   (``repro_torch.obs.audit``: one launch and one pull per miss-free unit,
   rotation after the pull, prefetch ships between launch and pull, no KV
   page used after release); any violation fails the path. The path prints
   units checked, miss-free units, launches, pulls, rotations, prefetch
   spans, KV events, events recorded, the span-derived overlap beside
   ``stats.overlap_ms``, and the file's size. The units must be those the
   path ran: each fused decode step or window (counted around the engine's
   calls) and each fused prefill chunk (the walks open none), and each
   serving tick that launched (one launch and one pull each); on ``full``,
   ``full-spec4``, ``full-chunk``, ``serve-full`` and ``serve-full-group``
   every unit is miss-free; on a prefetch path the spans' overlap is
   ``stats.overlap_ms`` within 1%; on a paged serving path the pool was
   traced and the request lanes are the submitted uids, each with
   ``queued``, ``prefill`` and ``finish`` (the group tick's with
   ``queued`` and ``prefill``, as in the reference). Two controls must be
   flagged: ``full``'s trace with one ``pull`` copied into a miss-free
   unit, and ``serve-full``'s with one ``kv_use`` moved past its pages'
   ``kv_release``. ``full``'s request runs again untraced on an engine of
   the same weights: the same tokens and counters, and the median step ms
   of both runs printed (not gated: the host varies 2x between runs).
   Then ``repro_torch.launch.serve.main`` once, in process: ``--engine
   batch`` on qwen36 at published widths, 2 layers, 4 rows, 4 requests of
   8 new tokens, ``--trace-out build/traces/cli.json`` and
   ``--metrics-port`` on a free loopback port; its trace must audit with
   exit code 0 through ``repro_torch.obs``'s ``main``, and its one scrape
   must show the ``ttft_ms`` and ``itl_ms`` histograms;
5. after each path, check the engine's prefill logits and its decode logits
   against a plain full-residency forward of the same weights on the card
   (``kernels/ref.py`` called directly; for a quantized path the weights
   are dequant(quant(w))), and that every miss was corrected on the host;
   for ``bf16`` and ``int4`` a control follows: the first request again, fed
   the same tokens, with the host miss correction switched off, must fail
   that check (so the check can see a broken engine). A sampled request is
   held to the truth on its own drawn tokens. The frontend paths hold their
   prefill and every decode logits (the frontend embeddings first in the
   truth too) and the dense serving paths their first-token logits and
   greedy ids the same way;
6. print the paths side by side, the kernels' JSON line, the card line, and
   last the result line.

Tolerances. Kernel vs plain version (phase 3), outputs in bf16: |kernel -
plain| <= 2e-2 + 2e-2 |plain| (f32 sums in another order, one more bf16
rounding of outputs of magnitude ~1); the int8/int4 bodies give f32 outputs
from the same planes, held to 1e-4 + 1e-4 (f32 sums in another order); the
gate's ids exactly, wherever the k-th and (k+1)-th probabilities differ.
Engine vs reference (phase 5): the engine computes in bf16 like the model it
serves, so it is held to the f32 forward of the same weights ("truth") as
tightly as a plain bf16 forward is (for a quantized path: the dequantized
weights cast to bf16, what the reference's main path runs): per request,
the RMS over all positions and vocabulary entries of (engine - truth) may
exceed that of (plain bf16 - truth) by at most a factor 1.5 plus 0.01, the
largest per-position error by at most a factor 1.5 plus 0.05, and the
engine's greedy id must equal the truth's wherever the truth's top-2 margin
exceeds twice the plain bf16 forward's largest error. K3's fused entry
against its plain version (cuBLAS's f32 GEMM, then the plain gate): the two
sum the router GEMM in other orders, so ids must be equal on every row whose
plain k-th and (k+1)-th probabilities differ by more than 1e-6 and weights
agree to 1e-5 + 1e-5; on small integers (exact sums) ids equal everywhere.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor peak (data sheet)
F32_FLOPS = 67e12                  # H100 SXM f32 peak outside the tensor cores (data sheet)
TRACE_DIR = ROOT / "build" / "traces"
LAYERS = 8
PROMPT, NEW, REQUESTS, CACHE = 512, 64, 2, 1024
SLOTS = 96


class PathSpec(NamedTuple):
    label: str
    quantization: Optional[str]
    slots: int                  # 0: full residency
    prefetch: bool
    requests: int
    new: int
    control: bool               # phase 5's control run (misses left uncorrected)
    baseline: Optional[str]     # the path whose greedy ids this one is held to
    lru: bool = False           # LRU residency (the sync walk, blocking loads)
    host_routing: bool = False  # the seed baseline (the sync walk, host top-k)
    fused_decode: Optional[bool] = None     # False: the per-layer hot walk
    spec_k: int = 1             # > 1: speculative windows
    chunk: int = 0              # > 0: chunked prefill in chunks of this many tokens
    prompt_lens: Tuple[int, ...] = ()       # per request (default PROMPT each)
    sample: Optional[Tuple[float, int, float, int]] = None  # temperature, top-k, top-p, seed
    same_prompt: bool = False   # every request the first one again: the streams must be equal
    prefill_twin: Optional[str] = None      # the path whose prefill logits this one equals
    quant_check: int = 0        # experts of layer 0 held to the CPU quantizer (0: all)
    untraced_twin: bool = False  # the run again untraced: the same tokens and counters


CHUNK = 128
SAMPLE = (0.8, 50, 0.95, 7)
PATHS = (
    PathSpec("bf16", None, SLOTS, False, REQUESTS, NEW, True, None),
    PathSpec("int4", "int4", SLOTS, False, REQUESTS, NEW, True, None),
    PathSpec("int8", "int8", SLOTS, False, 1, 16, False, None),
    PathSpec("full", None, 0, False, 1, NEW, False, None, untraced_twin=True),
    PathSpec("bf16-prefetch", None, SLOTS, True, REQUESTS, NEW, False, "bf16"),
    PathSpec("int4-prefetch", "int4", SLOTS, True, 1, 16, False, "int4"),
    PathSpec("bf16-walk", None, SLOTS, False, 1, 32, False, "bf16", fused_decode=False),
    PathSpec("bf16-hostroute", None, SLOTS, False, 1, 16, False, "bf16", host_routing=True),
    PathSpec("bf16-lru", None, SLOTS, False, 1, 32, False, "bf16", lru=True),
    PathSpec("full-spec4", None, 0, False, 1, NEW, False, "full", spec_k=4),
    PathSpec("bf16-spec4", None, SLOTS, False, 1, 32, False, "bf16", spec_k=4),
    PathSpec("bf16-prefetch-spec4", None, SLOTS, True, 1, 32, False, "bf16", spec_k=4),
    PathSpec("full-chunk", None, 0, False, 2, 16, False, "full", chunk=CHUNK, same_prompt=True),
    PathSpec("bf16-chunk", None, SLOTS, False, 2, 32, False, "bf16", chunk=CHUNK,
             prompt_lens=(PROMPT, PROMPT - 3)),
    PathSpec("bf16-chunk-walk", None, SLOTS, False, 2, 32, False, "bf16", fused_decode=False,
             chunk=CHUNK, prompt_lens=(PROMPT, PROMPT - 3), prefill_twin="bf16-chunk"),
    PathSpec("int8-chunk", "int8", SLOTS, False, 1, 16, False, "int8", chunk=CHUNK),
    PathSpec("int4-chunk-prefetch", "int4", SLOTS, True, 1, 16, False, "int4", chunk=CHUNK),
    PathSpec("full-sample", None, 0, False, 2, NEW, False, None, sample=SAMPLE,
             same_prompt=True),
    PathSpec("full-sample-spec4", None, 0, False, 1, NEW, False, "full-sample", spec_k=4,
             sample=SAMPLE),
    PathSpec("bf16-sample-spec4", None, SLOTS, False, 1, 32, False, None, spec_k=4,
             sample=SAMPLE),
)
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)
QUANT_TOL = dict(atol=1e-4, rtol=1e-4)
GROUP = 64
ERR_RATIO, RMS_SLACK, MAX_SLACK = 1.5, 0.01, 0.05
REPLACES = {
    "slot_gmm": "src/repro/kernels/moe_gmm.py:111",
    "slot_gmm_tiled": "src/repro/kernels/moe_gmm.py:111",
    "slot_gmm_int8": "src/repro/kernels/moe_gmm.py:59",
    "slot_gmm_int8_tiled": "src/repro/kernels/moe_gmm.py:59",
    "slot_gmm_int4": "src/repro/kernels/moe_gmm.py:78",
    "slot_gmm_int4_tiled": "src/repro/kernels/moe_gmm.py:78",
    "decode_attention": "src/repro/kernels/decode_attention.py:70",
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:70",
    "decode_attention_partial": "src/repro/kernels/decode_attention.py:70",
    "topk_gate": "src/repro/kernels/topk_gate.py:81",
    "router_topk": "src/repro/kernels/topk_gate.py:81",
    "flash_attention": "src/repro/kernels/flash_attention.py:88",
    "flash_attention_chunk": "src/repro/kernels/flash_attention.py:88",
    "flash_attention_chunk_partial": "src/repro/kernels/flash_attention.py:88",
    "slot_gmm_ragged": "src/repro/kernels/moe_gmm.py:111",
    "slot_gmm_int8_ragged": "src/repro/kernels/moe_gmm.py:59",
    "slot_gmm_int4_ragged": "src/repro/kernels/moe_gmm.py:78",
}
SOURCE = {
    "slot_gmm": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "slot_gmm_tiled": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "slot_gmm_int8": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "slot_gmm_int8_tiled": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "slot_gmm_int4": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "slot_gmm_int4_tiled": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "decode_attention_paged": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "decode_attention_partial": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "topk_gate": "src/repro_torch/kernels/csrc/topk_gate.cu",
    "router_topk": "src/repro_torch/kernels/csrc/topk_gate.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_chunk": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_chunk_partial": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "slot_gmm_ragged": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "slot_gmm_int8_ragged": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "slot_gmm_int4_ragged": "src/repro_torch/kernels/csrc/moe_gmm.cu",
}
ENTRY = {"topk_gate": ("topk_gate", "topk_gate_"), "router_topk": ("topk_gate", "router_topk_"),
         "decode_attention": ("decode_attention", ("decode_attention_bf16",
                                                   "decode_attention_f32")),
         "decode_attention_paged": ("decode_attention", "decode_attention_paged_"),
         "decode_attention_partial": ("decode_attention", "decode_attention_partial_"),
         "flash_attention_chunk": ("flash_attention_chunk", ("flash_attention_chunk_bf16",
                                                             "flash_attention_chunk_f32")),
         "flash_attention_chunk_partial": ("flash_attention_chunk",
                                           "flash_attention_chunk_partial_"),
         **{f"slot_gmm{q}_{e}": (f"slot_gmm{q}_tiled", f"slot_gmm{q}_{e}_")
            for q in ("", "_int8", "_int4") for e in ("tiled", "ragged")}}
# device ms of the bodies that the tensor-core redesigns replaced, at the same
# phase-3 shapes (this script on an H100 80GB HBM3 at 700 W): K4's partial
# chunk entry on CUDA cores (f32 tiles), K2's bf16 CUDA-core body at dh 96 / 160
EARLIER_DEVICE_MS = {"flash_attention_chunk_partial": 0.1723,
                     "decode_attention_dh96_g1": 0.0380, "decode_attention_paged_dh96_g1": 0.0432,
                     "decode_attention_dh160_g4": 0.0439,
                     "decode_attention_paged_dh160_g4": 0.0456}
ROUTE_MARGIN = 1e-6                # probability gap that a summation order cannot close
ROUTE_TOL = dict(atol=1e-5, rtol=1e-5)


def expert_bytes(cfg, quantization: str) -> int:
    """One packed expert of ``cfg`` on the link (scale and min planes
    included): what every upload of a ``quantization`` slot ships."""
    from repro_torch.core.slots import quantized_expert_bytes

    d, f = cfg.d_model, cfg.moe.expert_d_ff
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return quantized_expert_bytes(shapes, quantization, 2, GROUP)


def entry_launches(symbols: dict, name: str) -> int:
    """Launches of the entry ``name`` (a key of ``ENTRY``) in ``symbols``
    (kernel -> launcher symbol -> launches)."""
    counter, prefix = ENTRY[name]
    return sum(n for sym, n in symbols.get(counter, {}).items() if sym.startswith(prefix))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50) -> float:
    """Wall ms per call of ``fn`` issued back to back from Python between CUDA
    events after warm-up: the device time, or the host's cost of a call where
    that is larger."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


_SIDE = []                         # the one side stream every graph warms up and captures on


def device_ms(fn, iters: int = 50) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph (after
    a warm-up on a side stream) and the graph replayed between CUDA events,
    so the host's cost of a call (the Python wrapper, the launch) is left
    out. One side stream serves every capture: cuBLAS keeps a workspace per
    stream it runs on, which would otherwise pile up and show in the paths'
    peak memory."""
    import torch

    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / iters


def timed(iters: int = 50, host_sync=(), **fns) -> dict:
    """``{name}_ms`` (wall per call) and ``{name}_device_ms`` for each of
    ``fns``; the kernel's own entry is named ``kernel`` and gives ``ms`` and
    ``device_ms``. Names in ``host_sync`` read a count on the host (a CUDA
    graph cannot capture them): their device_ms is None."""
    out = {}
    for name, fn in fns.items():
        key = "" if name == "kernel" else f"{name}_"
        out[f"{key}ms"] = time_ms(fn, iters)
        out[f"{key}device_ms"] = None if name in host_sync else device_ms(fn, iters)
    return out


def fmt_ms(t) -> str:
    return "n/a (syncs with the host)" if t is None else f"{t:.4f}"


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check_close(name, got, want, **tol) -> float:
    import torch

    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{name}: {m}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions at the main path's shapes
# ---------------------------------------------------------------------------
def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_gate as tk

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # --- K1 slot_gmm: decode (8 picks, C=1) and a prefill grouping at T=512 --
    d, f, s1 = 2048, 768, SLOTS + 1
    w_up = randn(s1, d, f, scale=d ** -0.5)
    w_down = randn(s1, f, d, scale=f ** -0.5)
    w_up[SLOTS] = 0
    w_down[SLOTS] = 0
    err = 0.0
    luts = [torch.randperm(SLOTS, generator=g, device=dev)[:8].to(torch.int32)
            for _ in range(16)]
    luts[0][3] = SLOTS                                         # one pick reads MISS
    x_dec = randn(8, 1, d)
    h_dec = randn(8, 1, f)
    for lut in luts[:4]:
        err = max(err, check_close("slot_gmm decode up", gmm.slot_gmm(x_dec, w_up, lut),
                                   ref.slot_gmm_ref(x_dec, w_up, lut), **KERNEL_TOL))
        err = max(err, check_close("slot_gmm decode down", gmm.slot_gmm(h_dec, w_down, lut),
                                   ref.slot_gmm_ref(h_dec, w_down, lut), **KERNEL_TOL))
    ids = torch.randint(0, 128, (PROMPT * 8,), generator=g, device=dev)
    slot_of = torch.randperm(128, generator=g, device=dev)      # 96 resident experts
    slot_of = torch.where(slot_of < SLOTS, slot_of, torch.full_like(slot_of, SLOTS))
    picks = slot_of[ids]
    counts = torch.bincount(picks[picks < SLOTS], minlength=SLOTS).cpu()
    used = torch.nonzero(counts).flatten().to(dev, torch.int32)
    c_max = int(counts.max())
    x_pre = randn(used.numel(), c_max, d)
    h_pre = randn(used.numel(), c_max, f)
    err_pre = max(check_close("slot_gmm prefill up", gmm.slot_gmm(x_pre, w_up, used),
                              ref.slot_gmm_ref(x_pre, w_up, used), **KERNEL_TOL),
                  check_close("slot_gmm prefill down", gmm.slot_gmm(h_pre, w_down, used),
                              ref.slot_gmm_ref(h_pre, w_down, used), **KERNEL_TOL))
    cyc = iter(range(10 ** 9))

    def lut_next():
        return luts[next(cyc) % len(luts)]        # cycle slot sets: weights come cold from HBM

    distinct = sum(int(torch.unique(l[l < SLOTS]).numel()) for l in luts) / len(luts)
    nbytes = distinct * d * f * 2 + 8 * d * 2 + 8 * f * 2 + 8 * 4
    b_ms, b_by = bound(nbytes, 2 * 8 * d * f)
    rows["slot_gmm"] = dict(
        max_abs_err=err,
        **timed(kernel=lambda: gmm.slot_gmm(x_dec, w_up, lut_next()),
                plain=lambda: ref.slot_gmm_ref(x_dec, w_up, lut_next()),
                library=lambda: torch.bmm(x_dec, w_up.index_select(0, lut_next().long()))),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=2 * 8 * d * f,
        shape=f"x [8,1,{d}] @ w [{s1},{d},{f}] bf16 through an 8-entry LUT (decode gate/up)",
        down=gemv_down(lambda: gmm.slot_gmm(h_dec, w_down, lut_next()),
                       distinct * d * f * 2 + 8 * f * 2 + 8 * d * 2 + 8 * 4, d, f,
                       f"x [8,1,{f}] @ w [{s1},{f},{d}] bf16 (decode down)"),
    )
    rows_used = int(counts.sum())                  # the picks' rows; padding is not work
    pre_bytes = used.numel() * d * f * 2 + rows_used * (d + f) * 2
    b_ms, b_by = bound(pre_bytes, 2 * rows_used * d * f)
    rows["slot_gmm_tiled"] = dict(
        max_abs_err=err_pre,
        **timed(20, kernel=lambda: gmm.slot_gmm(x_pre, w_up, used),
                plain=lambda: ref.slot_gmm_ref(x_pre, w_up, used),
                library=lambda: torch.bmm(x_pre, w_up.index_select(0, used.long()))),
        bound_ms=b_ms, bound_by=b_by, nbytes=pre_bytes, flops=2 * rows_used * d * f,
        shape=f"x [{used.numel()},{c_max},{d}] @ w [{s1},{d},{f}] bf16, the picks of {PROMPT} "
              f"tokens grouped by slot ({rows_used} rows; prefill gate/up)",
    )

    # --- K1 int8 / int4 bodies: the same stores quantized as the manager does -
    for kind in ("int8", "int4"):
        rows.update(quant_rows(kind, dict(up=w_up, down=w_down), luts, lut_next, distinct,
                               (x_dec, h_dec), (x_pre, h_pre), used, rows_used))

    # --- K2 decode_attention: B=1, H=32, Hkv=4, dh=128, S=1024 ----------------
    h, hkv, dh, s = 32, 4, 128, CACHE
    caches = [(randn(1, s, hkv, dh), randn(1, s, hkv, dh)) for _ in range(LAYERS)]
    q = randn(1, h, dh)
    err = 0.0
    for length in (1, 100, 576, 1024):
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        k, v = caches[length % LAYERS]
        for cap in (None, 30.0):
            err = max(err, check_close(
                f"decode_attention len={length}", dec.decode_attention(q, k, v, lens, soft_cap=cap),
                ref.decode_attention_ref(q, k, v, lens, soft_cap=cap), **KERNEL_TOL))
    length = PROMPT + NEW                                       # the last decode step's work
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    lay = iter(range(10 ** 9))

    def kv():
        return caches[next(lay) % LAYERS]

    def sdpa():
        k, v = kv()
        return F.scaled_dot_product_attention(
            q[:, :, None], k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2),
            enable_gqa=True)

    nbytes = 2 * length * hkv * dh * 2 + 2 * h * dh * 2 + 4
    b_ms, b_by = bound(nbytes, 4 * length * h * dh)
    rows["decode_attention"] = dict(
        max_abs_err=err,
        **timed(kernel=lambda: dec.decode_attention(q, *kv(), lens),
                plain=lambda: ref.decode_attention_ref(q, *kv(), lens), library=sdpa),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=4 * length * h * dh,
        shape=f"q [1,{h},{dh}] vs cache [1,{s},{hkv},{dh}] bf16 at length {length}",
    )
    rows["decode_attention_paged"] = paged_row(dev, g)

    # --- K3 topk_gate: T in {1, 512}, E=128, k=8, forced ties -------------------
    err = 0.0
    for t in (1, PROMPT):
        lg = torch.randn((t, 128), generator=g, device=dev)
        lg[:, [5, 9, 70]] = 6.0
        got_ids, got_w = tk.topk_gate(lg, 8, normalize=True)
        want_ids, want_w = ref.topk_gate_ref(lg, 8, normalize=True)
        probs = torch.softmax(lg, -1).sort(dim=-1, descending=True).values
        distinct_rows = (probs[:, 7] - probs[:, 8]) > 0
        if not torch.equal(got_ids[distinct_rows], want_ids[distinct_rows]):
            raise AssertionError(f"topk_gate T={t}: ids differ from the plain version")
        if not (got_ids[:, :3] == torch.tensor([5, 9, 70], device=dev)).all():
            raise AssertionError(f"topk_gate T={t}: ties not broken lowest index first")
        err = max(err, check_close(f"topk_gate T={t}", got_w, want_w, atol=1e-6, rtol=1e-5))
    lg1 = torch.randn((1, 128), generator=g, device=dev)

    def lib_gate():
        w, i = torch.topk(torch.softmax(lg1, -1), 8)
        return i, w / w.sum(-1, keepdim=True)

    b_ms, b_by = bound(128 * 4 + 8 * 8, 128 * 4)
    rows["topk_gate"] = dict(
        max_abs_err=err,
        **timed(kernel=lambda: tk.topk_gate(lg1, 8), plain=lambda: ref.topk_gate_ref(lg1, 8),
                library=lib_gate),
        bound_ms=b_ms, bound_by=b_by, nbytes=128 * 4 + 8 * 8, flops=128 * 4,
        shape="logits [1,128] f32, k=8, renormalized (decode)",
    )

    rows["router_topk"] = router_rows(dev, g)

    # --- K4 flash_attention: B=1, S=512, H=32, Hkv=4, dh=128, causal -------
    qf, kf, vf = randn(1, PROMPT, h, dh), randn(1, PROMPT, hkv, dh), randn(1, PROMPT, hkv, dh)
    err = check_close("flash_attention", fa.flash_attention(qf, kf, vf),
                      ref.flash_attention_ref(qf, kf, vf), **KERNEL_TOL)
    pairs = PROMPT * (PROMPT + 1) // 2
    nbytes = (2 * PROMPT * h * dh + 2 * PROMPT * hkv * dh) * 2
    b_ms, b_by = bound(nbytes, 4 * pairs * h * dh)
    qt, kt, vt = qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2)
    rows["flash_attention"] = dict(
        max_abs_err=err,
        **timed(20, kernel=lambda: fa.flash_attention(qf, kf, vf),
                plain=lambda: ref.flash_attention_ref(qf, kf, vf),
                library=lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=4 * pairs * h * dh,
        shape=f"q [1,{PROMPT},{h},{dh}] k/v [1,{PROMPT},{hkv},{dh}] bf16, causal (prefill)",
    )
    rows["flash_attention_chunk"] = chunk_row(dev, g)
    rows.update(sharded_rows(dev, g))
    rows.update(ragged_rows(dev, g, dict(up=w_up, down=w_down), slot_of))
    del w_up, w_down, caches
    rows.update(dense_rows(dev, g))
    for name, r in rows.items():
        log(f"  {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3e}, per call (wall): "
            f"kernel_ms {r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, library_ms "
            f"{r['library_ms']:.4f}; device: kernel {r['device_ms']:.4f}, plain "
            f"{fmt_ms(r['plain_device_ms'])}, library {r['library_device_ms']:.4f}; bound_ms "
            f"{r['bound_ms']:.5f} ({r['bound_by']}); {rate(r)}")
        if name in EARLIER_DEVICE_MS:
            log(f"    {name}: device {r['device_ms']:.4f} ms, the body it replaced "
                f"{EARLIER_DEVICE_MS[name]:.4f} ms (CUDA cores; same shape and card model)")
        if "down" in r:
            dn = r["down"]
            log(f"    {name} at {dn['shape']}: kernel_ms {dn['ms']:.4f} per call (wall), "
                f"{dn['device_ms']:.4f} device; bound_ms {dn['bound_ms']:.5f} "
                f"({dn['bound_by']}); {rate(dn)}")
        if "prefill" in r:
            pf = r["prefill"]
            log(f"    {name} at {pf['shape']} (prefill): kernel_ms {pf['ms']:.4f} per call (wall), "
                f"{pf['device_ms']:.4f} device; plain {pf['plain_ms']:.4f} / "
                f"{pf['plain_device_ms']:.4f}; library {pf['library_ms']:.4f} / "
                f"{pf['library_device_ms']:.4f}; bound_ms {pf['bound_ms']:.5f} ({pf['bound_by']}); "
                f"{rate(pf)}")
        if "gather_k2_ms" in r:
            log(f"    {name}: gather + the contiguous entry {r['gather_k2_ms']:.4f} per call "
                f"(wall), {r['gather_k2_device_ms']:.4f} device; the contiguous entry alone on "
                f"the view gathered beforehand {r['contiguous_ms']:.4f} / "
                f"{r['contiguous_device_ms']:.4f}")
        for label, sub in (("decode", r), ("prefill", r.get("prefill"))):
            if sub and "three_call_ms" in sub:
                log(f"    {name} ({label}): the three calls it replaced (h2.float(), f32 GEMM, "
                    f"logits-in gate) {sub['three_call_ms']:.4f} per call (wall), "
                    f"{sub['three_call_device_ms']:.4f} device")
    return rows


PAGED_ROWS, PAGE = 4, 16
PAGED_LENS = (37, 300, 576, 1024)


def paged_row(dev, g):
    """Phase 3 for K2's paged entry at the serving shape: 4 rows of the
    1024-position logical cache in pages of 16 (64 pages a row, shuffled
    over shared planes whose spare pages hold garbage), lengths 37 / 300 /
    576 / 1024. Held to its plain version (with and without the soft-cap),
    bitwise to the contiguous entry on the gathered view, and batch
    invariant (row 0 alone against row 0 among 4, bitwise); timed beside
    the plain version, gather + SDPA with a length mask (``library``),
    gather + the contiguous entry, and the contiguous entry alone on a view
    gathered beforehand (what the page table's addressing costs); bound:
    the valid K/V read once, q and out, the table rows used."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    h, hkv, dh, b = 32, 4, 128, PAGED_ROWS
    n_pages = CACHE // PAGE
    planes = b * n_pages + 1 + 7                     # the scratch page and spares
    kp = torch.randn((planes, PAGE, hkv, dh), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((planes, PAGE, hkv, dh), generator=g, device=dev).to(torch.bfloat16)
    perm = torch.randperm(planes - 1, generator=g, device=dev)[:b * n_pages] + 1
    pt = perm.reshape(b, n_pages).to(torch.int32)
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(torch.bfloat16)

    def gather():
        return (kp[pt.long()].reshape(b, CACHE, hkv, dh), vp[pt.long()].reshape(b, CACHE, hkv, dh))

    err = 0.0
    for cap in (None, 30.0):
        got = dec.decode_attention_paged(q, kp, vp, pt, lens, soft_cap=cap)
        err = max(err, check_close(f"decode_attention_paged soft_cap={cap}", got,
                                   ref.decode_attention_paged_ref(q, kp, vp, pt, lens,
                                                                  soft_cap=cap), **KERNEL_TOL))
        if not torch.equal(got, dec.decode_attention(q, *gather(), lens, soft_cap=cap)):
            raise AssertionError("decode_attention_paged: not bitwise the contiguous entry on "
                                 "the gathered view")
    full = dec.decode_attention_paged(q, kp, vp, pt, lens)
    if not torch.equal(dec.decode_attention_paged(q[:1], kp, vp, pt[:1], lens[:1]), full[:1]):
        raise AssertionError("decode_attention_paged: row 0 alone differs from row 0 among 4")
    mask = (torch.arange(CACHE, device=dev)[None, :] < lens[:, None])[:, None, None, :]

    def sdpa():
        k, v = gather()
        return F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask, enable_gqa=True)

    kg, vg = gather()
    valid = sum(PAGED_LENS)
    nbytes = (2 * valid * hkv * dh * 2 + 2 * b * h * dh * 2
              + 4 * sum(-(-n // PAGE) for n in PAGED_LENS) + 4 * b)
    b_ms, b_by = bound(nbytes, 4 * valid * h * dh)
    return dict(
        max_abs_err=err,
        **timed(kernel=lambda: dec.decode_attention_paged(q, kp, vp, pt, lens),
                plain=lambda: ref.decode_attention_paged_ref(q, kp, vp, pt, lens),
                library=sdpa, gather_k2=lambda: dec.decode_attention(q, *gather(), lens),
                contiguous=lambda: dec.decode_attention(q, kg, vg, lens)),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=4 * valid * h * dh,
        shape=f"q [{b},{h},{dh}] vs planes [{planes},{PAGE},{hkv},{dh}] bf16 through a "
              f"shuffled page table [{b},{n_pages}], lengths {'/'.join(map(str, PAGED_LENS))}; "
              f"bitwise the contiguous entry on the gathered view, row 0 alone == row 0 among "
              f"{b}; library: gather + SDPA with a length mask")


def chunk_row(dev, g, h=32, hkv=4, dh=128):
    """Phase 3 for K4's chunk-append entry: C queries at positions cur_len ..
    against the 1024-slot cache (qwen36's heads: 32 q, 4 KV, dh 128, or the
    heads given), held against its plain version at C in {1, 4, 128} and
    cur_len in {0, 384}
    (slots past the live keys hold stale values), and timed at C = 128,
    cur_len = 384 (a 512-token prompt's last chunk) beside the plain
    version, one library call (SDPA over the live keys with an explicit
    causal-offset mask) and the bound: the live keys read once, q and out,
    4 H dh operations per (query, live key) pair."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    k, v = randn(1, CACHE, hkv, dh), randn(1, CACHE, hkv, dh)
    err = 0.0
    for c in (1, 4, 128):
        q = randn(1, c, h, dh)
        for cur in (0, 384):
            cl = torch.tensor(cur, device=dev)
            err = max(err, check_close(f"flash_attention_chunk C={c} cur_len={cur}",
                                       fa.flash_attention_chunk(q, k, v, cl),
                                       ref.flash_attention_chunk_ref(q, k, v, cl), **KERNEL_TOL))
    c, cur = 128, 384
    live = cur + c
    q = randn(1, c, h, dh)
    cl = torch.tensor(cur, device=dev)
    mask = (torch.arange(live, device=dev)[None, :]
            <= cur + torch.arange(c, device=dev)[:, None])              # [C, live]
    qt, kt, vt = q.transpose(1, 2), k[:, :live].transpose(1, 2), v[:, :live].transpose(1, 2)
    pairs = c * cur + c * (c + 1) // 2
    nbytes = (2 * c * h * dh + 2 * live * hkv * dh) * 2
    b_ms, b_by = bound(nbytes, 4 * pairs * h * dh)
    return dict(
        max_abs_err=err,
        **timed(kernel=lambda: fa.flash_attention_chunk(q, k, v, cl),
                plain=lambda: ref.flash_attention_chunk_ref(q, k, v, cl),
                library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                               enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=4 * pairs * h * dh,
        shape=f"q [1,{c},{h},{dh}] at cur_len {cur} vs cache [1,{CACHE},{hkv},{dh}] bf16 "
              f"(the last 128-token chunk of a 512-token prompt); library: SDPA over the "
              f"{live} live keys with an explicit causal-offset mask")


# K4 and K2 at the dense families' shapes: (row, base kernel, dh, H, Hkv);
# each row's ``width_paths`` are the paths that run that width and no other
K4_WIDTHS = (("flash_attention_dh64", 64, 32, 32, ("musicgen-frontend",)),
             ("flash_attention_dh96", 96, 32, 32, ("serve-phi3-mini",)),
             ("flash_attention_dh160", 160, 32, 8, ("pixtral-frontend",)),
             ("flash_attention_dh256", 256, 10, 1, ("serve-recurrentgemma-2b",)))
# recurrentgemma's local attention: K4 at its window over a prompt longer than
# the window (KV tiles behind the band skipped), K2 over a full ring cache
RG_WINDOW, RG_LONG, RG_CACHE = 2048, 3072, 4096
K2_WIDTHS = (("dh96_g1", 96, 32, 32, ("serve-phi3-mini",)),
             ("dh160_g4", 160, 32, 8, ("pixtral-frontend",)),
             ("dh128_g9", 128, 36, 4, ("serve-starcoder2-7b",)),
             ("dh128_g12", 128, 24, 2, ()))


def k4_row(dev, g, dh, h, hkv, s=PROMPT, window=None):
    """K4's causal entry at ``s`` queries of ``h`` heads on ``hkv`` KV heads
    of width ``dh`` in bf16 (``window``: a sliding window): held to its
    plain version, row-invariant (the first 64 queries alone equal their
    tile among all ``s``), timed beside the plain version and SDPA (with an
    explicit band mask under a window); bound: q/k/v/out once, 4 dh H
    operations a causal (query, key) pair inside the band."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = randn(1, s, h, dh), randn(1, s, hkv, dh), randn(1, s, hkv, dh)
    out = fa.flash_attention(q, k, v, window=window)
    err = check_close(f"flash_attention dh {dh} {h}/{hkv} window {window}", out,
                      ref.flash_attention_ref(q, k, v, window=window), **KERNEL_TOL)
    if not torch.equal(fa.flash_attention(q[:, :64].contiguous(), k[:, :64].contiguous(),
                                          v[:, :64].contiguous(), window=window), out[:, :64]):
        raise AssertionError(f"flash_attention dh {dh}: the first tile alone differs")
    pos = torch.arange(s, device=dev)
    pairs = int(torch.clamp(pos + 1, max=window).sum()) if window else s * (s + 1) // 2
    nbytes = (2 * s * h * dh + 2 * s * hkv * dh) * 2
    b_ms, b_by = bound(nbytes, 4 * pairs * h * dh)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window:
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)
    else:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    return dict(
        max_abs_err=err,
        **timed(20, kernel=lambda: fa.flash_attention(q, k, v, window=window),
                plain=lambda: ref.flash_attention_ref(q, k, v, window=window),
                library=library),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=4 * pairs * h * dh,
        shape=f"q [1,{s},{h},{dh}] k/v [1,{s},{hkv},{dh}] bf16, causal (prefill)"
              + (f", window {window} ({pairs} band pairs); library: SDPA with an explicit "
                 f"band mask" if window else ""))


def k2_ring_row(dev, g, dh=256, h=10, hkv=1, cap=RG_WINDOW):
    """K2's contiguous entry over recurrentgemma's ring cache (4 rows of
    ``cap`` slots, two full, the rest partly filled) at dh 256 and g 10 (two
    n8 fragments of query heads, the second partly empty): held to its
    plain version, row 0 alone bitwise itself among 4, timed beside the
    plain version and SDPA (GQA, length mask); bound: the valid K/V once,
    q and out."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    b, bf = PAGED_ROWS, torch.bfloat16
    lens_h = (cap, cap, cap // 2, 300)
    kc = torch.randn((b, cap, hkv, dh), generator=g, device=dev).to(bf)
    vc = torch.randn((b, cap, hkv, dh), generator=g, device=dev).to(bf)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(bf)
    lens = torch.tensor(lens_h, dtype=torch.int32, device=dev)
    err = check_close(f"decode_attention dh {dh} g {h // hkv}", dec.decode_attention(q, kc, vc, lens),
                      ref.decode_attention_ref(q, kc, vc, lens), **KERNEL_TOL)
    if not torch.equal(dec.decode_attention(q[:1], kc[:1], vc[:1], lens[:1]),
                       dec.decode_attention(q, kc, vc, lens)[:1]):
        raise AssertionError(f"decode_attention dh {dh} g {h // hkv}: row 0 alone differs")
    mask = (torch.arange(cap, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    valid = sum(lens_h)
    nbytes = 2 * valid * hkv * dh * 2 + 2 * b * h * dh * 2 + 4 * b
    flops = 4 * valid * h * dh
    b_ms, b_by = bound(nbytes, flops)
    plan = dec.decode_plan(cap, dh, h // hkv, bf)
    return dict(
        max_abs_err=err,
        **timed(kernel=lambda: dec.decode_attention(q, kc, vc, lens),
                plain=lambda: ref.decode_attention_ref(q, kc, vc, lens),
                library=lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
                    enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops,
        shape=f"q [{b},{h},{dh}] vs ring cache [{b},{cap},{hkv},{dh}] bf16 (g {h // hkv}), "
              f"lengths {'/'.join(map(str, lens_h))}; the "
              f"{'tensor cores' if plan.tensor_cores else 'CUDA cores'} body (tile {plan.tile}, "
              f"{plan.splits} spans); library: SDPA (GQA), length mask")


def k2_rows(dev, g, dh, h, hkv):
    """K2's contiguous and paged entries at the serving shape (4 rows,
    lengths 37 / 300 / 576 / 1024 of a 1024-position cache, pages of 16
    shuffled over shared planes) with ``h`` heads on ``hkv`` KV heads of
    width ``dh`` in bf16: each held to its plain version (with and without
    the soft cap), the paged entry bitwise the contiguous one on the
    gathered view, row 0 alone bitwise itself among 4; timed beside the
    plain versions and SDPA with a length mask (gathered first for the
    paged entry); bound: the valid K/V once, q and out (and the table rows
    used)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    b, n_pages = PAGED_ROWS, CACHE // PAGE
    planes = b * n_pages + 1 + 7
    bf = torch.bfloat16
    kp = torch.randn((planes, PAGE, hkv, dh), generator=g, device=dev).to(bf)
    vp = torch.randn((planes, PAGE, hkv, dh), generator=g, device=dev).to(bf)
    pt = (torch.randperm(planes - 1, generator=g, device=dev)[:b * n_pages] + 1)
    pt = pt.reshape(b, n_pages).to(torch.int32)
    kc = kp[pt.long()].reshape(b, CACHE, hkv, dh)
    vc = vp[pt.long()].reshape(b, CACHE, hkv, dh)
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(bf)
    err_c = err_p = 0.0
    for cap in (None, 30.0):
        got_c = dec.decode_attention(q, kc, vc, lens, soft_cap=cap)
        got_p = dec.decode_attention_paged(q, kp, vp, pt, lens, soft_cap=cap)
        err_c = max(err_c, check_close(f"decode_attention dh {dh} g {h // hkv}", got_c,
                                       ref.decode_attention_ref(q, kc, vc, lens, soft_cap=cap),
                                       **KERNEL_TOL))
        err_p = max(err_p, check_close(f"decode_attention_paged dh {dh} g {h // hkv}", got_p,
                                       ref.decode_attention_paged_ref(q, kp, vp, pt, lens,
                                                                      soft_cap=cap),
                                       **KERNEL_TOL))
        if not torch.equal(got_p, got_c):
            raise AssertionError(f"decode_attention_paged dh {dh}: not bitwise the contiguous "
                                 f"entry on the gathered view")
    if not torch.equal(dec.decode_attention(q[:1], kc[:1], vc[:1], lens[:1]),
                       dec.decode_attention(q, kc, vc, lens)[:1]):
        raise AssertionError(f"decode_attention dh {dh}: row 0 alone differs from row 0 among 4")
    mask = (torch.arange(CACHE, device=dev)[None, :] < lens[:, None])[:, None, None, :]

    def sdpa(k, v):
        return F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                              attn_mask=mask, enable_gqa=True)

    def gathered_sdpa():
        return sdpa(kp[pt.long()].reshape(b, CACHE, hkv, dh),
                    vp[pt.long()].reshape(b, CACHE, hkv, dh))

    valid = sum(PAGED_LENS)
    nbytes = 2 * valid * hkv * dh * 2 + 2 * b * h * dh * 2 + 4 * b
    paged_bytes = nbytes + 4 * sum(-(-n // PAGE) for n in PAGED_LENS)
    flops = 4 * valid * h * dh
    plan = dec.decode_plan(CACHE, dh, h // hkv, bf)
    body = "tensor cores" if plan.tensor_cores else "CUDA cores"
    shape = (f"q [{b},{h},{dh}] vs {{}} bf16 (g {h // hkv}), lengths "
             f"{'/'.join(map(str, PAGED_LENS))}; the {body} body (tile {plan.tile}, "
             f"{plan.splits} spans)")
    out = {}
    b_ms, b_by = bound(nbytes, flops)
    out["decode_attention"] = dict(
        max_abs_err=err_c,
        **timed(kernel=lambda: dec.decode_attention(q, kc, vc, lens),
                plain=lambda: ref.decode_attention_ref(q, kc, vc, lens),
                library=lambda: sdpa(kc, vc)),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops,
        shape=shape.format(f"cache [{b},{CACHE},{hkv},{dh}]") + "; library: SDPA, length mask")
    b_ms, b_by = bound(paged_bytes, flops)
    out["decode_attention_paged"] = dict(
        max_abs_err=err_p,
        **timed(kernel=lambda: dec.decode_attention_paged(q, kp, vp, pt, lens),
                plain=lambda: ref.decode_attention_paged_ref(q, kp, vp, pt, lens),
                library=gathered_sdpa),
        bound_ms=b_ms, bound_by=b_by, nbytes=paged_bytes, flops=flops,
        shape=shape.format(f"planes [{planes},{PAGE},{hkv},{dh}] through a shuffled page table "
                           f"[{b},{n_pages}]") + "; bitwise the contiguous entry on the gathered "
                                                 "view; library: gather + SDPA, length mask")
    return out


# the sharded paths' shapes: (row, the paths that run it)
SHARDED_ROWS = {"slot_gmm_tiled_epsum": ("ep-qwen36",),
                "flash_attention_chunk_sp": ("sp-recurrentgemma-2b",),
                "decode_attention_partial": ("tp-qwen3-4b",),
                "flash_attention_chunk_partial": ("mp-rotary-qwen36",)}
TP_SLICE = CACHE // 2                           # a rank's positions on tp-qwen3-4b (model 2)
PARTIAL_LENS = (0, 1, 300, TP_SLICE)            # checked: an empty slice, one position, ...
EP_EXPERTS, EP_TOKENS = 64, 2 * PROMPT          # a rank's experts and tokens on ep-qwen36
SP_RANKS = 4


def sharded_rows(dev, g):
    """Phase 3 at the sharded paths' shapes. K1's tiled grouped entry as
    ``moe_epsum_local`` calls it on ``ep-qwen36``: a rank's 64 of 128
    experts over its data rank's 2 x 512 tokens, x [64, C, 2048] @ W [64,
    2048, 768] bf16, LUT the identity, C the reference's capacity
    ``max(k, ceil(T k / E x 1.25))`` = 80 (bound: W, x and out once, 2 C D F
    operations a group: the entry computes every row of the buffer; library:
    ``bmm`` over the gathered experts). K4's chunk entry as
    ``_sp_attention`` calls it on ``sp-recurrentgemma-2b``: 768 queries of
    10 heads (dh 256) at offsets 0 and 2,304 against the full 3,072 keys
    of 1 KV head, window 2,048, held to its plain version at both offsets
    and timed at 2,304 (bound: q, out and the keys inside some query's
    band once, 4 H dh operations a (query, key) pair in the band; library:
    SDPA over those keys with an explicit band mask)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    from repro_torch.models.moe import capacity

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    rows = {}
    mcfg = get_config("qwen36-35b-a3b").moe
    d, f, e = 2048, mcfg.expert_d_ff, EP_EXPERTS
    cap = capacity(mcfg, EP_TOKENS)
    w = randn(e, d, f, scale=d ** -0.5)
    x = randn(e, cap, d)
    lut = torch.arange(e, dtype=torch.int32, device=dev)
    err = check_close("slot_gmm tiled grouped (epsum)", gmm.slot_gmm(x, w, lut),
                      ref.slot_gmm_ref(x, w, lut), **KERNEL_TOL)
    nbytes = (e * d * f + e * cap * (d + f)) * 2
    b_ms, b_by = bound(nbytes, 2 * e * cap * d * f)
    rows["slot_gmm_tiled_epsum"] = dict(
        max_abs_err=err, base="slot_gmm_tiled",
        **timed(20, kernel=lambda: gmm.slot_gmm(x, w, lut),
                plain=lambda: ref.slot_gmm_ref(x, w, lut),
                library=lambda: torch.bmm(x, w.index_select(0, lut.long()))),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=2 * e * cap * d * f,
        shape=f"x [{e},{cap},{d}] @ w [{e},{d},{f}] bf16, LUT the identity (moe_epsum_local: a "
              f"rank's {e} experts at capacity {cap} over {EP_TOKENS} tokens)")
    del w, x
    h, hkv, dh, s = 10, 1, 256, RG_LONG
    c = s // SP_RANKS
    k, v = randn(1, s, hkv, dh), randn(1, s, hkv, dh)
    q = randn(1, c, h, dh)
    err = 0.0
    for cur in (0, s - c):
        cl = torch.tensor(cur, device=dev)
        err = max(err, check_close(f"flash_attention_chunk SP offset {cur}",
                                   fa.flash_attention_chunk(q, k, v, cl, window=RG_WINDOW),
                                   ref.flash_attention_chunk_ref(q, k, v, cl, window=RG_WINDOW),
                                   **KERNEL_TOL))
    cur = s - c
    cl = torch.tensor(cur, device=dev)
    qpos = cur + torch.arange(c, device=dev)
    lo = max(0, cur - RG_WINDOW + 1)
    kpos = torch.arange(lo, s, device=dev)
    band = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - RG_WINDOW)
    pairs = int(band.sum())
    nbytes = (2 * c * h * dh + 2 * (s - lo) * hkv * dh) * 2
    b_ms, b_by = bound(nbytes, 4 * pairs * h * dh)
    qt, kt, vt = q.transpose(1, 2), k[:, lo:].transpose(1, 2), v[:, lo:].transpose(1, 2)
    rows["flash_attention_chunk_sp"] = dict(
        max_abs_err=err, base="flash_attention_chunk",
        **timed(20, kernel=lambda: fa.flash_attention_chunk(q, k, v, cl, window=RG_WINDOW),
                plain=lambda: ref.flash_attention_chunk_ref(q, k, v, cl, window=RG_WINDOW),
                library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                               enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=4 * pairs * h * dh,
        shape=f"q [1,{c},{h},{dh}] at offsets 0 and {cur} vs k/v [1,{s},{hkv},{dh}] bf16, window "
              f"{RG_WINDOW} (_sp_attention's last rank of {SP_RANKS}: {pairs} band pairs); "
              f"library: SDPA over the {s - lo} keys in some query's band, explicit band mask")
    rows["decode_attention_partial"] = partial_row(dev, g)
    rows["flash_attention_chunk_partial"] = chunk_partial_row(dev, g)
    return rows


def partial_row(dev, g, h=32, hkv=8, dh=128):
    """K2's partial entry at ``tp-qwen3-4b``'s slice: every query head of
    qwen3-4b (32 on 8 KV heads, dh 128) against a rank's 512 of 1,024
    positions, bf16. Held to its plain version (context and lse, with and
    without a soft cap) at local lengths 0 / 1 / 300 / 512 (an empty slice:
    lse -inf, context 0, no NaN), and the merge of two slices to the
    contiguous entry over the whole cache; timed at the path's shape, its 2
    rows at 512 / 512 (rank 0's full slice through decode). Bound: the
    valid K/V, q and the f32 rows out once; library: the aten flash SDPA that
    returns the lse (``_scaled_dot_product_flash_attention``) over the same
    slice with K/V expanded for GQA."""
    import torch

    from repro_torch.distributed.parallel import merge_partials
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    bf = torch.bfloat16
    b = len(PARTIAL_LENS)
    k = torch.randn((b, TP_SLICE, hkv, dh), generator=g, device=dev).to(bf)
    v = torch.randn((b, TP_SLICE, hkv, dh), generator=g, device=dev).to(bf)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(bf)
    lens = torch.tensor(PARTIAL_LENS, dtype=torch.int32, device=dev)
    err = 0.0
    for cap in (None, 30.0):
        got = dec.decode_attention_partial(q, k, v, lens, soft_cap=cap)
        want = ref.decode_attention_partial_ref(q, k, v, lens, soft_cap=cap)
        if torch.isnan(got).any() or not torch.isinf(got[0, :, -1]).all() or got[0, :, :-1].any():
            raise AssertionError("decode_attention_partial: an empty slice must give lse -inf, "
                                 "context 0 and no NaN")
        err = max(err, check_close("decode_attention_partial context", got[1:, :, :-1],
                                   want[1:, :, :-1], **KERNEL_TOL),
                  check_close("decode_attention_partial lse", got[1:, :, -1], want[1:, :, -1],
                              **KERNEL_TOL))
    k2, v2 = torch.randn_like(k.float()).to(bf), torch.randn_like(v.float()).to(bf)
    whole = torch.tensor([1, TP_SLICE, TP_SLICE + 1, 2 * TP_SLICE], dtype=torch.int32, device=dev)
    parts = torch.stack([dec.decode_attention_partial(q, kk, vv, torch.clamp(
        whole - r * TP_SLICE, 0, TP_SLICE).to(torch.int32)) for r, (kk, vv) in
        enumerate(((k, v), (k2, v2)))])
    err = max(err, check_close("decode_attention_partial merged", merge_partials(parts, bf),
                               dec.decode_attention(q, torch.cat([k, k2], 1),
                                                    torch.cat([v, v2], 1), whole), **KERNEL_TOL))
    tq, tk, tv, tl = q[:2], k[:2], v[:2], torch.full((2,), TP_SLICE, dtype=torch.int32,
                                                       device=dev)
    qe = tq[:, :, None]                                            # [2, H, 1, dh]
    ke = tk.transpose(1, 2).repeat_interleave(h // hkv, dim=1)     # [2, H, S, dh]
    ve = tv.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    nbytes = 2 * 2 * TP_SLICE * hkv * dh * 2 + 2 * h * dh * 2 + 2 * h * (dh + 1) * 4
    flops = 4 * 2 * TP_SLICE * h * dh
    b_ms, b_by = bound(nbytes, flops)
    plan = dec.decode_plan(TP_SLICE, dh, h // hkv, bf)
    return dict(
        max_abs_err=err, base="decode_attention_partial",
        **timed(kernel=lambda: dec.decode_attention_partial(tq, tk, tv, tl),
                plain=lambda: ref.decode_attention_partial_ref(tq, tk, tv, tl),
                library=lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    qe, ke, ve, return_debug_mask=False)[:2]),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops,
        shape=f"q [2,{h},{dh}] vs a slice [2,{TP_SLICE},{hkv},{dh}] bf16 (tp-qwen3-4b: a rank's "
              f"{TP_SLICE} of {CACHE} positions), timed at local lengths {TP_SLICE}/{TP_SLICE}, "
              f"checked at {'/'.join(map(str, PARTIAL_LENS))} and merged over two slices; f32 "
              f"rows [.., {dh + 1}] out; the tensor-core body (tile {plan.tile}, {plan.splits} "
              f"spans); library: aten flash SDPA with lse, K/V expanded for GQA")


# mp-rotary-qwen36: a rank's slice of the 1,152-position cache (model 2), and the
# chunk of a 640-token prompt that straddles the slices' edge (positions 512-639)
ROT_CACHE, ROT_CUR = 1152, 512
ROT_SLICE = ROT_CACHE // 2


def chunk_partial_row(dev, g, h=32, hkv=4, dh=128):
    """K4's partial chunk entry at ``mp-rotary-qwen36``'s shape: a 128-token
    chunk of qwen36's heads (32 on 4 KV heads, dh 128) at positions 512-639
    against a rank's 576 of 1,152 cache positions, bf16. Held to its plain
    version (context and lse, with and without a soft cap) as rank 0 (offset
    0: every query sees the whole slice up to its position), rank 1 (offset
    576: the first 64 queries see nothing, lse -inf, context 0, no NaN) and
    a chunk at 0 against rank 1's slice (nothing visible); the two slices'
    rows merged (``merge_partials``) against K4's chunk entry over the whole
    cache. Timed as rank 0 calls it (its 64 x 576 + 64 x 576 visible pairs,
    clipped by causality). Bound: q, the slice's visible K/V and the f32
    rows out once, 4 H dh operations a visible (query, key) pair; library:
    the aten memory-efficient SDPA that returns the lse
    (``_scaled_dot_product_efficient_attention``) over the same slice with
    an explicit causal-offset bias, K/V expanded for GQA. bf16 runs the
    chunk entry's tensor-core body with the partial epilogue."""
    import torch

    from repro_torch.distributed.parallel import merge_partials
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    c = CHUNK
    kv = [(randn(1, ROT_SLICE, hkv, dh), randn(1, ROT_SLICE, hkv, dh)) for _ in range(2)]
    q = randn(1, c, h, dh)
    cl = torch.tensor(ROT_CUR, device=dev)
    err = 0.0
    for cap in (None, 30.0):
        for cur, r in ((ROT_CUR, 0), (ROT_CUR, 1), (0, 1)):
            off = r * ROT_SLICE
            cur_t = torch.tensor(cur, device=dev)
            got = fa.flash_attention_chunk_partial(q, *kv[r], cur_t, off, soft_cap=cap)
            want = ref.flash_attention_chunk_partial_ref(q, *kv[r], cur_t, off, soft_cap=cap)
            empty = torch.isinf(want[..., -1])
            if (torch.isnan(got).any() or not torch.equal(torch.isinf(got[..., -1]), empty)
                    or got[empty][:, :-1].any()):
                raise AssertionError("flash_attention_chunk_partial: a query that sees no key "
                                     "must give lse -inf, context 0 and no NaN")
            seen = ~empty
            if not seen.any():
                continue
            err = max(err, check_close(f"flash_attention_chunk_partial context cur {cur} rank {r}",
                                       got[seen][:, :-1], want[seen][:, :-1], **KERNEL_TOL),
                      check_close(f"flash_attention_chunk_partial lse cur {cur} rank {r}",
                                  got[seen][:, -1], want[seen][:, -1], **KERNEL_TOL))
    parts = torch.stack([fa.flash_attention_chunk_partial(q, *kv[r], cl, r * ROT_SLICE)
                         for r in range(2)])
    whole_k = torch.cat([kv[0][0], kv[1][0]], 1)
    whole_v = torch.cat([kv[0][1], kv[1][1]], 1)
    err = max(err, check_close("flash_attention_chunk_partial merged", merge_partials(parts, bf),
                               fa.flash_attention_chunk(q, whole_k, whole_v, cl), **KERNEL_TOL))
    k0, v0 = kv[0]
    qpos = ROT_CUR + torch.arange(c, device=dev)
    visible = torch.arange(ROT_SLICE, device=dev)[None, :] <= qpos[:, None]      # [C, S_loc]
    pairs = int(visible.sum())
    bias = torch.zeros((1, h, c, ROT_SLICE), dtype=bf, device=dev).masked_fill(
        ~visible, float("-inf"))
    qe = q.transpose(1, 2)                                              # [1, H, C, dh]
    ke = k0.transpose(1, 2).repeat_interleave(h // hkv, dim=1)          # [1, H, S, dh]
    ve = v0.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    nbytes = 2 * c * h * dh + 2 * 2 * ROT_SLICE * hkv * dh + 4 * c * h * (dh + 1)
    b_ms, b_by = bound(nbytes, 4 * pairs * h * dh)
    return dict(
        max_abs_err=err, base="flash_attention_chunk_partial",
        **timed(kernel=lambda: fa.flash_attention_chunk_partial(q, k0, v0, cl, 0),
                plain=lambda: ref.flash_attention_chunk_partial_ref(q, k0, v0, cl, 0),
                library=lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                    qe, ke, ve, bias, True)[:2]),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=4 * pairs * h * dh,
        shape=f"q [1,{c},{h},{dh}] at cur_len {ROT_CUR} vs a slice [1,{ROT_SLICE},{hkv},{dh}] "
              f"bf16 at offset 0 ({pairs} visible pairs; mp-rotary-qwen36: a rank's {ROT_SLICE} "
              f"of {ROT_CACHE} positions, the chunk that straddles the slices), checked at "
              f"offsets 0 / {ROT_SLICE} and cur_len {ROT_CUR} / 0 and merged over two slices; f32 "
              f"rows [.., {dh + 1}] out; the tensor-core body; library: aten memory-efficient "
              f"SDPA with lse and an "
              f"explicit causal-offset bias, K/V expanded for GQA")


def dense_rows(dev, g):
    """Phase 3 at the dense and recurrent families' widths: K4's causal
    entry at 512 queries for dh 64 (musicgen, 32/32 heads), 96 (phi3,
    32/32), 160 (pixtral, 32/8) and 256 (recurrentgemma's 10/1), and at
    recurrentgemma's window 2048 over 3,072 queries; its chunk entry at dh
    160; K2's two entries (tensor cores at every width) at dh 96 g 1
    (phi3), dh 160 g 4 (pixtral), dh 128 g 9 (starcoder2-7b) and g 12
    (starcoder2-3b), and its contiguous entry
    at dh 256 g 10 over a ring of 2,048 (recurrentgemma). Each row carries
    ``base``, the kernel or entry it is a width of."""
    rows = {}
    for name, dh, h, hkv, _ in K4_WIDTHS:
        rows[name] = dict(k4_row(dev, g, dh, h, hkv), base="flash_attention")
    rows["flash_attention_chunk_dh160"] = dict(chunk_row(dev, g, 32, 8, 160),
                                               base="flash_attention_chunk")
    rows["flash_attention_dh256_w2048"] = dict(
        k4_row(dev, g, 256, 10, 1, s=RG_LONG, window=RG_WINDOW), base="flash_attention")
    rows["decode_attention_dh256_g10"] = dict(k2_ring_row(dev, g), base="decode_attention")
    for tag, dh, h, hkv, _ in K2_WIDTHS:
        for entry, r in k2_rows(dev, g, dh, h, hkv).items():
            rows[f"{entry}_{tag}"] = dict(r, base=entry)
    return rows


def width_paths(name: str):
    """The paths that run the width of phase-3 row ``name`` (and no other)."""
    if name in SHARDED_ROWS:
        return SHARDED_ROWS[name]
    for row, _, _, _, paths in K4_WIDTHS:
        if name == row:
            return paths
    if name == "flash_attention_chunk_dh160":
        return ()
    if name in ("flash_attention_dh256_w2048", "decode_attention_dh256_g10"):
        return ("serve-recurrentgemma-2b",)
    for tag, _, _, _, paths in K2_WIDTHS:
        if name in (f"decode_attention_{tag}", f"decode_attention_paged_{tag}"):
            return tuple(p for p in paths if p.startswith("serve-") == ("paged" in name))
    return None


def ragged_rows(dev, g, stores, slot_of):
    """Phase 3 for K1's ragged entry in bf16, int8 and int4: the picks of a
    128-token chunk (1,024 = 128 x 8 over 128 experts, 96 resident in 97
    store rows, the rest on the MISS row), sorted by slot with offsets made
    on the device, gate/up [1024, 2048] @ [97, 2048, 768] and down [1024,
    768] @ [97, 768, 2048], held against the plain version; timed on gate/up
    beside the plain version, a library composite over the same rows padded
    by slot to [G, C_max, D] (index_select of the used slots, dequantized
    for int8/int4, + bmm; the padding made outside the timing) and the bound
    (each used slot's bytes once, the kept rows in and all rows out,
    2 x kept rows x D x F operations)."""
    import torch

    from repro_torch.core.slots import quantize_int8_batch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    from repro_torch.quant import dequantize_int4, quantize_int4_batch

    n = 128 * 8
    ids = torch.randint(0, 128, (n,), generator=g, device=dev)
    flat = slot_of[ids]
    order = torch.argsort(flat, stable=True)
    offsets = torch.searchsorted(flat[order], torch.arange(SLOTS + 2, device=dev)).to(torch.int32)
    counts = (offsets[1:] - offsets[:-1]).cpu()
    counts[SLOTS] = 0
    used = torch.nonzero(counts).flatten()
    kept, c_max = int(counts.sum()), int(counts.max())
    d, f = stores["up"].shape[1:]
    x = (torch.randn((n, d), generator=g, device=dev)).to(torch.bfloat16)
    hid = (torch.randn((n, f), generator=g, device=dev)).to(torch.bfloat16)
    x_pad = torch.zeros((used.numel(), c_max, d), dtype=torch.bfloat16, device=dev)
    for i, sl in enumerate(used.tolist()):
        a, b = int(offsets[sl]), int(offsets[sl + 1])
        x_pad[i, :b - a] = x[a:b]
    used_dev = used.to(dev)
    out = {}
    for kind in ("bf16", "int8", "int4"):
        planes = {}
        for name, w in stores.items():
            if kind == "bf16":
                planes[name] = (w, None, None)
            else:
                q = quantize_int8_batch(w) if kind == "int8" else quantize_int4_batch(w, GROUP)
                planes[name] = tuple(q) + (None,) * (3 - len(q))
        tol = KERNEL_TOL if kind == "bf16" else QUANT_TOL
        err = max(check_close(f"slot_gmm ragged {kind} {name}",
                              gmm.slot_gmm_ragged(xx, *planes[name][:1], offsets,
                                                  *planes[name][1:], miss_slot=SLOTS),
                              ref.slot_gmm_ragged_ref(xx, *planes[name][:1], offsets,
                                                      *planes[name][1:], miss_slot=SLOTS),
                              **tol)
                  for name, xx in (("up", x), ("down", hid)))
        w, scale, mn = planes["up"]

        def library(w=w, scale=scale, mn=mn, kind=kind):
            if kind == "bf16":
                return torch.bmm(x_pad, w.index_select(0, used_dev))
            if kind == "int8":
                wg = w.index_select(0, used_dev).to(torch.bfloat16)
                return torch.bmm(x_pad, wg) * scale.index_select(0, used_dev)[:, None, :]
            wg = dequantize_int4(w.index_select(0, used_dev), scale.index_select(0, used_dev),
                                 mn.index_select(0, used_dev), torch.bfloat16)
            return torch.bmm(x_pad, wg)

        per_slot = sum(t[0].numel() * t.element_size() for t in (w, scale, mn) if t is not None)
        out_bytes = 2 if kind == "bf16" else 4
        nbytes = used.numel() * per_slot + kept * d * 2 + n * f * out_bytes + (SLOTS + 2) * 4
        b_ms, b_by = bound(nbytes, 2 * kept * d * f)
        name = "slot_gmm_ragged" if kind == "bf16" else f"slot_gmm_{kind}_ragged"
        out[name] = dict(
            max_abs_err=err,
            **timed(20, ("plain",), kernel=lambda w=w, scale=scale, mn=mn: gmm.slot_gmm_ragged(
                        x, w, offsets, scale, mn, miss_slot=SLOTS),
                    plain=lambda w=w, scale=scale, mn=mn: ref.slot_gmm_ragged_ref(
                        x, w, offsets, scale, mn, miss_slot=SLOTS),
                    library=library),
            bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=2 * kept * d * f,
            shape=f"x [{n},{d}] bf16 sorted by slot ({kept} kept rows over {used.numel()} "
                  f"slots, {n - kept} on MISS) @ {kind} w {list(w.shape)} (a 128-token "
                  f"chunk's gate/up); library: index_select{' + dequantize' if kind != 'bf16' else ''}"
                  f" + bmm over the rows padded to [{used.numel()},{c_max},{d}] (a composite)")
    return out


def router_rows(dev, g):
    """Phase 3 for K3's fused entry (router GEMM + gate) at the main path's
    widths (D 2048, E 128, k 8, h2 bf16): held against its plain version at
    T = 1 and 512 (and exact ties on small integers), then timed at T = 1
    (decode: the row) and T = 512 (prefill: ``prefill``) beside the plain
    version, the library composite (softmax of the f32 GEMM, ``torch.topk``,
    renormalization), the three calls it replaced (``h2.float()``, the f32
    GEMM, the logits-in gate: ``three_call``) and the bound (bytes, or f32
    operations at the 67 TFLOP/s peak outside the tensor cores)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_gate as tk

    d, e, k = 2048, 128, 8
    router = torch.randn((d, e), generator=g, device=dev) * d ** -0.5
    err, inputs = 0.0, {}
    for t in (1, PROMPT):
        h = torch.randn((t, d), generator=g, device=dev).to(torch.bfloat16)
        inputs[t] = h
        ids, w = tk.router_topk(h, router, k)
        rid, rw = ref.router_topk_ref(h, router, k)
        probs = torch.softmax(h.float() @ router, -1).sort(dim=-1, descending=True).values
        sure = probs[:, k - 1] - probs[:, k] > ROUTE_MARGIN
        if not torch.equal(ids[sure], rid[sure]) or not bool(sure.any()):
            raise AssertionError(f"router_topk T={t}: ids differ from the plain version")
        err = max(err, check_close(f"router_topk T={t}", w, rw, **ROUTE_TOL))
    gi = torch.Generator().manual_seed(3)                   # ties: exact sums on small integers
    hi = torch.randint(-1, 2, (16, 64), generator=gi).float()
    ri = torch.randint(-2, 3, (64, e), generator=gi).float()
    dup = [1, 3, 64, 127]
    ri[:, dup] = 2.0 * torch.sign(hi[0])[:, None]
    hi[1] = 0.0
    hi, ri = hi.to(dev, torch.bfloat16), ri.to(dev)
    ids, w = tk.router_topk(hi, ri, k)
    rid, rw = ref.router_topk_ref(hi, ri, k)
    if not torch.equal(ids, rid) or ids[0, :4].tolist() != dup or ids[1].tolist() != list(range(k)):
        raise AssertionError("router_topk: ties not broken lowest index first")
    err = max(err, check_close("router_topk ties", w, rw, **ROUTE_TOL))

    def measured(t, iters):
        h = inputs[t]

        def library():
            wv, iv = torch.topk(torch.softmax(h.float() @ router, -1), k)
            return iv, wv / wv.sum(-1, keepdim=True)

        nbytes = d * e * 4 + t * d * 2 + t * k * 8
        b_ms, b_by = bound(nbytes, 2 * t * d * e, F32_FLOPS)
        return dict(**timed(iters, kernel=lambda: tk.router_topk(h, router, k),
                            plain=lambda: ref.router_topk_ref(h, router, k), library=library,
                            three_call=lambda: tk.topk_gate(h.float() @ router, k)),
                    bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=2 * t * d * e,
                    shape=f"h2 [{t},{d}] bf16 @ router [{d},{e}] f32, top-{k} renormalized")

    row = dict(max_abs_err=err, **measured(1, 50))
    row["shape"] += " (decode); library: softmax(h2.float() @ router) + topk + renormalization"
    row["prefill"] = measured(PROMPT, 20)
    return row


def rate(r) -> str:
    """What a timed row achieved: GB/s and TFLOP/s of its counted bytes and
    operations, and the share of the bound (bound_ms / time), in device time
    and in wall time per call."""
    return "; ".join(
        f"{label}: {r['nbytes'] / r[key] / 1e6:.1f} GB/s, {r['flops'] / r[key] / 1e9:.2f} "
        f"TFLOP/s, {100 * r['bound_ms'] / r[key]:.1f}% of the bound"
        for label, key in (("device", "device_ms"), ("per call", "ms")))


def gemv_down(fn, nbytes, d, f, shape):
    """A GEMV body timed at the decode down-projection, x [8,1,F] against
    [S+1, F, D] through the LUT: ``nbytes`` it must move, 2 x 8 x D x F
    operations."""
    b_ms, b_by = bound(nbytes, 2 * 8 * d * f)
    return dict(**timed(kernel=fn), bound_ms=b_ms, bound_by=b_by, nbytes=nbytes,
                flops=2 * 8 * d * f, shape=shape)


def quant_rows(kind, stores, luts, lut_next, distinct, dec, pre, used, rows_used):
    """Phase 3 for the int8 or int4 bodies of K1: ``stores`` (bf16 [S+1, D, F]
    up and down matrices) quantized on the card, the GEMV body at the decode
    shapes (8 picks, C = 1, four LUTs of which one reads the MISS slot) and
    the tiled body at the prefill grouping, each against the plain version;
    timed on the gate/up store beside the plain version, a library
    composite (``index_select`` + dequantize to bf16 + ``bmm``) and the bound.
    Returns the two kernel rows."""
    import torch

    from repro_torch.core.slots import quantize_int8_batch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    from repro_torch.quant import dequantize_int4, quantize_int4_batch

    planes = {}                               # name -> (w, scale, mn or None)
    for name, w in stores.items():
        q = quantize_int8_batch(w) if kind == "int8" else quantize_int4_batch(w, GROUP)
        planes[name] = tuple(q) + (None,) * (3 - len(q))

    def both(label, x, name, lut):
        w, scale, mn = planes[name]
        return check_close(f"slot_gmm_{kind} {label} {name}", gmm.slot_gmm(x, w, lut, scale, mn),
                           ref.slot_gmm_ref(x, w, lut, scale, mn), **QUANT_TOL)

    err_dec = max(both("decode", x, name, lut) for lut in luts[:4]
                  for name, x in zip(("up", "down"), dec))
    err_pre = max(both("prefill", x, name, used) for name, x in zip(("up", "down"), pre))
    w, scale, mn = planes["up"]
    d, f = stores["up"].shape[1:]

    def library(x, lut):                      # one composite of library calls
        idx = lut.long()
        if kind == "int8":
            wg = w.index_select(0, idx).to(x.dtype)
            return torch.bmm(x, wg) * scale.index_select(0, idx)[:, None, :]
        wg = dequantize_int4(w.index_select(0, idx), scale.index_select(0, idx),
                             mn.index_select(0, idx), x.dtype)
        return torch.bmm(x, wg)

    w_dn, scale_dn, mn_dn = planes["down"]
    per_slot, per_slot_dn = (sum(t[0].numel() * t.element_size() for t in ts if t is not None)
                             for ts in (planes["up"], planes["down"]))
    x_dec, h_dec, x_pre = dec[0], dec[1], pre[0]
    out = {}
    nbytes = distinct * per_slot + 8 * d * 2 + 8 * f * 4 + 8 * 4
    b_ms, b_by = bound(nbytes, 2 * 8 * d * f)
    out[f"slot_gmm_{kind}"] = dict(
        max_abs_err=err_dec,
        **timed(kernel=lambda: gmm.slot_gmm(x_dec, w, lut_next(), scale, mn),
                plain=lambda: ref.slot_gmm_ref(x_dec, w, lut_next(), scale, mn),
                library=lambda: library(x_dec, lut_next())),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=2 * 8 * d * f,
        shape=f"x [8,1,{d}] bf16 @ {kind} w {list(w.shape)} through an 8-entry LUT (decode "
              f"gate/up), f32 out; library: index_select + dequantize + bmm (a composite)",
        down=gemv_down(lambda: gmm.slot_gmm(h_dec, w_dn, lut_next(), scale_dn, mn_dn),
                       distinct * per_slot_dn + 8 * f * 2 + 8 * d * 4 + 8 * 4, d, f,
                       f"x [8,1,{f}] bf16 @ {kind} w {list(w_dn.shape)} (decode down)"),
    )
    pre_bytes = used.numel() * per_slot + rows_used * (d * 2 + f * 4)
    b_ms, b_by = bound(pre_bytes, 2 * rows_used * d * f)
    out[f"slot_gmm_{kind}_tiled"] = dict(
        max_abs_err=err_pre,
        **timed(20, kernel=lambda: gmm.slot_gmm(x_pre, w, used, scale, mn),
                plain=lambda: ref.slot_gmm_ref(x_pre, w, used, scale, mn),
                library=lambda: library(x_pre, used)),
        bound_ms=b_ms, bound_by=b_by, nbytes=pre_bytes, flops=2 * rows_used * d * f,
        shape=f"x {list(x_pre.shape)} bf16 @ {kind} w {list(w.shape)}, the picks of {PROMPT} "
              f"tokens grouped by slot ({rows_used} rows; prefill gate/up), f32 out; library: "
              f"index_select + dequantize + bmm (a composite)",
    )
    return out


# ---------------------------------------------------------------------------
# phase 5: the plain full-residency forward
# ---------------------------------------------------------------------------
def float_experts(engine, li, dtype):
    """Layer ``li``'s routed experts on the card in ``dtype``: the bf16
    warehouse as it is (or in f32), or a packed warehouse dequantized in f32
    (int4 ``q * s + m``, int8 ``q * scale``) and then cast."""
    import torch

    from repro_torch.core.slots import dequantize_int8
    from repro_torch.quant import dequantize_int4

    hw = {n: t.to(engine.device) for n, t in engine.host_experts[li].items()}
    out = {}
    for name in ("w_gate", "w_up", "w_down"):
        if name not in hw:
            continue
        if f"min_{name}" in hw:
            w = dequantize_int4(hw[name], hw[f"scale_{name}"], hw[f"min_{name}"])
        elif f"scale_{name}" in hw:
            w = dequantize_int8(hw[name], hw[f"scale_{name}"][:, None, :])
        else:
            w = hw[name]
        out[name] = w.to(dtype)
    return out


def reference_logits(cfg, engine, tokens, dtype, router=None, routes=None):
    """Logits at every position of ``tokens`` [1, S] from a plain forward with
    every expert resident, in ``dtype``, on the engine's weights cast to it
    (a quantized warehouse dequantized first), calling ``kernels/ref.py``
    directly (``router``, ``routes``: as :func:`reference_rows`')."""
    s = tokens.shape[1]
    return reference_rows(cfg, engine, tokens, [list(range(s))], dtype, router=router,
                          routes=routes)[0]


def reference_rows(cfg, engine, tokens, rows, dtype, frontend=None, router=None, routes=None):
    """:func:`reference_logits` over a batch ``tokens`` [B, S] (right-padded
    rows: the forward is causal, so pads reach no earlier position), the
    logits at positions ``rows[b]`` of each row b only, [B, R, V] f32. A
    dense layer runs its MLP, a local-attention layer masks outside its
    window, a recurrent layer runs the port's plain cell over the rows (a
    causal scan, so pads after a row's positions reach none of them);
    ``frontend`` [B, F, frontend_dim] comes first (``rows`` then count its
    positions). ``router`` (a list): each MoE layer's f32 router logits at
    the picked positions, [B, R, E], are appended to it. ``routes`` (per MoE
    layer ids [B, S, k]): each layer takes those experts instead of its own
    top-k, weighted by its own router probabilities (renormalized as the
    gate does)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.config.base import KV_KINDS
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_mlp, apply_norm

    def cast(tree):          # bf16: the weights as they are (routers stay f32)
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.float() if dtype == torch.float32 else tree

    dev = engine.device
    m = cfg.moe
    emb = cast(engine.embed_params)
    x = tfm.embed_tokens(emb, torch.as_tensor(tokens, device=dev))
    if frontend is not None:
        x = tfm.prepend_frontend(cfg, emb, x, frontend)
    b, s, d = x.shape
    pos = torch.arange(s, device=dev)[None, :]
    mi = 0                                  # MoE ordinal: the warehouse's index
    for kind, p in zip(cfg.layer_kinds, engine.layers):
        if "moe" in p:
            p = cast({k: v for k, v in p.items() if k != "moe"}
                     | {"moe": {k: v for k, v in p["moe"].items() if k != "experts"}})
        else:
            p = cast(p)
        if kind not in KV_KINDS:
            x = tfm.recurrent_block(cfg, kind, p, x, "prefill", None)[0]
            del p
            continue
        h = apply_norm(cfg.norm, p["ln1"], x)
        q, k, v = attn._project_qkv(p["attn"], cfg.attention, h, pos)
        x = x + ref.flash_attention_ref(q, k, v, causal=True, window=cfg.attention.window
                                        ).reshape(b, s, -1) @ p["attn"]["wo"]
        h2 = apply_norm(cfg.norm, p["ln2"], x).reshape(b * s, d)
        if "mlp" in p:
            x = x + apply_mlp(cfg.mlp, p["mlp"], h2).reshape(b, s, d)
            del p
            continue
        z = h2.float() @ p["moe"]["router"]
        if router is not None:
            at = torch.as_tensor(rows, device=dev)
            router.append(torch.gather(z.reshape(b, s, -1), 1,
                                       at[..., None].expand(-1, -1, z.shape[-1])).cpu())
        if routes is None:
            ids, w = ref.topk_gate_ref(z, m.top_k, normalize=m.norm_topk_prob)
        else:
            ids = torch.as_tensor(routes[mi], device=dev).reshape(b * s, -1).long()
            w = torch.gather(torch.softmax(z, dim=-1), 1, ids)
            if m.norm_topk_prob:
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        experts = float_experts(engine, mi, dtype)
        mi += 1
        flat = ids.reshape(-1).long()
        counts = torch.bincount(flat, minlength=m.num_experts)
        used = torch.nonzero(counts).flatten()
        c_max = int(counts.max())
        order = torch.argsort(flat, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        row = torch.arange(order.numel(), device=dev) - starts[flat[order]]
        grp = torch.full((m.num_experts,), -1, dtype=torch.long, device=dev)
        grp[used] = torch.arange(used.numel(), device=dev)
        xs = torch.zeros((used.numel(), c_max, d), dtype=x.dtype, device=dev)
        xs[grp[flat[order]], row] = h2[order // m.top_k]
        if "w_gate" in experts:
            hid = (F.silu(ref.slot_gmm_ref(xs, experts["w_gate"], used))
                   * ref.slot_gmm_ref(xs, experts["w_up"], used))
        else:
            hid = F.gelu(ref.slot_gmm_ref(xs, experts["w_up"], used), approximate="tanh")
        ys = ref.slot_gmm_ref(hid, experts["w_down"], used)
        outs = torch.empty((flat.numel(), d), dtype=x.dtype, device=dev)
        outs[order] = ys[grp[flat[order]], row]
        y = (outs.float().reshape(b * s, m.top_k, d) * w[..., None]).sum(1).to(x.dtype)
        x = x + y.reshape(b, s, d)
        del p, experts, xs, hid, ys, outs
    idx = torch.as_tensor(rows, device=dev)                              # [B, R]
    picked = torch.gather(x, 1, idx[..., None].expand(-1, -1, d))
    return tfm.lm_logits(cfg, emb, picked).float()


def sure_positions(truth, plain):
    """Positions whose truth top-2 margin exceeds twice the plain bf16
    forward's largest error: where a greedy id cannot flip on rounding."""
    import numpy as np

    top2 = np.sort(truth, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > 2 * np.abs(plain - truth).max()


def judge(label, got, truth, plain) -> bool:
    """Log how far ``got`` [positions, vocab] is from the f32 ``truth``
    beside a plain bf16 forward's distance, and return whether it holds the
    tolerance stated at the top of this file."""
    import numpy as np

    e_eng = np.abs(got - truth).max(axis=1)                        # per position
    e_pl = np.abs(plain - truth).max(axis=1)
    rms_eng = float(np.sqrt(np.mean((got - truth) ** 2)))
    rms_pl = float(np.sqrt(np.mean((plain - truth) ** 2)))
    sure = sure_positions(truth, plain)
    agree = got.argmax(1) == truth.argmax(1)
    log(f"  {label}: vs the f32 truth (logit RMS {float(np.sqrt(np.mean(truth ** 2))):.4f}): "
        f"engine RMS err {rms_eng:.5f} (limit {ERR_RATIO * rms_pl + RMS_SLACK:.5f}), "
        f"per-position max median {np.median(e_eng):.4f} max {e_eng.max():.4f} (limit "
        f"{ERR_RATIO * e_pl.max() + MAX_SLACK:.4f}); plain bf16 forward RMS err {rms_pl:.5f}, "
        f"median {np.median(e_pl):.4f} max {e_pl.max():.4f}; greedy ids agree with the truth "
        f"at {int(agree[sure].sum())}/{int(sure.sum())} positions with margin > "
        f"{2 * e_pl.max():.3f}, at {int(agree.sum())}/{len(got)} in all")
    return bool(rms_eng <= ERR_RATIO * rms_pl + RMS_SLACK
                and e_eng.max() <= ERR_RATIO * e_pl.max() + MAX_SLACK and agree[sure].all())


def describe(path: PathSpec) -> str:
    """The path's prefill and decode mechanisms in words."""
    if path.host_routing:
        text = "host routing (the per-layer sync walk, top-k on the host)"
    elif path.lru:
        text = "LRU residency (the per-layer sync walk, misses answered by blocking uploads)"
    elif path.fused_decode is False:
        text = "the per-layer hot walk (one blocking pull a token)"
    else:
        text = "prefetch + miss relaunch" if path.prefetch else "synchronous rotation"
        if path.spec_k > 1:
            text += (f", speculative windows of {path.spec_k} (one CUDA graph per window size "
                     f"and sampler)")
    if path.chunk:
        how = ("walked layer by layer" if path.fused_decode is False
               else "one CUDA graph per chunk length")
        text += f", chunked prefill in chunks of {path.chunk} ({how})"
    if path.sample:
        t, k, p, seed = path.sample
        text += (f", sampled (temperature {t}, top-k {k}, top-p {p}, seed {seed}; "
                 f"{'size-1 ' if path.spec_k == 1 else ''}windows drawing on the card)")
    return text


def make_engine(dev, cfg, params, path: PathSpec, trace=None):
    """The path's ``RotaryEngine``: its residency, slot format and switches,
    batch 1, cache_len CACHE, traced by ``trace`` (a Tracer) if given."""
    from repro_torch.config import ResidencyConfig
    from repro_torch.core.engine import RotaryEngine
    from repro_torch.models.transformer import Runtime

    mode = "lru" if path.lru else ("rotary" if path.slots else "full")
    rescfg = ResidencyConfig(mode=mode, num_slots=path.slots, quantization=path.quantization,
                             quant_group_size=GROUP)
    return RotaryEngine(cfg, params, rescfg, rt=Runtime(cache_len=CACHE), batch=1, seed=0,
                        prefetch=path.prefetch, host_routing=path.host_routing,
                        fused_decode=path.fused_decode, spec_k=path.spec_k,
                        prefill_chunk=path.chunk or None, trace=trace, device=dev)


def sampler_of(path: PathSpec):
    """The path's ``SamplerConfig``, or None (greedy)."""
    from repro_torch.serving.sampler import SamplerConfig

    if path.sample is None:
        return None
    t, k, p, seed = path.sample
    return SamplerConfig(temperature=t, top_k=k, top_p=p, seed=seed)


def decode_request(engine, logits, new, spec: bool, sampler=None):
    """Decode ``new`` tokens (greedy, or drawn by ``sampler``) after a
    prefill's ``logits``. One decode call per token, or (``spec``) one call
    for all of them, whose windows are timed one by one. Returns (tokens,
    the logits that chose them [new, V], seconds per decode iteration,
    tokens per iteration)."""
    import numpy as np

    if not spec:
        step_logits, toks, step_s = [logits], [], []
        for _ in range(new):
            t0 = time.perf_counter()
            toks.append(int(engine.decode(step_logits[-1], 1, sampler=sampler)[0, 0]))
            step_s.append(time.perf_counter() - t0)
            step_logits.append(engine.last_logits)
        return toks, np.stack([l[0] for l in step_logits[:-1]]), step_s, [1] * new
    iters = []
    window, step = engine._decode_window_fused, engine._decode_step_fused

    def timed(fn, committed):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            iters.append((time.perf_counter() - t0, committed(out)))
            return out
        return run

    engine._decode_window_fused = timed(window, lambda out: out[2])
    engine._decode_step_fused = timed(step, lambda out: 1)
    engine.logit_log = [logits]
    try:
        toks = engine.decode(logits, new, sampler=sampler)[0].tolist()
        got = engine.logged_logits()[:-1, 0]
    finally:
        del engine._decode_window_fused, engine._decode_step_fused
        engine.logit_log = None
    return toks, got, [t for t, _ in iters], [n for _, n in iters]


# ---------------------------------------------------------------------------
# the traces: every engine path's measured run audited (repro_torch.obs)
# ---------------------------------------------------------------------------
MISS_FREE_PATHS = ("full", "full-spec4", "full-chunk", "serve-full", "serve-full-group")
KV_EVENTS = ("kv_reserve", "kv_ensure", "kv_release", "kv_use")


def int_counters(stats) -> dict:
    """Every count of an ``EngineStats`` (its ints, per layer too): what a
    traced and an untraced run of the same inputs share (the floats are
    times)."""
    out = {k: v for k, v in dataclasses.asdict(stats).items() if isinstance(v, int)}
    out["layers"] = {l: dataclasses.asdict(ls) for l, ls in stats.layers.items()}
    return out


def audit_path(label: str, tracer, trace: dict, overlap_ms: float, units: int, *,
               prefetch: bool, paged: Optional[bool] = None, uids=()) -> dict:
    """Audit ``trace`` (``tracer``'s export right after the path's measured
    run, whose ``stats.overlap_ms`` was ``overlap_ms``), write it to
    ``build/traces/<label>.json`` and print its numbers. Fails on a
    violation, on a ring that overflowed, on other than ``units`` units, on
    a missed unit of a MISS_FREE_PATHS path, on a prefetch path whose spans'
    overlap is not ``overlap_ms`` within 1%; for a serving path (``paged``
    True, or False for the group tick) also on a unit without exactly one
    launch and one pull, on lanes other than ``uids`` or one without
    ``queued`` and ``prefill`` (and ``finish``, paged), and a paged path on
    an untraced pool. Returns the audit's summary with the trace's size."""
    from repro_torch.obs import audit

    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    out = TRACE_DIR / f"{label}.json"
    out.write_text(json.dumps(trace))
    mb = out.stat().st_size / 2**20
    n_events = sum(e["ph"] != "M" for e in trace["traceEvents"])
    rep = audit(trace)
    s = rep.summary()
    log(f"  trace: {s['units_checked']} units checked ({units} run), {s['miss_free_units']} "
        f"miss-free, {s['launches']} launches, {s['pulls']} pulls, {s['rotations']} rotations, "
        f"{s['prefetch_spans']} prefetch spans, {s['kv_events']} KV events; {n_events} events "
        f"recorded (ring of {tracer.capacity}); overlap {rep.overlap_ms:.3f} ms from the spans, "
        f"stats.overlap_ms {overlap_ms:.3f}; {mb:.2f} MB in {out.relative_to(ROOT)}; "
        f"{s['violations']} violations")
    rep.raise_for_violations()
    problems = []
    if n_events >= tracer.capacity:
        problems.append(f"{n_events} events filled the ring: its first units are lost")
    if rep.units_checked != units:
        problems.append(f"{rep.units_checked} units checked, {units} run")
    if label in MISS_FREE_PATHS and rep.miss_free_units != rep.units_checked:
        problems.append(f"{rep.units_checked - rep.miss_free_units} units missed")
    if prefetch and (rep.prefetch_spans <= 0 or abs(rep.overlap_ms - overlap_ms) > 0.01 * overlap_ms):
        problems.append(f"{rep.prefetch_spans} prefetch spans, overlap {rep.overlap_ms:.3f} ms "
                        f"against stats.overlap_ms {overlap_ms:.3f}")
    if paged is not None:
        if not rep.launches == rep.pulls == rep.units_checked:
            problems.append(f"{rep.launches} launches and {rep.pulls} pulls in "
                            f"{rep.units_checked} ticks")
        lanes = {}
        for e in trace["traceEvents"]:
            if e.get("pid") == 2 and e["ph"] != "M":
                lanes.setdefault(e["tid"], set()).add(e["name"])
        want = {"queued", "prefill", "finish"} if paged else {"queued", "prefill"}
        if set(lanes) != set(uids) or any(not want <= names for names in lanes.values()):
            problems.append(f"lanes {sorted(lanes)} for requests {sorted(uids)}, events "
                            f"{sorted(set().union(*lanes.values())) if lanes else []}")
        if paged and rep.kv_events <= 0:
            problems.append("no KV page event")
    if problems:
        raise AssertionError(f"{label}: trace: " + "; ".join(problems))
    return dict(s, events=n_events, trace_mb=mb, overlap_stats_ms=overlap_ms)


def control_flagged(label: str, planted: dict, what: str, want: str) -> None:
    """A planted fault (``what``) the auditor must report (``want`` in a
    violation), so that the check shown can fail."""
    from repro_torch.obs import audit

    rep = audit(planted)
    log(f"  control ({what}): the auditor reports {len(rep.violations)} violation(s)"
        f"{': ' + rep.violations[0] if rep.violations else ''}")
    if not any(want in v for v in rep.violations):
        raise AssertionError(f"{label}: the auditor passed a trace with {what}")


def plant_second_pull(trace: dict) -> dict:
    """``trace`` with a copy of one ``pull`` span added to its miss-free unit."""
    events = trace["traceEvents"]
    exempt = {e["args"]["unit"] for e in events if e["ph"] != "M" and (
        e["name"] in ("miss", "replay") or e["args"].get("kind") == "relaunch")}
    pull = next(e for e in events if e.get("name") == "pull" and e["args"]["unit"] > 0
                and e["args"]["unit"] not in exempt)
    return dict(trace, traceEvents=events + [dict(pull, ts=pull["ts"] + pull["dur"])])


def plant_use_after_release(trace: dict) -> dict:
    """``trace`` with one ``kv_use`` moved past the ``kv_release`` of a page
    it names, before the next page event."""
    events = trace["traceEvents"]
    kv = sorted((e for e in events if e.get("name") in KV_EVENTS), key=lambda e: e["ts"])
    for i, rel in enumerate(kv):
        if rel["name"] != "kv_release":
            continue
        later = [e["ts"] for e in kv[i + 1:] if e["ts"] > rel["ts"]]
        use = next((e for e in reversed(kv[:i]) if e["name"] == "kv_use"
                    and set(e["args"]["pages"]) & set(rel["args"]["pages"])), None)
        if use is not None:
            moved = dict(use, ts=(rel["ts"] + later[0]) / 2 if later else rel["ts"] + 1.0)
            return dict(trace, traceEvents=[moved if e is use else e for e in events])
    raise AssertionError("no kv_use before a kv_release of its pages")


def run_path(dev, cfg, depth, path: PathSpec, done: dict) -> dict:
    """Phase 4 and 5 for one path: build the engine, drive its requests of
    PROMPT tokens and ``new`` greedy tokens each with the launch counters
    zeroed just before, check the logits against the plain forward (and the
    control; a path with a baseline also its greedy ids against the
    baseline's in ``done``), free the engine. Returns the path's summary:
    launch counts and the numbers phase 6 prints."""

    import numpy as np
    import torch

    from repro_torch.core.engine import prefill_chunk_plan
    from repro_torch.core.slots import quantize_experts
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import Tracer

    label, quantization, requests, new = path.label, path.quantization, path.requests, path.new
    spec = path.spec_k > 1
    sampler = sampler_of(path)
    lens = path.prompt_lens or (PROMPT,) * requests
    experts = cfg.moe.num_experts
    where = (f"all {experts} experts resident" if not path.slots else
             f"{'LRU' if path.lru else 'rotary'} residency {path.slots}/{experts} slots")
    log(f"[4/{label}] {cfg.name} at published widths, {cfg.num_layers} of {depth} layers, "
        f"{where} in {quantization or 'bf16'}"
        f"{f' (groups of {GROUP})' if quantization == 'int4' else ''}, "
        f"{describe(path)}, {requests} request(s) x ({' / '.join(map(str, lens))} prompt + "
        f"{new} new), batch 1, {'sampled' if sampler else 'greedy'}, cache_len {CACHE}")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, dev, expert_device="cpu")
    tracer = Tracer()
    engine = make_engine(dev, cfg, params, path, trace=tracer)
    warehouse = sum(t.numel() * t.element_size() for hw in engine.host_experts
                    for t in hw.values())
    log(f"  set-up {time.perf_counter() - t0:.1f} s (weights on the card, warehouse to pinned "
        f"host memory{', quantized on the card' if quantization else ''}, first residency); "
        f"link {engine.cost.host_link_gbs:.1f} GB/s measured; warehouse {warehouse / 1e9:.2f} GB")
    if quantization and not path.prefetch:     # the card's quantizer against the CPU's, one layer
        t0 = time.perf_counter()
        layer0 = params["layers"][0]["moe"]["experts"]
        n_check = path.quant_check or experts
        cpu = quantize_experts({n: w[:n_check].cpu() for n, w in layer0.items()}, quantization,
                               GROUP,
                               device="cpu")
        for name, plane in cpu.items():
            if not torch.equal(plane, engine.host_experts[0][name][:n_check]):
                raise AssertionError(f"layer 0 {name}: the card's {quantization} bytes differ "
                                     f"from the CPU quantizer's")
        log(f"  layer 0 quantized on the card equals the CPU quantizer byte for byte "
            f"({len(cpu)} planes, CPU pass {time.perf_counter() - t0:.1f} s)")
    if not path.untraced_twin:
        del params
    rng = np.random.default_rng(0)          # request i's first tokens are the same on every path
    prompts = [rng.integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)[:, :n]
               for n in lens]
    if path.same_prompt:
        prompts = [prompts[0]] * requests
    runs = []
    st = engine.stats
    dec = dict(pulls=0, bytes=0, steps=0, overlapped=0)    # the decode steps' share
    pre = []                                # per request: prefill logits, pulls, chunks, replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for prompt in prompts:
        p0, c0, r0 = st.sync_pulls, st.prefill_chunks, st.prefill_replays
        t0 = time.perf_counter()
        logits = engine.prefill(prompt)
        t_prefill = time.perf_counter() - t0
        pre.append((logits, st.sync_pulls - p0, st.prefill_chunks - c0, st.prefill_replays - r0))
        pulls0, bytes0, over0 = st.sync_pulls, st.bytes_uploaded, st.overlapped_pulls
        toks, got, step_s, step_n = decode_request(engine, logits, new, spec, sampler)
        dec["pulls"] += st.sync_pulls - pulls0
        dec["bytes"] += st.bytes_uploaded - bytes0
        dec["overlapped"] += st.overlapped_pulls - over0
        dec["steps"] += new
        runs.append((prompt, toks, got, t_prefill, step_s, step_n))
    counts = ops.launch_counts()
    symbols = ops.symbol_launch_counts()
    # the measured run's trace and counts, before anything else runs on the engine
    trace, overlap_ms, counters = tracer.chrome_trace(), st.overlap_ms, int_counters(st)
    entries = symbols["topk_gate"]
    peak = torch.cuda.max_memory_allocated()
    host_computed = sum(l.host_computed for l in st.layers.values())
    loads = sum(l.loads for l in st.layers.values())
    copy_ms = engine.manager.copy_stream_ms()
    unit = "window" if spec else "step"
    for i, (_, toks, _, tp, step_s, step_n) in enumerate(runs):
        log(f"  request {i}: prefill {tp * 1e3:.1f} ms, decode {new / sum(step_s):.2f} tok/s "
            f"(first {unit} {step_s[0] * 1e3:.1f} ms"
            f"{', the graph captured in it' if i == 0 and engine._graphs else ''}; "
            f"{(new - step_n[0]) / sum(step_s[1:]):.2f} tok/s after it, median {unit} "
            f"{np.median(step_s[1:]) * 1e3:.2f} ms over {len(step_s)} {unit}s), first tokens "
            f"{toks[:8]}")
    mb_per_token = dec["bytes"] / 2**20 / dec["steps"]
    log(f"  misses {st.misses}, replayed steps {st.replayed_steps}, relaunched steps "
        f"{st.relaunched_steps}, host_computed {host_computed}, loads {loads}, uploaded "
        f"{st.bytes_uploaded / 2**20:.1f} MB ({st.bytes_uploaded / loads if loads else 0:.0f} "
        f"bytes per loaded expert; {mb_per_token:.2f} MB per decode token), sync pulls {st.sync_pulls} "
        f"({dec['pulls']} in {dec['steps']} decode steps), overlapped pulls {st.overlapped_pulls}, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    if spec:
        log(f"  windows {st.spec_windows}, drafted {st.drafted_tokens}, accepted "
            f"{st.accepted_tokens} (accept rate {st.accept_rate:.3f})")
    log(f"  graphs: {engine.graph_captures} capture(s) (keys "
        f"{sorted(map(str, engine._graphs))}), {engine.graph_replays} replays, "
        f"{engine.launches} launches")
    if path.chunk:
        log(f"  chunked prefill per request: "
            + "; ".join(f"{p.shape[1]} tokens in {n} chunks, {pulls} blocking pulls, {rep} replayed"
                        for p, (_, pulls, n, rep) in zip(prompts, pre)))
    log(f"  host weight conversion for missed experts: {st.host_dequant_s:.3f} s over "
        f"{st.host_dequant_experts} experts "
        f"({1e3 * st.host_dequant_s / max(st.host_dequant_experts, 1):.3f} ms each)")
    if path.prefetch:
        log(f"  prefetch: launched {st.prefetch_launched} uploads, hits {st.prefetch_hits}, "
            f"wasted {st.prefetch_wasted_bytes / 2**20:.1f} MB; overlap_ms {st.overlap_ms:.1f} "
            f"(host wall of begin_prefetch), copy stream {copy_ms:.1f} ms (event-timed shadow "
            f"uploads)")
    tiled = {sym: n for name, syms in symbols.items() if name.endswith("_tiled")
             for sym, n in syms.items()}
    log(f"  kernel launches on this path: {counts}; K3 by entry: {entries}; K1's tiled body "
        f"by entry: {tiled}")
    fused = sum(n for sym, n in entries.items() if sym.startswith("router_topk_"))
    if path.host_routing:
        if counts["topk_gate"]:
            raise AssertionError(f"{label}: K3 launched {entries}: host routing routes on the host")
    elif fused <= 0 or fused != counts["topk_gate"]:
        raise AssertionError(f"{label}: K3 launched {entries}: every routing site must take the "
                             f"fused entry")
    per_expert = expert_bytes(cfg, quantization) if quantization else 0
    if quantization and not path.prefetch and st.bytes_uploaded != loads * per_expert:
        raise AssertionError(f"{st.bytes_uploaded} bytes uploaded for {loads} loads: not "
                             f"{per_expert} per {quantization} expert")
    if quantization and path.prefetch and st.bytes_uploaded % per_expert:
        # shadow uploads ship experts that no load counts: whole experts all the same
        raise AssertionError(f"{st.bytes_uploaded} bytes uploaded: not whole "
                             f"{per_expert}-byte {quantization} experts")
    if not engine._fused_decode:                      # the walks launch no graph
        graphs_ok = engine.graph_captures == engine.launches == 0
    else:            # on the card every fused launch a replay but each graph's first
        keys = list(engine._graphs)
        chunk_keys = [key for key in keys if isinstance(key, tuple) and key[0] == "chunk"]
        draw_keys = [key for key in keys if isinstance(key, tuple) and key[0] == "draw"]
        window_keys = len(keys) - len(chunk_keys) - len(draw_keys)
        want_chunk = {(c, i == len(plan) - 1) for plan in (prefill_chunk_plan(n, path.chunk)
                                                           for n in lens if path.chunk)
                      for i, c in enumerate(plan)}
        graphs_ok = dev.type != "cuda" or (
            engine.graph_captures == len(keys)
            and engine.graph_captures + engine.graph_replays == engine.launches
            and window_keys <= path.spec_k and (spec or window_keys == 1)
            and len(draw_keys) == (sampler is not None)
            and {(c, head) for _, c, head in chunk_keys} == want_chunk)
    if not graphs_ok:
        raise AssertionError(f"{label}: {engine.graph_captures} captures ({sorted(map(str, keys))}),"
                             f" {engine.graph_replays} replays and {engine.launches} launches")
    windows = requests * -(-new // path.spec_k)
    want_pulls = windows * (2 if sampler else 1)     # a sampled window's draw: a pull of its own
    if not path.slots and (st.misses or st.replayed_steps or dec["pulls"] != want_pulls
                           or st.accepted_tokens != st.drafted_tokens or st.prefill_replays):
        raise AssertionError(f"{label}: {st.misses} misses, {st.replayed_steps} replays, "
                             f"{st.prefill_replays} chunk replays and {dec['pulls']} blocking "
                             f"pulls in {dec['steps']} decode steps (want {want_pulls})")
    ragged = "slot_gmm_ragged" if not quantization else f"slot_gmm_{quantization}_ragged"
    grouped = entry_launches(symbols, ragged.replace("_ragged", "_tiled"))
    if entry_launches(symbols, ragged) <= 0 or grouped:
        raise AssertionError(f"{label}: the prefill launched {ragged} "
                             f"{entry_launches(symbols, ragged)} times and the grouped tiled "
                             f"entry {grouped} times")
    if path.chunk:
        if counts["flash_attention_chunk"] <= 0:
            raise AssertionError(f"{label}: chunked prefill launched no flash_attention_chunk")
        for n, (_, pulls, chunks, replayed) in zip(lens, pre):
            plan = prefill_chunk_plan(n, path.chunk)
            walk = path.fused_decode is False
            want = chunks == len(plan) and (walk or pulls >= len(plan))
            if not path.slots:           # miss-free: one graph replay and one pull a chunk
                want = want and pulls == len(plan) and not replayed
            if not want:
                raise AssertionError(f"{label}: a {n}-token prompt took {chunks} chunks, "
                                     f"{pulls} pulls, {replayed} replays (plan {plan})")
    elif counts["flash_attention_chunk"]:
        raise AssertionError(f"{label}: the legacy prefill launched K4's chunk entry")
    if path.fused_decode is False and dec["overlapped"] != 4 * cfg.num_layers * dec["steps"]:
        raise AssertionError(f"{label}: {dec['overlapped']} overlapped pulls in {dec['steps']} "
                             f"steps, not 4 a layer")
    if path.lru and not loads:
        raise AssertionError(f"{label}: LRU made no load")
    # the units: each fused decode step or window, each fused prefill chunk
    fused_chunks = path.chunk and engine._fused_decode and engine._chunk_prefill_fused_ok
    units = ((sum(len(r[4]) for r in runs) if engine._fused_decode else 0)
             + (st.prefill_chunks if fused_chunks else 0))
    traced = audit_path(label, tracer, trace, overlap_ms, units, prefetch=path.prefetch)
    if path.untraced_twin:
        control_flagged(label, plant_second_pull(trace), "a second pull in a miss-free unit",
                        "primary pulls")
        twin = make_engine(dev, cfg, params, path)
        del params
        logits = twin.prefill(runs[0][0])
        toks, _, step_s, _ = decode_request(twin, logits, new, spec, sampler)
        same = (twin._tr is None and toks == runs[0][1] and int_counters(twin.stats) == counters)
        traced["untraced_median_ms"] = 1e3 * float(np.median(step_s[1:]))
        log(f"  the request again untraced on an engine of the same weights: tokens and "
            f"counters equal: {same}; median step {1e3 * np.median(runs[0][4][1:]):.4f} ms traced, "
            f"{traced['untraced_median_ms']:.4f} ms untraced")
        del twin
        if not same:
            raise AssertionError(f"{label}: the untraced run differs from the traced one")

    log(f"[5/{label}] engine vs plain full-residency forward on the card")
    if host_computed != st.misses:
        raise AssertionError(f"host_computed {host_computed} != misses {st.misses}")
    refs = []
    for i, (prompt, toks, got, _, _, _) in enumerate(runs):
        if not np.isfinite(got).all() or got.shape != (new, cfg.vocab_size):
            raise AssertionError(f"request {i}: logits not finite or of shape {got.shape}")
        seq = np.concatenate([prompt[0], np.asarray(toks[:-1], np.int32)])[None]
        n = prompt.shape[1]
        truth = reference_logits(cfg, engine, seq, torch.float32)[n - 1:].cpu().numpy()
        plain = reference_logits(cfg, engine, seq, torch.bfloat16)[n - 1:].cpu().numpy()
        refs.append((truth, plain))
        if not judge(f"request {i}", got, truth, plain):
            raise AssertionError(f"{label} request {i}: engine logits farther from the truth "
                                 f"than bf16")
    if path.control:   # request 0 again, fed the same tokens, its misses left uncorrected
        engine.rescfg = dataclasses.replace(engine.rescfg, host_compute_misses=False)
        prompt, toks = runs[0][0], runs[0][1]
        rows_ctl = [engine.prefill(prompt)[0]]
        for tok in toks[:-1]:
            forced = np.zeros((1, cfg.vocab_size), np.float32)
            forced[0, tok] = 1.0                   # decode takes the argmax: this token
            engine.decode(forced, 1)
            rows_ctl.append(engine.last_logits[0])
        if judge("control (request 0, misses uncorrected)", np.stack(rows_ctl), *refs[0]):
            raise AssertionError(f"{label}: the logit check passed an engine that drops its "
                                 f"misses")
    summary = dict(
        label=label, counts=counts, symbols=symbols, tokens=[r[1] for r in runs],
        tok_s=[new / sum(r[4]) for r in runs],
        steady_tok_s=[(new - r[5][0]) / sum(r[4][1:]) for r in runs],
        median_ms=[1e3 * float(np.median(r[4][1:])) for r in runs], unit=unit,
        prefill_ms=[1e3 * r[3] for r in runs],
        steps=dec["steps"], replayed=st.replayed_steps, relaunched=st.relaunched_steps,
        mb_per_token=mb_per_token, peak_gib=peak / 2**30, host_convert_s=st.host_dequant_s,
        host_converted=st.host_dequant_experts, misses=st.misses, loads=loads,
        replays=engine.graph_replays, prefetch_launched=st.prefetch_launched,
        prefetch_hits=st.prefetch_hits, overlap_ms=st.overlap_ms, copy_ms=copy_ms,
        overlapped_pulls=st.overlapped_pulls, windows=st.spec_windows,
        accept_rate=st.accept_rate if st.spec_windows else None,
        prompts=prompts, prefill_logits=[p[0] for p in pre],
        prefill_chunks=st.prefill_chunks, prefill_replays=st.prefill_replays, trace=traced)
    if path.same_prompt:
        if any(r[1] != runs[0][1] for r in runs):
            raise AssertionError(f"{label}: the same request sampled twice gave other tokens: "
                                 f"{[r[1][:8] for r in runs]}")
        log(f"  the same request run {requests} times: the same {new} tokens each time")
    if path.prefill_twin or any(p.prefill_twin == label for p in PATHS):
        # the fused step and the hot walk rotate otherwise while they decode,
        # so a later prompt of the run meets other slots: each later prompt
        # is prefilled again from the warm start, on a fresh engine
        warm = [summary["prefill_logits"][0]]
        for prompt in prompts[1:]:
            params = init_params(cfg, 0, dev, expert_device="cpu")
            fresh = make_engine(dev, cfg, params, path)
            del params
            warm.append(fresh.prefill(prompt))
            del fresh
            gc.collect()
        summary["warm_prefill_logits"] = warm
    if path.prefill_twin:
        twin = done[path.prefill_twin]
        for i, (a, b) in enumerate(zip(summary["warm_prefill_logits"],
                                       twin["warm_prefill_logits"])):
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"{label} request {i}: prefill logits from the warm start "
                                     f"differ from {path.prefill_twin}'s (max "
                                     f"{np.abs(a - b).max()})")
        log(f"  every prompt's prefill logits from the warm start "
            f"({' / '.join(str(p.shape[1]) for p in prompts)} tokens; the later ones on fresh "
            f"engines) equal {path.prefill_twin}'s bit for bit")
    if path.baseline and path.sample:          # sampled: the same draws, token for token
        base = done[path.baseline]
        for i, toks in enumerate(summary["tokens"]):
            if toks != base["tokens"][i][:len(toks)]:
                raise AssertionError(f"{label} request {i}: sampled stream {toks[:8]} differs "
                                     f"from {path.baseline}'s {base['tokens'][i][:8]}")
        log(f"  sampled streams equal {path.baseline}'s token for token")
    elif path.baseline:
        base = done[path.baseline]
        if path.prefetch and not spec and not path.chunk:
            share, base_share = st.replayed_steps / dec["steps"], base["replayed"] / base["steps"]
            log(f"  against {path.baseline} in this run: replayed {st.replayed_steps}/"
                f"{dec['steps']} steps against {base['replayed']}/{base['steps']}, relaunched "
                f"{st.relaunched_steps}")
            if st.relaunched_steps <= 0 or share >= base_share:
                raise AssertionError(f"{label}: {st.relaunched_steps} relaunches, replayed share "
                                     f"{share:.3f} not below {path.baseline}'s {base_share:.3f}")
        for i, (toks, (truth, plain)) in enumerate(zip(summary["tokens"], refs)):
            if i >= len(base["prompts"]) or not np.array_equal(prompts[i], base["prompts"][i]):
                log(f"  request {i}: {path.baseline} served no such prompt; held to the truth "
                    f"only")
                continue
            ref_toks = base["tokens"][i][:len(toks)]
            differ = [j for j, (a, b) in enumerate(zip(toks, ref_toks)) if a != b]
            sure = sure_positions(truth, plain)
            log(f"  request {i}: greedy ids equal {path.baseline}'s at "
                f"{differ[0] if differ else len(toks)}/{len(toks)} positions before the first "
                f"difference")
            if differ and sure[differ[0]]:
                raise AssertionError(f"{label} request {i}: greedy id {toks[differ[0]]} at "
                                     f"position {differ[0]} differs from {path.baseline}'s "
                                     f"{ref_toks[differ[0]]} where the truth's margin is sure")
    del engine, refs, runs
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phases 4 and 5 for the serving engine (continuous batching, paged KV)
# ---------------------------------------------------------------------------
SERVE_REQUESTS, SERVE_NEW, SERVE_ROWS, SPEC_CAP = 8, 32, 4, 4
SERVE_LENS = (64, 512)                 # prompt lengths drawn in this range from the run's seed


class ServeSpec(NamedTuple):
    label: str
    quantization: Optional[str]
    slots: int                          # 0: full residency
    prefetch: bool
    sample: Optional[Tuple[float, int, float, int]] = None
    isolated: bool = False              # each request also served alone: the same tokens
    baseline: Optional[str] = None      # tokens and residency transitions equal this path's
    arch: Optional[str] = None          # another arch at all its layers (default: qwen36's cut)
    paged: Optional[bool] = None        # False: the group tick (None: the engine's choice)
    cache: int = CACHE
    long_prompt: int = 0                # then one request of this many prompt tokens


SERVE_PATHS = (
    ServeSpec("serve-full", None, 0, False, isolated=True),
    ServeSpec("serve-bf16", None, SLOTS, False),
    ServeSpec("serve-int4", "int4", SLOTS, False),
    ServeSpec("serve-int4-prefetch", "int4", SLOTS, True, baseline="serve-int4"),
    ServeSpec("serve-sample", None, 0, False, sample=SAMPLE, isolated=True),
    ServeSpec("serve-full-group", None, 0, False, baseline="serve-full", paged=False),
    ServeSpec("serve-qwen3-4b", None, 0, False, isolated=True, arch="qwen3-4b"),
    ServeSpec("serve-starcoder2-7b", None, 0, False, isolated=True, arch="starcoder2-7b"),
    ServeSpec("serve-phi3-mini", None, 0, False, isolated=True, arch="phi3-mini-3.8b"),
    ServeSpec("serve-recurrentgemma-2b", None, 0, False, isolated=True, arch="recurrentgemma-2b",
              cache=RG_CACHE, long_prompt=RG_LONG),
)


def make_server(dev, cfg, params, spec: ServeSpec, trace=None):
    """The path's ``ServingEngine``: 4 rows, the path's cache_len, pages of
    PAGE (paged), speculative windows up to SPEC_CAP (KV-only stacks),
    traced by ``trace`` if given."""
    from repro_torch.config import ResidencyConfig
    from repro_torch.models.transformer import Runtime
    from repro_torch.serving import SamplerConfig, ServingEngine

    res = None
    if spec.slots:
        res = ResidencyConfig(mode="rotary", num_slots=spec.slots,
                              quantization=spec.quantization, quant_group_size=GROUP)
    smp = None
    if spec.sample:
        t, k, p, seed = spec.sample
        smp = SamplerConfig(temperature=t, top_k=k, top_p=p, seed=seed)
    return ServingEngine(cfg, params, rt=Runtime(cache_len=spec.cache), num_slots=SERVE_ROWS,
                         residency=res, sampler=smp, spec_cap=SPEC_CAP, paged=spec.paged,
                         kv_page_size=PAGE, prefetch=spec.prefetch, trace=trace, device=dev)


class _Weights(NamedTuple):
    """What ``reference_rows`` reads of an engine: the serving engine's float
    experts per layer (on the card at full residency, the pinned warehouse
    else, the float store its prefill reads under quantized slots)."""
    device: object
    embed_params: dict
    layers: list
    host_experts: list


def serve_weights(engine) -> _Weights:
    if engine.res_mgr is None:
        experts = [p["moe"]["experts"] for p in engine.layers if "moe" in p]
    else:
        experts = engine._float_experts or engine.host_experts
    return _Weights(engine.device, engine.embed_params, engine.layers, experts)


def run_serve_path(dev, cfg, depth, spec: ServeSpec, done: dict) -> dict:
    """Phases 4 and 5 for one serving path: eight requests of mixed prompt
    lengths submitted at once to a ServingEngine, after ``warmup`` captured
    its graphs; the launch counters zeroed just before ``run`` and read just
    after. Holds every request's first-token logits (its admission prefill)
    to the f32 truth, and, as the path asks, each request's tokens to the
    same request served alone (bitwise: a row's bits do not depend on what
    else is live), a sampled run to a second one, or the tokens and
    transitions to a baseline path. ``long_prompt``: then one request of
    that many prompt tokens alone, its first-token and decode logits and
    greedy ids held to the truth."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import Tracer

    label = spec.label
    if cfg.has_moe:
        experts = cfg.moe.num_experts
        where = (f"rotary residency {spec.slots}/{experts} slots" if spec.slots
                 else f"all {experts} experts resident")
    else:
        where = "no MoE layer, every weight on the card"
    how = ("sampled (temperature %s, top-k %s, top-p %s)" % spec.sample[:3] if spec.sample
           else "greedy")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, dev, expert_device="cpu")
    tracer = Tracer()
    engine = make_server(dev, cfg, params, spec, trace=tracer)
    del params
    setup_s = time.perf_counter() - t0
    tick = (f"pages of {PAGE}" if engine._paged else
            "the group tick (a fixed contiguous batch)")
    log(f"[4/{label}] ServingEngine, {cfg.name} at published widths, {cfg.num_layers} of {depth} "
        f"layers, {where} in {spec.quantization or 'bf16'}, {SERVE_ROWS} rows, {tick}, "
        f"windows up to {engine._spec_cap_eff}, {'prefetch, ' if spec.prefetch else ''}{how}, "
        f"{SERVE_REQUESTS} requests submitted at once, {SERVE_NEW} new tokens each, cache_len "
        f"{spec.cache}")
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_LENS[0], SERVE_LENS[1] + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    seeds = [100 + i for i in range(SERVE_REQUESTS)] if spec.sample else [None] * SERVE_REQUESTS
    t0 = time.perf_counter()
    graphs = engine.warmup()
    warm_s = time.perf_counter() - t0
    log(f"  set-up {setup_s:.1f} s; warmup captured {graphs} graphs in "
        f"{warm_s * 1e3:.0f} ms ({engine.graph_capture_s * 1e3:.0f} ms in the captures); prompt "
        f"lengths {lens.tolist()}")
    first = {}
    prefill = engine._prefill_admitted

    def record(admitted):
        out = prefill(admitted)
        for req, logits, _ in out:
            first[req.uid] = logits[0]
        return out

    def serve(batch, prompt_of=prompts.__getitem__):
        reqs = [engine.submit(prompt_of(i), SERVE_NEW, seed=seeds[i]) for i in batch]
        engine.run()
        return [r.output for r in reqs], reqs

    st = engine.stats
    engine._prefill_admitted = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bytes0, captures0 = st.bytes_uploaded, engine.graph_captures
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, reqs = serve(range(SERVE_REQUESTS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace, overlap_ms = tracer.chrome_trace(), st.overlap_ms
    counts = ops.launch_counts()
    symbols = ops.symbol_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    summ = engine.summary()
    committed = SERVE_REQUESTS * SERVE_NEW
    layers = st.layers.values()
    transitions = dict(loads=sum(l.loads for l in layers), hits=st.hits, misses=st.misses,
                       forward=sum(l.forward_rotations for l in layers),
                       reverse=sum(l.reverse_rotations for l in layers))
    mb_per_token = (st.bytes_uploaded - bytes0) / 2**20 / committed
    window_ms = engine.metrics.histogram("window_ms", "").percentile(50)
    pages = (f"pages high-water {st.kv_pages_hwm} of {engine.pool.num_pages}" if engine._paged
             else "no pages (contiguous batch)")
    log(f"  {committed} tokens in {wall:.2f} s: {committed / wall:.1f} tok/s aggregate; TTFT "
        f"p50 {summ['ttft_p50_ms']:.1f} / p99 {summ['ttft_p99_ms']:.1f} ms, ITL p50 "
        f"{summ['itl_p50_ms']:.2f} / p99 {summ['itl_p99_ms']:.2f} ms; windows {st.windows} "
        f"(spec {st.spec_windows}, accept rate {st.accept_rate:.3f}), decode launches "
        f"{st.steps} steps, median tick {window_ms:.2f} ms, misses {st.misses} "
        f"({st.misses / committed:.3f} per token), {pages}, {mb_per_token:.2f} MB uploaded per "
        f"token, transitions {transitions}, peak device memory {peak / 2**30:.2f} GiB; graph "
        f"replays {engine.graph_replays}")
    if spec.prefetch:
        log(f"  prefetch: launched {st.prefetch_launched} uploads, hits {st.prefetch_hits}, "
            f"wasted {st.prefetch_wasted_bytes / 2**20:.1f} MB, overlap_ms {st.overlap_ms:.1f}")
    log(f"  kernel launches: {counts}; by entry: "
        f"{ {n: symbols[n] for n in ('decode_attention', 'topk_gate') if symbols.get(n)} }")
    paged = entry_launches(symbols, "decode_attention_paged")
    contiguous = entry_launches(symbols, "decode_attention")
    fused = entry_launches(symbols, "router_topk")
    gemv = "slot_gmm" if not spec.quantization else f"slot_gmm_{spec.quantization}"
    if cfg.has_moe:
        moe_ok = (fused == counts["topk_gate"] > 0 and counts[gemv] > 0
                  and entry_launches(symbols, "slot_gmm_ragged") > 0)
    else:                  # no MoE kernel, nothing misses, every draft accepted
        moe_ok = (not any(n for name, n in counts.items() if name.startswith(("slot_gmm",
                                                                              "topk_gate")))
                  and st.misses == 0 and st.accepted_tokens == st.drafted_tokens
                  and (st.drafted_tokens > 0) == engine._spec_ok)
    if engine._paged:      # K2's paged entry only, and every page returned
        kv_ok = (st.windows > 0 and paged > 0 and contiguous == 0
                 and st.kv_pages_released == st.kv_pages_allocated > 0)
    else:                  # the group tick: K2's contiguous entry over the fixed batch
        kv_ok = st.steps > 0 and contiguous > 0 and paged == 0
    ok = (engine.graph_captures == captures0 and moe_ok and kv_ok
          and counts["flash_attention"] > 0 and counts["flash_attention_chunk"] == 0
          and all(len(t) == SERVE_NEW for t in tokens))
    if not ok:
        raise AssertionError(f"{label}: windows {st.windows}, steps {st.steps}, captures "
                             f"{engine.graph_captures} (warmup {captures0}), K2 paged {paged} "
                             f"contiguous {contiguous}, launches {counts}, tokens per request "
                             f"{[len(t) for t in tokens]}, pages "
                             f"{st.kv_pages_allocated}/{st.kv_pages_released}")
    traced = audit_path(label, tracer, trace, overlap_ms,
                        st.windows if engine._paged else st.sync_pulls, prefetch=spec.prefetch,
                        paged=engine._paged, uids=[r.uid for r in reqs])
    if label == "serve-full":
        control_flagged(label, plant_use_after_release(trace),
                        "a kv_use moved past its pages' kv_release", "after release")

    log(f"[5/{label}] first-token logits (the admission prefill) vs the plain full-residency "
        f"forward on the card")
    weights = serve_weights(engine)
    width = int(lens.max()) + SERVE_NEW - 1
    seqs = np.zeros((SERVE_REQUESTS, width), np.int32)
    for i, (p, t) in enumerate(zip(prompts, tokens)):
        seqs[i, :len(p) + SERVE_NEW - 1] = np.concatenate([p, np.asarray(t[:-1], np.int32)])
    span = SERVE_NEW if spec.isolated else 1          # positions whose truth is needed
    rows = [list(range(n - 1, n - 1 + span)) for n in lens]
    truth = reference_rows(cfg, weights, seqs, rows, torch.float32).cpu().numpy()
    plain = reference_rows(cfg, weights, seqs, rows, torch.bfloat16).cpu().numpy()
    got = np.stack([first[r.uid] for r in reqs])
    if not judge(f"{SERVE_REQUESTS} requests' first tokens", got, truth[:, 0], plain[:, 0]):
        raise AssertionError(f"{label}: first-token logits farther from the truth than bf16")
    if spec.isolated and not spec.sample:        # miss-free greedy: the decode is exact too
        checked = agree = 0
        for i in range(SERVE_REQUESTS):
            sure = sure_positions(truth[i], plain[i])
            wrong = [j for j in range(SERVE_NEW)
                     if sure[j] and tokens[i][j] != truth[i, j].argmax()]
            if wrong:
                raise AssertionError(f"{label} request {i}: greedy id differs from the truth's at "
                                     f"sure positions {wrong}")
            checked += int(sure.sum())
            agree += sum(int(t == truth[i, j].argmax()) for j, t in enumerate(tokens[i]))
        log(f"  greedy ids equal the truth's at all {checked} positions whose margin is sure, at "
            f"{agree}/{SERVE_REQUESTS * SERVE_NEW} in all")
    del truth, plain
    summary = dict(
        label=label, counts=counts, symbols=symbols, tokens=tokens, tok_s=committed / wall,
        ttft=(summ["ttft_p50_ms"], summ["ttft_p99_ms"]),
        itl=(summ["itl_p50_ms"], summ["itl_p99_ms"]),
        windows=st.windows, spec_windows=st.spec_windows, accept_rate=st.accept_rate,
        misses_per_token=st.misses / committed, hwm=st.kv_pages_hwm, mb_per_token=mb_per_token,
        peak_gib=peak / 2**30, capture_ms=engine.graph_capture_s * 1e3, graphs=graphs,
        transitions=transitions, tick_ms=window_ms, trace=traced)
    if spec.isolated:
        # a row's logits and draws do not depend on the other live rows: each
        # request alone must give its concurrent stream bit for bit
        for i in range(SERVE_REQUESTS):
            alone = serve([i])[0][0]
            j = next((j for j, (a, b) in enumerate(zip(alone, tokens[i])) if a != b), None)
            if j is not None:
                raise AssertionError(f"{label} request {i}: served alone it differs from the "
                                     f"concurrent stream first at token {j} ({alone[j]} vs "
                                     f"{tokens[i][j]})")
        summary["isolated_differ"] = 0
        log(f"  each request served alone: {SERVE_REQUESTS}/{SERVE_REQUESTS} streams bitwise the "
            f"concurrent ones")
    if spec.sample:
        again = serve(range(SERVE_REQUESTS))[0]
        if again != tokens:
            raise AssertionError(f"{label}: a second concurrent run drew other tokens")
        log(f"  a second concurrent run reproduced all {SERVE_REQUESTS} streams")
    if spec.baseline:
        base = done[spec.baseline]
        if tokens != base["tokens"] or transitions != base["transitions"]:
            raise AssertionError(f"{label}: tokens or transitions differ from {spec.baseline}'s "
                                 f"({transitions} against {base['transitions']})")
        log(f"  tokens and residency transitions equal {spec.baseline}'s ({transitions})")
    if spec.long_prompt:
        summary["long"] = serve_long(engine, cfg, weights, serve, first, spec)
        for name, n in summary["long"].pop("counts").items():     # its launches are the path's
            counts[name] += n
        for name, syms in summary["long"].pop("symbols").items():
            for sym, n in syms.items():
                symbols.setdefault(name, {})[sym] = symbols.get(name, {}).get(sym, 0) + n
    del engine._prefill_admitted
    del engine, weights
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return summary


def serve_long(engine, cfg, weights, serve, first, spec: ServeSpec) -> dict:
    """One request of ``spec.long_prompt`` tokens + SERVE_NEW alone on the
    path's engine (recurrentgemma: the prompt outgrows the window, so K4
    skips the KV tiles behind the band and the ring cache wraps): its
    first-token logits against the truth and its greedy ids against the
    truth's at every sure position. Its kernel launches, counted from zero
    around it, are returned with it (K4 once per attention layer)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    n = spec.long_prompt
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, n).astype(np.int32)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, reqs = serve([0], lambda _: prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, symbols = ops.launch_counts(), ops.symbol_launch_counts()
    attn_layers = sum(k == "local_attn" for k in cfg.layer_kinds)
    if counts["flash_attention"] != attn_layers:
        raise AssertionError(f"{spec.label}: the long request launched K4 "
                             f"{counts['flash_attention']} times, not once per attention layer")
    toks = out[0]
    ttft = (reqs[0].first_token_at - reqs[0].submitted_at) * 1e3
    decode_s = reqs[0].finished_at - reqs[0].first_token_at
    log(f"  one request of {n} prompt tokens + {SERVE_NEW}: {wall:.2f} s, TTFT {ttft:.1f} ms, "
        f"decode {(SERVE_NEW - 1) / decode_s:.1f} tok/s after the first token; launches {counts}")
    seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])[None]
    rows = [list(range(n - 1, n - 1 + SERVE_NEW))]
    truth = reference_rows(cfg, weights, seq, rows, torch.float32)[0].cpu().numpy()
    plain = reference_rows(cfg, weights, seq, rows, torch.bfloat16)[0].cpu().numpy()
    got = first[reqs[0].uid][None]
    if not judge(f"the {n}-token request's first token", got, truth[:1], plain[:1]):
        raise AssertionError(f"{spec.label}: the long request's first-token logits are farther "
                             f"from the truth than bf16")
    sure = sure_positions(truth, plain)
    wrong = [j for j in range(SERVE_NEW) if sure[j] and toks[j] != truth[j].argmax()]
    if wrong:
        raise AssertionError(f"{spec.label}: the long request's greedy ids differ from the "
                             f"truth's at sure positions {wrong}")
    log(f"  its greedy ids equal the truth's at all {int(sure.sum())} sure positions, at "
        f"{sum(int(t == truth[j].argmax()) for j, t in enumerate(toks))}/{SERVE_NEW} in all")
    return dict(prompt=n, wall_s=wall, ttft_ms=ttft, decode_tok_s=(SERVE_NEW - 1) / decode_s,
                counts=counts, symbols=symbols)


# ---------------------------------------------------------------------------
# phases 4 and 5 for the frontend archs: prefill_model(frontend=) + decode_model
# ---------------------------------------------------------------------------
class FrontSpec(NamedTuple):
    label: str
    arch: str
    layers: int                 # the first N layers (the depth cut; 0: all)
    frontend_len: int           # embeddings from the seed before the prompt
    prompt: int
    cache: int


FRONT_NEW = 32
DBRX_LAYERS = 2
DBRX_PATH = PathSpec("dbrx-int4", "int4", 12, False, 1, 32, False, None, quant_check=1)
FRONT_PATHS = (
    FrontSpec("pixtral-frontend", "pixtral-12b", 16, 1024, 512, 2048),
    FrontSpec("musicgen-frontend", "musicgen-large", 0, 256, 256, CACHE),
)


def run_frontend_path(dev, cfg, depth: int, spec: FrontSpec) -> dict:
    """Phases 4 and 5 for a frontend arch through the model's own entry
    points: ``prefill_model`` with ``frontend_len`` embeddings drawn from the
    run's seed (N(0, 0.02), as the token embeddings are made) before a
    prompt of ``prompt`` tokens, then FRONT_NEW greedy ``decode_model``
    steps (K2's contiguous entry), each pulled to the host. Holds the
    first-token and every decode logits to the f32 truth of the same
    weights and sequence, and the greedy ids to the truth's at every sure
    position."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    layers = cfg.num_layers
    a = cfg.attention
    log(f"[4/{spec.label}] {cfg.name} at published widths, {layers} of {depth} layers "
        f"(dense, dh {a.head_dim}, {a.num_heads}/{a.num_kv_heads} heads), bf16: prefill_model "
        f"with {spec.frontend_len} {cfg.frontend} embeddings + {spec.prompt} tokens, then "
        f"{FRONT_NEW} greedy decode_model steps, cache_len {spec.cache}")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fe = (torch.randn((1, spec.frontend_len, cfg.frontend_dim), generator=gen, device=dev)
          * 0.02).to(tfm.torch_dtype(cfg))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (1, spec.prompt)).astype(np.int64)
    tokens = torch.from_numpy(prompt).to(dev)
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    torch.cuda.synchronize()
    log(f"  set-up {time.perf_counter() - t0:.1f} s; weights {weight_gb:.2f} GB on the card")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, state = tfm.prefill_model(cfg, params, tokens, spec.cache, frontend=fe)
    first = logits.float().cpu().numpy()
    prefill_s = time.perf_counter() - t0
    got, toks, step_s = [first[0]], [int(first.argmax())], []
    cur = spec.frontend_len + spec.prompt
    for j in range(FRONT_NEW - 1):
        t0 = time.perf_counter()
        lg, _ = tfm.decode_model(cfg, params, torch.tensor([toks[-1]], device=dev), state, cur + j)
        row = lg.float().cpu().numpy()[0]
        step_s.append(time.perf_counter() - t0)
        got.append(row)
        toks.append(int(row.argmax()))
    counts = ops.launch_counts()
    symbols = ops.symbol_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tok_s = (FRONT_NEW - 1) / sum(step_s)
    log(f"  prefill {prefill_s * 1e3:.1f} ms ({spec.frontend_len + spec.prompt} positions), decode "
        f"{tok_s:.2f} tok/s (median step {np.median(step_s) * 1e3:.2f} ms over {len(step_s)} "
        f"steps), first tokens {toks[:8]}, peak device memory {peak / 2**30:.2f} GiB")
    log(f"  kernel launches: {counts}")
    if (counts["flash_attention"] != layers or entry_launches(symbols, "decode_attention")
            != layers * (FRONT_NEW - 1) or entry_launches(symbols, "decode_attention_paged")
            or any(n for name, n in counts.items() if name.startswith(("slot_gmm", "topk_gate")))):
        raise AssertionError(f"{spec.label}: launches {counts}, by entry {symbols}")

    log(f"[5/{spec.label}] prefill and decode logits vs the plain forward on the card")
    weights = _Weights(dev, {k: v for k, v in params.items() if k != "layers"},
                       params["layers"], [])
    seq = np.concatenate([prompt[0], np.asarray(toks[:-1])])[None]
    rows = [list(range(cur - 1, cur - 1 + FRONT_NEW))]
    truth = reference_rows(cfg, weights, seq, rows, torch.float32, frontend=fe)[0].cpu().numpy()
    plain = reference_rows(cfg, weights, seq, rows, torch.bfloat16, frontend=fe)[0].cpu().numpy()
    got = np.stack(got)
    if not np.isfinite(got).all() or got.shape != (FRONT_NEW, cfg.vocab_size):
        raise AssertionError(f"{spec.label}: logits not finite or of shape {got.shape}")
    if not judge(f"{spec.label} prefill + {FRONT_NEW - 1} decode steps", got, truth, plain):
        raise AssertionError(f"{spec.label}: logits farther from the truth than bf16")
    summary = dict(label=spec.label, frontend=True, counts=counts, symbols=symbols,
                   prefill_ms=prefill_s * 1e3,
                   tok_s=tok_s, median_ms=float(np.median(step_s)) * 1e3, peak_gib=peak / 2**30,
                   layers=layers)
    del params, state, weights, fe
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return summary


class DecodeSpec(NamedTuple):
    label: str
    arch: str
    rows: int
    prompt: int
    cache: int


DECODE_PATHS = (DecodeSpec("decode-xlstm-350m", "xlstm-350m", 4, PROMPT, CACHE),)


def _greedy(cfg, params, tokens, cache, new, rows=None):
    """``prefill_model`` over ``tokens`` [B, S] into a state of ``rows`` rows
    (default B; the rest empty), then ``new - 1`` greedy ``decode_model``
    steps, each pulled to the host. Returns (ids [B, new], logits [B, new,
    V] f32, prefill s, decode step s)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = tfm.prefill_model(cfg, params, tokens, cache, rows=rows)
    rows = [logits.float().cpu().numpy()]
    prefill_s = time.perf_counter() - t0
    step_s = []
    for j in range(new - 1):
        t0 = time.perf_counter()
        lg, _ = tfm.decode_model(cfg, params, torch.from_numpy(rows[-1].argmax(-1)).to(tokens.device),
                                 state, tokens.shape[1] + j)
        rows.append(lg.float().cpu().numpy())
        step_s.append(time.perf_counter() - t0)
    got = np.stack(rows, 1)
    return got.argmax(-1), got, prefill_s, step_s


def run_decode_path(dev, cfg, spec: DecodeSpec) -> dict:
    """Phases 4 and 5 for an arch without attention (xLSTM: the reference
    cannot serve it, its path is ``prefill_model`` + ``decode_model``):
    ``rows`` prompts of ``prompt`` tokens prefilled in one call, then
    FRONT_NEW - 1 greedy ``decode_model`` steps; every row's prefill and
    decode logits against the f32 truth of the same weights and tokens, its
    greedy ids against the truth's at every sure position, and each row
    run alone inside the batch's allocation (``prefill_model(rows=)``, the
    other rows empty) against the batch's logits, bit for bit."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    log(f"[4/{spec.label}] {cfg.name} at published widths, all {cfg.num_layers} layers "
        f"({'/'.join(sorted(set(cfg.layer_kinds)))}, no attention), bf16: prefill_model of "
        f"{spec.rows} rows of {spec.prompt} tokens, then {FRONT_NEW - 1} greedy decode_model "
        f"steps")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, dev)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (spec.rows, spec.prompt))
    tokens = torch.from_numpy(prompt).to(dev)
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    torch.cuda.synchronize()
    log(f"  set-up {time.perf_counter() - t0:.1f} s; weights {weight_gb:.2f} GB on the card")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ids, got, prefill_s, step_s = _greedy(cfg, params, tokens, spec.cache, FRONT_NEW)
    counts = ops.launch_counts()
    symbols = ops.symbol_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tok_s = spec.rows * (FRONT_NEW - 1) / sum(step_s)
    log(f"  prefill {prefill_s * 1e3:.1f} ms ({spec.rows} x {spec.prompt} positions), decode "
        f"{tok_s:.2f} tok/s over the rows (median step {np.median(step_s) * 1e3:.2f} ms), peak "
        f"device memory {peak / 2**30:.2f} GiB; kernel launches {counts} (the cells are plain "
        f"PyTorch, as the reference's are jnp)")
    if any(counts.values()):
        raise AssertionError(f"{spec.label}: a kernel launched on a stack without attention or "
                             f"MoE: {counts}")
    log(f"[5/{spec.label}] prefill and decode logits vs the plain forward on the card")
    weights = _Weights(dev, {k: v for k, v in params.items() if k != "layers"},
                       params["layers"], [])
    seqs = np.concatenate([prompt, ids[:, :-1]], axis=1)
    rows = [list(range(spec.prompt - 1, spec.prompt - 1 + FRONT_NEW))] * spec.rows
    truth = reference_rows(cfg, weights, seqs, rows, torch.float32).cpu().numpy()
    plain = reference_rows(cfg, weights, seqs, rows, torch.bfloat16).cpu().numpy()
    if not np.isfinite(got).all() or got.shape != (spec.rows, FRONT_NEW, cfg.vocab_size):
        raise AssertionError(f"{spec.label}: logits not finite or of shape {got.shape}")
    flat = (spec.rows * FRONT_NEW, cfg.vocab_size)
    if not judge(f"{spec.label} {spec.rows} rows x (prefill + {FRONT_NEW - 1} decode steps)",
                 got.reshape(flat), truth.reshape(flat), plain.reshape(flat)):
        raise AssertionError(f"{spec.label}: logits farther from the truth than bf16")
    # each row alone inside the batch's allocation (the other rows empty):
    # eager decode_model runs every matmul at the state's row count, so the
    # row's logits are the batch's, bit for bit
    parted = 0
    for i in range(spec.rows):
        a_ids, a_logits, _, _ = _greedy(cfg, params, tokens[i:i + 1], spec.cache, FRONT_NEW,
                                        rows=spec.rows)
        if not (np.array_equal(a_ids[0], ids[i]) and np.array_equal(a_logits[0], got[i])):
            j = next((j for j in range(FRONT_NEW) if not np.array_equal(a_logits[0, j],
                                                                       got[i, j])), None)
            log(f"  row {i} alone parts from the batch at position {j}")
            parted += 1
    log(f"  each row alone in the batch's allocation: {spec.rows - parted}/{spec.rows} rows' "
        f"logits bitwise the batch's")
    if parted:
        raise AssertionError(f"{spec.label}: {parted} rows alone differ from the batch")
    summary = dict(label=spec.label, frontend=True, counts=counts, symbols=symbols,
                   prefill_ms=prefill_s * 1e3, tok_s=tok_s,
                   median_ms=float(np.median(step_s)) * 1e3, peak_gib=peak / 2**30,
                   layers=cfg.num_layers, parted=parted)
    del params, weights
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return summary


class TrainSpec(NamedTuple):
    label: str
    arch: str
    layers: int                 # the first N units (the depth cut; 0: all)
    batch: int
    seq: int
    steps: int                  # the straight run; the resume check runs half of it twice


TRAIN_PATHS = (
    TrainSpec("train-qwen36", "qwen36-35b-a3b", 4, 4, 512, 12),
    TrainSpec("train-recurrentgemma-2b", "recurrentgemma-2b", 0, 4, 512, 12),
)
TRAIN_LR = dict(learning_rate=3e-4, warmup_steps=2, total_steps=12)
# Step 0 against f32 (tools/torch_train_tolerance.py reads sound runs and planted bf16 faults)
TRAIN_LOSS_TOL = 0.002          # |bf16 step-0 loss - f32|, nats
TRAIN_GNORM_TOL = 0.01          # |bf16 step-0 grad norm / f32 - 1|
H100_BF16_FLOPS = 989e12


def _train_steps(cfg, rt, run, state, spec, dev, first: int, last: int):
    """Steps ``first`` .. ``last - 1`` of the topic stream through the port's
    loader and train step; returns (state, losses, grad norms, step s)."""
    import torch

    from repro_torch.data import Loader
    from repro_torch.training import make_train_step

    step_fn = make_train_step(cfg, rt, run)
    losses, gnorms, times = [], [], []
    with Loader(spec, dev, start_step=first) as loader:
        for _ in range(first, last):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, tokens, labels = next(loader)
            state, m = step_fn(state, tokens, labels)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return state, losses, gnorms, times


def train_step0_vs_f32(cfg, params, tokens, labels, rt, frontend=None) -> dict:
    """One bf16 ``lm_loss`` and its gradients, then the same in f32: the
    weights upcast, the bf16 forward's top-k choice replayed (so the same
    assignments drop). Returns the two losses and gradient norms and the
    share of assignments dropped a MoE layer; ``params`` are left marked to
    take gradients."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.training import global_norm
    from repro_torch.tree import leaves, map_tree

    for p in leaves(params):
        p.requires_grad_(True)
    routes = [moe_mod.Routing() for _ in range(cfg.num_moe_layers)]
    loss, aux = tfm.lm_loss(cfg, params, tokens, labels, rt, frontend, routes=routes)
    gnorm = float(global_norm(torch.autograd.grad(loss, leaves(params))))
    dropped = (float(aux["moe_dropped_frac"]) / cfg.num_moe_layers
               if "moe_dropped_frac" in aux else 0.0)
    p32 = map_tree(lambda t: t.detach().float().requires_grad_(True), params)
    loss32, _ = tfm.lm_loss(dataclasses.replace(cfg, dtype="float32"), p32, tokens, labels, rt,
                            frontend, routes=[moe_mod.Routing(r.ids, replay=True)
                                              for r in routes])
    gnorm32 = float(global_norm(torch.autograd.grad(loss32, leaves(p32))))
    return dict(loss=float(loss.detach()), loss32=float(loss32.detach()), gnorm=gnorm,
                gnorm32=gnorm32, dropped=dropped)


def run_train_path(dev, cfg, depth: int, spec: TrainSpec) -> dict:
    """The training path (``lm_loss`` -> autograd -> AdamW, the reference's
    ``make_train_step``) at published widths in bf16, batch x seq tokens of
    the ``topic`` stream a step, ``dots_saveable`` remat, MoE layers through
    the sorted dispatch at capacity factor 1.25 (assignments dropped):

    * step 0's loss and grad norm against an f32 recomputation on the card
      (the weights upcast, the bf16 forward's routing replayed, so the same
      assignments drop);
    * ``steps`` straight steps (a checkpoint saved after half of them): the
      last loss below the first;
    * half the steps again from the seed: the parameters bitwise those of
      the straight run at that point;
    * a restore of the checkpoint into a fresh state and the other half:
      the parameters bitwise the straight run's at its end;
    * no kernel launch on the path (none has a backward).
    Prints median step ms (the steps before the checkpoint, step 0's
    warm-up left out, and apart the steps its write thread overlaps),
    tokens/s, MFU (``model_flops`` over 989 TFLOP/s), peak GiB, and the
    checkpoint's save / write / restore ms and MB."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import analytic_params, model_flops
    from repro_torch.training import init_train_state
    from repro_torch.tree import leaves

    half = spec.steps // 2
    moe_note = (f", MoE sorted at capacity factor {cfg.moe.capacity_factor}" if cfg.has_moe
                else "")
    log(f"[4/{spec.label}] {cfg.name} at published widths, {cfg.num_layers} of {depth} layers, "
        f"bf16, {analytic_params(cfg) / 1e9:.2f} B parameters; {spec.batch} x {spec.seq} "
        f"topic tokens a step, dots_saveable{moe_note}: {spec.steps} straight steps, "
        f"{half} again from the seed, {spec.steps - half} after a restore")
    rt = tfm.Runtime(sharding=ShardingConfig(remat_policy="dots_saveable", moe_impl="sorted"))
    run = RunConfig(**TRAIN_LR)
    data = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=spec.seq, global_batch=spec.batch,
                         kind="topic", seed=0)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    # step 0 against f32, the bf16 routing replayed
    params = tfm.init_params(cfg, 0, dev)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in batch_at_step(data, 0))
    s0 = train_step0_vs_f32(cfg, params, tokens, labels, rt)
    loss, loss32, gnorm, gnorm32, dropped = (s0[n] for n in ("loss", "loss32", "gnorm",
                                                              "gnorm32", "dropped"))
    log(f"  step 0: loss {loss:.5f} (f32 {loss32:.5f}, |diff| {abs(loss - loss32):.5f}, tolerance "
        f"{TRAIN_LOSS_TOL}), grad norm {gnorm:.5f} (f32 {gnorm32:.5f}, ratio - 1 "
        f"{gnorm / gnorm32 - 1:+.5f}, tolerance {TRAIN_GNORM_TOL}), assignments dropped a layer "
        f"{100 * dropped:.2f}%")
    if not (abs(loss - loss32) <= TRAIN_LOSS_TOL and abs(gnorm / gnorm32 - 1) <= TRAIN_GNORM_TOL):
        raise AssertionError(f"{spec.label}: step 0 parts from its f32 recomputation")
    if cfg.has_moe and dropped <= 0.0:
        raise AssertionError(f"{spec.label}: capacity factor {cfg.moe.capacity_factor} dropped "
                             f"nothing")

    def snapshot(state):           # to the host: the card holds two train states at most
        return [t.detach().cpu() for t in leaves(state["params"])]

    def same(a, b):
        return all(torch.equal(x, y.detach().cpu()) for x, y in zip(a, b))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        mgr = CheckpointManager(ckdir, keep=1, async_save=True)
        # the straight run, a checkpoint after `half` steps
        state = init_train_state(cfg, params)
        state, losses, gnorms, times = _train_steps(cfg, rt, run, state, data, dev, 0, half)
        if losses[0] != loss or gnorms[0] != gnorm:
            raise AssertionError(f"{spec.label}: the train step's step 0 ({losses[0]}, "
                                 f"{gnorms[0]}) is not the recomputed one ({loss}, {gnorm})")
        t0 = time.perf_counter()
        mgr.save(half, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        at_half = snapshot(state)
        state, l2, g2, t2 = _train_steps(cfg, rt, run, state, data, dev, half, spec.steps)
        losses, gnorms, times = losses + l2, gnorms + g2, times + t2
        at_end = snapshot(state)
        del state, params
        gc.collect()
        torch.cuda.empty_cache()
        # the first half again from the seed
        state = init_train_state(cfg, tfm.init_params(cfg, 0, dev))
        state, again, _, _ = _train_steps(cfg, rt, run, state, data, dev, 0, half)
        det = same(at_half, leaves(state["params"])) and again == losses[:half]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mgr.wait()
        write_ms = (time.perf_counter() - t0) * 1e3
        ck_mb = os.path.getsize(os.path.join(mgr.step_dir(half), "arrays.npz")) / 1e6
        # a crash: restore into a fresh state, the second half
        t0 = time.perf_counter()
        step, state, _ = mgr.restore_latest(init_train_state(cfg, tfm.init_params(cfg, 0, dev)))
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        state, resumed, _, _ = _train_steps(cfg, rt, run, state, data, dev, step, spec.steps)
        res = step == half and same(at_end, leaves(state["params"])) and resumed == losses[half:]
        del state, at_half, at_end
    counts = ops.launch_counts()
    symbols = ops.symbol_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the steps before the checkpoint: later ones share the host with its write thread
    med = float(np.median(times[1:half]))
    busy_med = float(np.median(times[half:]))
    tok_s = spec.batch * spec.seq / med
    mfu = model_flops(cfg, spec.batch * spec.seq) / med / H100_BF16_FLOPS
    log(f"  losses {' '.join(f'{x:.4f}' for x in losses)}; grad norms "
        f"{' '.join(f'{x:.3f}' for x in gnorms)}; step ms "
        f"{' '.join(f'{1e3 * x:.1f}' for x in times)}")
    log(f"  median step {med * 1e3:.1f} ms (steps 1-{half - 1}; {busy_med * 1e3:.1f} ms while the "
        f"checkpoint writes), {tok_s:.0f} tokens/s, MFU {100 * mfu:.2f}% (model_flops "
        f"{model_flops(cfg, spec.batch * spec.seq) / 1e12:.2f} TFLOP a step over 989 TFLOP/s), "
        f"peak {peak / 2**30:.2f} GiB; checkpoint {ck_mb:.0f} MB: snapshot {save_ms:.0f} ms on "
        f"the caller's thread, write done {write_ms:.0f} ms after the second run, restore "
        f"{restore_ms:.0f} ms")
    log(f"  first {half} steps again from the seed: parameters bitwise the straight run's: {det}; "
        f"restored at step {step} + {spec.steps - half} steps: bitwise the straight run's: {res}; "
        f"kernel launches {counts}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{spec.label}: the loss did not go down ({losses})")
    if not det:
        raise AssertionError(f"{spec.label}: two runs from one seed differ")
    if not res:
        raise AssertionError(f"{spec.label}: save, restore and resume differ from the straight run")
    if any(counts.values()):
        raise AssertionError(f"{spec.label}: a kernel launched on the training path: {counts}")
    return dict(label=spec.label, train=True, counts=counts, symbols=symbols, median_ms=med * 1e3,
                writing_ms=busy_med * 1e3,
                tok_s=tok_s, mfu=mfu, peak_gib=peak / 2**30, save_ms=save_ms,
                write_ms=write_ms, restore_ms=restore_ms, ckpt_mb=ck_mb, losses=losses,
                loss0=loss, loss0_f32=loss32, gnorm0=gnorm, gnorm0_f32=gnorm32,
                dropped=dropped, layers=cfg.num_layers)


# ---------------------------------------------------------------------------
# the sharded paths: ranks on the card through distributed/world.py
# ---------------------------------------------------------------------------
class DistSpec(NamedTuple):
    label: str
    arch: str
    layers: int                 # the first N units (the depth cut; 0: all)
    mesh: Tuple[int, ...]
    axes: Tuple[str, ...]
    rows: int                   # the global batch
    prompt: int
    steps: int                  # greedy decode steps (EP) or train steps (pod)


DIST_PATHS = (
    DistSpec("ep-qwen36", "qwen36-35b-a3b", LAYERS, (2, 2), ("data", "model"), 4, PROMPT, 16),
    DistSpec("sp-recurrentgemma-2b", "recurrentgemma-2b", 0, (1, SP_RANKS), ("data", "model"), 1,
             RG_LONG, 0),
    DistSpec("pod-train-qwen36", "qwen36-35b-a3b", 1, (2,), ("pod",), 4, PROMPT, 3),
    DistSpec("tp-qwen3-4b", "qwen3-4b", LAYERS, (2, 2), ("data", "model"), 4, PROMPT, 32),
    DistSpec("mp-rotary-qwen36", "qwen36-35b-a3b", 4, (1, 2), ("data", "model"), 1,
             PROMPT + CHUNK, 32),
    DistSpec("dp-train-qwen36", "qwen36-35b-a3b", 1, (2, 1), ("data", "model"), 4, PROMPT, 3),
    DistSpec("mp-train-qwen36", "qwen36-35b-a3b", 1, (2, 2), ("data", "model"), 4, PROMPT, 3),
    DistSpec("sp-train-qwen3-4b", "qwen3-4b", 1, (1, 3), ("data", "model"), 1, 3 * 1024, 2),
)
DIST_TIMEOUT = 600              # seconds for a world, weights and builds included
DIST_DEVICE = "cuda"
# RMS(sharded - unsharded) / RMS(unsharded logits), a step: a sound run reads 0.0073 on an
# H100 (the all-reduce rounds bf16 partial sums once more than one f32 sum does)
EP_RMS_TOL = 0.02
SP_TOL = KERNEL_TOL             # sp logits and caches against the unsharded prefill
PAYLOAD_MAX = 1 << 24           # leaves up to this many elements have their payload checked
WARM = 16                       # the ep ranks' warm-up prefill (positions) before the timed run
# the model-axis training worlds against their unsharded twin (bf16; set from a CPU rehearsal
# at reduced widths in bf16, tools/torch_mp_rehearsal.py, with a margin over its readings)
MP_LOSS_TOL = 0.002             # |step-0 loss (and cross-entropy) - the twin's|, nats
MP_GNORM_TOL = 0.01             # |step-0 grad norm / the twin's - 1|
# RMS(params - twin's) / RMS(twin's) after step 0. AdamW's first step moves each element by
# lr x sign(g), so an element moves apart only where rounding flips a near-zero gradient's
# sign (2 lr): ~1% gradient noise flips ~0.4% of them, ~1e-3 at full width
MP_RMS_TOL = 0.005
MP_FSDP_TOL = 0.002             # FSDP against the same world without it: losses (nats), RMS


def _dist_cfg(spec: DistSpec):
    from repro_torch.config import get_config

    cfg = get_config(spec.arch)
    if spec.layers:
        cfg = dataclasses.replace(cfg, segments=((cfg.segments[0][0], spec.layers),))
    return cfg


def _dist_tokens(cfg, spec: DistSpec):
    import numpy as np

    return np.random.default_rng(0).integers(0, cfg.vocab_size, (spec.rows, spec.prompt))


def _rank_setup(spec: DistSpec):
    """This rank's device, mesh and collective timer (every ``all_reduce``
    and ``all_gather`` timed on the host between two synchronizations)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device()) if DIST_DEVICE == "cuda"
           else torch.device(DIST_DEVICE))
    mesh = make_mesh(spec.mesh, spec.axes, device=DIST_DEVICE)
    coll = {"ms": 0.0, "calls": 0, "by": {}}
    for name in ("all_reduce", "all_gather", "reduce_scatter_single", "reduce_scatter_tensor"):
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def timed_call(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            coll["ms"] += ms
            coll["calls"] += 1
            by = coll["by"].setdefault(_name, [0.0, 0])
            by[0] += ms
            by[1] += 1
            return out

        setattr(dist, name, timed_call)
    return dev, mesh, coll


def _rank_close(summary: dict, coll: dict) -> dict:
    import torch

    from repro_torch.kernels import ops

    summary.update(counts=ops.launch_counts(), symbols=ops.symbol_launch_counts(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   coll_ms=coll["ms"], coll_calls=coll["calls"],
                   coll_by={n: tuple(v) for n, v in coll["by"].items()})
    return summary


def _ep_rank(rank: int, nprocs: int, spec: DistSpec) -> dict:
    """ep-qwen36 on one rank: every leaf at its ``param_spec`` (``shard_params``:
    64 of 128 experts a layer, half of each attention projection and of the
    vocabulary) and its data rank's 2 rows; ``prefill_model`` (``moe_epsum_local``,
    K1's tiled grouped entry, K3's fused entry), then greedy
    ``decode_model`` steps (``moe_epsum_decode_local``)."""
    import torch

    from repro_torch.config import ShardingConfig
    from repro_torch.distributed import sharding as shr
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    dev, mesh, coll = _rank_setup(spec)
    cfg = _dist_cfg(spec)
    sh = ShardingConfig(moe_impl="epsum")
    rt = tfm.Runtime(sharding=sh, mesh=mesh, cache_len=CACHE)
    t0 = time.perf_counter()
    params = tfm.shard_params(cfg, tfm.init_params(cfg, 0, dev), rt)
    gc.collect()
    torch.cuda.empty_cache()
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    rows_spec = shr.batch_spec(sh, mesh, spec.rows)
    tokens = shr.shard_tensor(torch.from_numpy(_dist_tokens(cfg, spec)).to(dev), rows_spec, mesh)
    setup_s = time.perf_counter() - t0
    _, warm = tfm.prefill_model(cfg, params, tokens[:, :WARM], CACHE, rt=rt)
    tfm.decode_model(cfg, params, tokens[:, 0], warm, WARM, rt=rt)
    del warm
    routes, route = [], moe_mod.route

    def recording(p, x2d, mcfg):                 # each MoE layer's top-k, for the check
        ids, w = route(p, x2d, mcfg)
        routes.append(ids.cpu())
        return ids, w

    moe_mod.route = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    coll.update(ms=0.0, calls=0)
    t0 = time.perf_counter()
    logits, state = tfm.prefill_model(cfg, params, tokens, CACHE, rt=rt)
    out = [logits.float().cpu()]
    prefill_s = time.perf_counter() - t0
    prefill_coll = dict(coll)
    t0 = time.perf_counter()
    for j in range(spec.steps - 1):
        lg, _ = tfm.decode_model(cfg, params, out[-1].argmax(-1).to(dev), state,
                                 spec.prompt + j, rt=rt)
        out.append(lg.float().cpu())
    decode_s = time.perf_counter() - t0
    logits = torch.stack(out, 1)                                  # [rows, steps, V]
    moe_mod.route = route
    return _rank_close(dict(
        rank=rank, coord=mesh.get_coordinate(), rows=shr.shard_bounds(spec.rows, rows_spec[0], mesh),
        logits=logits, ids=logits.argmax(-1), routes=routes, setup_s=setup_s, weight_gb=weight_gb,
        prefill_s=prefill_s, decode_s=decode_s, prefill_coll_ms=prefill_coll["ms"],
        prefill_coll_calls=prefill_coll["calls"]), coll)


def _sp_rank(rank: int, nprocs: int, spec: DistSpec) -> dict:
    """sp-recurrentgemma-2b on one rank: ``prefill_model`` of the whole
    prompt, each ``local_attn`` layer's queries split over the 4 ranks
    (``_sp_attention``, K4's chunk entry at offset rank x 768)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    dev, mesh, coll = _rank_setup(spec)
    cfg = _dist_cfg(spec)
    rt = tfm.Runtime(mesh=mesh, cache_len=RG_CACHE)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, dev)
    tokens = torch.from_numpy(_dist_tokens(cfg, spec)).to(dev)
    setup_s = time.perf_counter() - t0
    tfm.prefill_model(cfg, params, tokens, RG_CACHE, rt=rt)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    coll.update(ms=0.0, calls=0)
    t0 = time.perf_counter()
    logits, state = tfm.prefill_model(cfg, params, tokens, RG_CACHE, rt=rt)
    logits = logits.float().cpu()
    prefill_s = time.perf_counter() - t0
    caches = {f"{n}/{li}": st[n].cpu() for li, st in enumerate(state) for n in ("k", "v")
              if n in st}
    return _rank_close(dict(rank=rank, logits=logits, caches=caches, setup_s=setup_s,
                            prefill_s=prefill_s), coll)


def _recording(quantize, records: list):
    """``compression.quantize`` recording, for each leaf of at most
    ``PAYLOAD_MAX`` elements, (corrected gradient, shared max, int8 payload)
    on the host."""
    def recording(gf, amax):
        q, scale = quantize(gf, amax)
        if gf.numel() <= PAYLOAD_MAX:
            records.append((gf.cpu(), float(amax), q.cpu()))
        return q, scale

    return recording


def _bits_equal(params, group, n: int, chunk: int = 1 << 24) -> bool:
    """Whether every rank of ``group`` holds the same bits in every
    parameter leaf (each leaf's bits all-gathered a chunk at a time)."""
    import torch
    import torch.distributed as dist

    from repro_torch.tree import leaves

    for p in leaves(params):
        flat = p.detach().reshape(-1)
        for lo in range(0, flat.numel(), chunk):
            mine = flat[lo:lo + chunk].contiguous()
            parts = [torch.empty_like(mine) for _ in range(n)]
            dist.all_gather(parts, mine, group=group)      # gloo moves bf16, not int16
            bits = [q.view(torch.int16) for q in parts]
            if not all(torch.equal(bits[0], b) for b in bits[1:]):
                return False
    return True


def _pod_rank(rank: int, nprocs: int, spec: DistSpec) -> dict:
    """pod-train-qwen36 on one rank (one pod): its pod's rows of each
    step's global batch, ``make_train_step(pod_compression=True)``; the
    pods' parameters compared bit for bit after every step; step 0's int8
    payloads recorded for the plain recomputation."""
    import torch

    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.training import compression, init_train_state, make_train_step

    dev, mesh, coll = _rank_setup(spec)
    cfg = _dist_cfg(spec)
    sh = ShardingConfig(remat_policy="dots_saveable", moe_impl="sorted",
                        grad_compression="int8_ef")
    rt = tfm.Runtime(sharding=sh, mesh=mesh)
    run = RunConfig(**TRAIN_LR)
    data = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=spec.prompt,
                         global_batch=spec.rows, kind="topic", seed=0)
    pod = mesh.get_local_rank("pod")
    half = slice(pod * spec.rows // 2, (pod + 1) * spec.rows // 2)
    t0 = time.perf_counter()
    state = init_train_state(cfg, tfm.init_params(cfg, 0, dev), sh)
    step_fn = make_train_step(cfg, rt, run, pod_compression=True, pod_count=spec.mesh[0])
    setup_s = time.perf_counter() - t0
    records, quantize = [], compression.quantize
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    coll.update(ms=0.0, calls=0)
    losses, times, same, step_coll = [], [], [], []
    for i in range(spec.steps):
        tokens, labels = (torch.from_numpy(a[half]).to(dev) for a in batch_at_step(data, i))
        compression.quantize = _recording(quantize, records) if i == 0 else quantize
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), coll["ms"]
        state, m = step_fn(state, tokens, labels)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_coll.append(coll["ms"] - c0)
        kept = dict(coll)                    # the check's gathers are not the step's
        same.append(_bits_equal(state["params"], mesh.get_group("pod"), spec.mesh[0]))
        coll.update(kept)
    return _rank_close(dict(rank=rank, losses=losses, times=times, same=same,
                            step_coll_ms=step_coll, payloads=records, setup_s=setup_s,
                            ef=[tuple(t.shape) for t in _leaves(state["ef"])]), coll)


def _tp_rank(rank: int, nprocs: int, spec: DistSpec) -> dict:
    """tp-qwen3-4b on one rank: every leaf at its ``param_spec``
    (``shard_params``: 16 of 32 query heads and 4 of 8 KV heads, half of
    each MLP's columns / rows and of the vocabulary) and its data rank's 2
    rows; ``prefill_model`` (K4 on the rank's heads, the caches left split
    by sequence: a rank's 512 of 1,024 positions), then greedy
    ``decode_model`` steps (K2's partial entry over the rank's slice with
    every query head, one all-gather and the merge). Returns the logits,
    the greedy ids and the rank's cache slices."""
    import torch

    from repro_torch.config import ShardingConfig
    from repro_torch.distributed import sharding as shr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    dev, mesh, coll = _rank_setup(spec)
    cfg = _dist_cfg(spec)
    sh = ShardingConfig(moe_impl="epsum")
    rt = tfm.Runtime(sharding=sh, mesh=mesh, cache_len=CACHE)
    t0 = time.perf_counter()
    params = tfm.shard_params(cfg, tfm.init_params(cfg, 0, dev), rt)
    gc.collect()
    torch.cuda.empty_cache()
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    rows_spec = shr.batch_spec(sh, mesh, spec.rows)
    tokens = shr.shard_tensor(torch.from_numpy(_dist_tokens(cfg, spec)).to(dev), rows_spec, mesh)
    setup_s = time.perf_counter() - t0
    _, warm = tfm.prefill_model(cfg, params, tokens[:, :WARM], CACHE, rt=rt)
    tfm.decode_model(cfg, params, tokens[:, 0], warm, WARM, rt=rt)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    coll.update(ms=0.0, calls=0, by={})
    t0 = time.perf_counter()
    logits, state = tfm.prefill_model(cfg, params, tokens, CACHE, rt=rt)
    out = [logits.float().cpu()]
    prefill_s = time.perf_counter() - t0
    prefill_coll = dict(coll)
    prefill_launches = ops.symbol_launch_counts()
    t0 = time.perf_counter()
    for j in range(spec.steps - 1):
        lg, _ = tfm.decode_model(cfg, params, out[-1].argmax(-1).to(dev), state,
                                 spec.prompt + j, rt=rt)
        out.append(lg.float().cpu())
    decode_s = time.perf_counter() - t0
    logits = torch.stack(out, 1)                                  # [rows, steps, V]
    caches = {f"{n}/{li}": st[n].cpu() for li, st in enumerate(state) for n in ("k", "v")}
    return _rank_close(dict(
        rank=rank, coord=mesh.get_coordinate(), tp_rank=rt.tp_rank(),
        rows=shr.shard_bounds(spec.rows, rows_spec[0], mesh), logits=logits,
        ids=logits.argmax(-1), caches=caches, setup_s=setup_s, weight_gb=weight_gb,
        prefill_s=prefill_s, decode_s=decode_s, prefill_coll_ms=prefill_coll["ms"],
        prefill_coll_calls=prefill_coll["calls"], prefill_symbols=prefill_launches), coll)


# mp-rotary-qwen36: RotaryEngine over the model axis (two ranks sharing the card)
ROT_SLOTS = SLOTS               # each rank's slots, split on F (the twin's the same)
ROT_RUNS = (("full", 0, 1), ("rotary", ROT_SLOTS, 1), ("rotary-spec4", ROT_SLOTS, 4))
# RMS(ranks' logits - the unsharded twin's) / RMS(twin's) at a route-sure position: the split
# sums round bf16 partials once more than one sum does; twice the worst reading of the CPU
# rehearsal in bf16 at reduced widths (tools/torch_mp_rehearsal.py: 1.88e-2, median 1.04e-2)
ROT_RMS_TOL = 0.04
ROT_SURE_MIN = 0.5              # the share of decode positions the twin must route alike
# a run's routing against the truth fed it: how far below the truth's k-th router logit a pick
# may lie, against the plain bf16 forward's own worst (judge's form)
ROUTE_DEPTH_RATIO, ROUTE_DEPTH_SLACK = ERR_RATIO, 0.05


def _rot_engine(dev, cfg, params, rt, slots: int, spec_k: int):
    """mp-rotary-qwen36's engine: rotary (or, ``slots`` 0, full) residency
    in bf16 slots, synchronous rotation, chunked prefill in chunks of
    CHUNK, batch 1, cache ``rt.cache_len``; over ``rt.mesh`` when it has
    one."""
    from repro_torch.config import ResidencyConfig
    from repro_torch.core.engine import RotaryEngine

    rescfg = ResidencyConfig(mode="rotary" if slots else "full", num_slots=slots)
    return RotaryEngine(cfg, params, rescfg, rt=rt, batch=1, seed=0, spec_k=spec_k,
                        prefill_chunk=CHUNK, device=dev)


def _transition_log(engine):
    """A digest of every rotation's telemetry (ids, weights, misses, demand)
    and of every LUT after it, fed by wrapping the manager's two rotation
    entries (the chunk boundaries', the steps' and the windows'). Returns
    (the digest, a one-element list counting the rotations)."""
    import hashlib

    import numpy as np

    digest, n = hashlib.sha256(), [0]
    man = engine.manager
    for name in ("rotate_from_telemetry", "rotate_window_from_telemetry"):
        def wrapped(predictor, *arrays, _fn=getattr(man, name), **kw):
            for arr in arrays[:4]:
                digest.update(np.ascontiguousarray(arr).tobytes())
            out = _fn(predictor, *arrays, **kw)
            for pol in man.policies:
                digest.update(pol.lut.e2s.tobytes())
            n[0] += 1
            return out

        setattr(man, name, wrapped)
    return digest, n


def _rot_rank(rank: int, nprocs: int, spec: DistSpec) -> dict:
    """mp-rotary-qwen36 on one rank: ``RotaryEngine(rt=Runtime(mesh=))``
    over the model axis (this rank's heads and vocabulary columns, its 576
    of 1,152 positions of every KV cache, its 384 of 768 expert columns in
    the warehouse and every slot), for full residency, rotary at
    ``ROT_SLOTS`` and rotary in windows of 4: the 640-token prompt in
    chunks of 128 (the fifth straddles the slices' edge), then greedy
    decode steps in rank 1's slice. Each run's kernel launches and
    collectives count from a reset just before its prefill."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.config import ShardingConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    dev, mesh, coll = _rank_setup(spec)
    cfg = _dist_cfg(spec)
    rt = tfm.Runtime(sharding=ShardingConfig(moe_impl="epsum"), mesh=mesh, cache_len=ROT_CACHE)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, dev, expert_device="cpu")
    prompt = _dist_tokens(cfg, spec).astype(np.int32)
    setup_s = time.perf_counter() - t0
    runs, counts, symbols, peak = {}, {}, {}, 0.0
    for label, slots, k in ROT_RUNS:
        t0 = time.perf_counter()
        engine = _rot_engine(dev, cfg, params, rt, slots, k)
        build_s = time.perf_counter() - t0
        slot_gb = sum(t.numel() * t.element_size() for s in engine.manager.stores
                      for t in s.raw_dict().values()) / 1e9
        weight_gb = sum(t.numel() * t.element_size() for t in _leaves(engine._dparams)) / 1e9
        digest, rotations = _transition_log(engine)
        route_log = _recording_routes(engine)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        coll.update(ms=0.0, calls=0, by={})
        t0 = time.perf_counter()
        logits = engine.prefill(prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_coll = (coll["ms"], coll["calls"])
        t0 = time.perf_counter()
        toks, got, step_s, _ = decode_request(engine, logits, spec.steps, spec=k > 1)
        decode_s = time.perf_counter() - t0
        for name, n in ops.launch_counts().items():
            counts[name] = counts.get(name, 0) + n
        run_symbols = ops.symbol_launch_counts()
        for name, syms in run_symbols.items():
            for sym, n in syms.items():
                symbols.setdefault(name, {})[sym] = symbols.get(name, {}).get(sym, 0) + n
        st = engine.stats
        layers = st.layers.values()
        routes = _routes_of(route_log, engine.num_moe_layers, spec.prompt + spec.steps - 1)
        run_peak = torch.cuda.max_memory_allocated() / 2**30
        peak = max(peak, run_peak)
        runs[label] = dict(
            tokens=toks, logits=got if rt.tp_rank() == 0 else None,
            logits_sha=hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest(),
            transitions=digest.hexdigest(), rotations=rotations[0], misses=st.misses,
            routes=routes if rt.tp_rank() == 0 else None,
            routes_sha=hashlib.sha256(b"".join(r.tobytes() for r in routes)).hexdigest(),
            host_computed=sum(l.host_computed for l in layers),
            loads=sum(l.loads for l in layers), bytes_uploaded=st.bytes_uploaded,
            replayed=st.replayed_steps, prefill_replays=st.prefill_replays,
            prefill_chunks=st.prefill_chunks, windows=st.spec_windows,
            accepted=st.accepted_tokens, drafted=st.drafted_tokens,
            build_s=build_s, prefill_s=prefill_s, decode_s=decode_s,
            median_ms=1e3 * float(np.median(step_s[1:] if len(step_s) > 1 else step_s)),
            tok_s=spec.steps / decode_s, prefill_coll_ms=prefill_coll[0],
            prefill_coll_calls=prefill_coll[1], coll_ms=coll["ms"], coll_calls=coll["calls"],
            coll_by={n: tuple(v) for n, v in coll["by"].items()}, peak_gib=run_peak,
            slot_gb=slot_gb, weight_gb=weight_gb, symbols=run_symbols)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return dict(rank=rank, coord=mesh.get_coordinate(), tp_rank=rt.tp_rank(), runs=runs,
                counts=counts, symbols=symbols, peak_gib=peak, setup_s=setup_s,
                coll_ms=sum(r["coll_ms"] for r in runs.values()),
                coll_calls=sum(r["coll_calls"] for r in runs.values()))


def _held_to(what: str, toks, base, truth, plain) -> int:
    """``toks`` must equal ``base`` up to their first difference, and that
    position's truth top-2 margin must be under the guard (a near-tie that
    bf16 rounding may flip). Returns the positions that agree."""
    import numpy as np

    toks, base = np.asarray(toks), np.asarray(base)
    diff = np.flatnonzero(toks != base)
    if diff.size and sure_positions(truth, plain)[diff[0]]:
        raise AssertionError(f"{what}: greedy ids part at position {diff[0]}, a sure one")
    return int(diff[0]) if diff.size else len(toks)


def _route_flips(ids: list, z: list, k: int):
    """Where a forward's top-k differs from the routing ``ids`` it was fed
    (per MoE layer [positions, k]; ``z`` its router logits at the same
    positions, [1, positions, E] a layer): the (layer, position) pairs whose
    own top-k differs, and the worst depth of a fed pick below the forward's
    own k-th logit (0 where none differs): a near-tie is shallow."""
    import torch

    flips, depth = 0, 0.0
    for li, (want, zl) in enumerate(zip(ids, z)):
        zl = zl[0].float()
        own = zl.topk(k, dim=-1)
        fed = torch.as_tensor(want, dtype=torch.long)
        diff = (own.indices.sort(-1).values != fed.sort(-1).values).any(-1)
        flips += int(diff.sum())
        if diff.any():
            below = own.values[:, -1:] - torch.gather(zl, 1, fed)
            depth = max(depth, float(below[diff].max()))
    return flips, depth


def _routes_of(log: list, layers: int, positions: int):
    """The routing an engine committed, from its ``record_routing`` calls in
    order ((layer, ids [T, k]) each: every chunk and committed decode
    position once a layer, replayed layers with their replay's ids): per MoE
    layer [positions, k], the first ``positions`` rows (batch 1)."""
    import numpy as np

    per = [[] for _ in range(layers)]
    for li, ids in log:
        per[li].append(ids.reshape(-1, ids.shape[-1]))
    return [np.concatenate(p)[:positions] for p in per]


def _recording_routes(engine) -> list:
    """Wrap the engine's ``record_routing``: a list of (layer, ids) it fills."""
    import numpy as np

    log, record = [], engine.manager.record_routing

    def wrapped(layer, ids, miss):
        log.append((layer, np.array(ids)))
        return record(layer, ids, miss)

    engine.manager.record_routing = wrapped
    return log


def _rot_check(dev, spec: DistSpec, ranks: list) -> dict:
    """The ranks of each run hold the same tokens, logits (digests),
    telemetry, routing and residency transitions bit for bit; the rotary
    runs corrected a miss and replayed a suffix. Against the f32 truth
    under ``judge``: a split sum rounds differently from a whole one, so at
    a near-tie of a router's k-th and (k+1)-th logits the ranks may route
    another expert than an unsharded forward would, which moves that
    position's logits by far more than rounding does; so the truth and the
    plain bf16 forward are fed the run's committed routing (the ranks'
    ``record_routing``, as ep-qwen36 feeds its twin the ranks' top-k), and
    the routing is held apart: where the truth's own top-k differs from the
    run's, the run's pick must lie within ``ROUTE_DEPTH_RATIO`` x the plain
    forward's own worst such depth + ``ROUTE_DEPTH_SLACK`` below the truth's
    k-th logit. Rotary's greedy ids are held to full residency's and spec
    4's to spec 1's under the margin guard. Against the unsharded
    RotaryEngine on the card (the twin: the same weights and slots, spec 1,
    fed the ranks' tokens), at each decode position whose routing the twin
    and the ranks share in every layer (at least ROT_SURE_MIN of them),
    RMS(diff) / RMS(twin) <= ROT_RMS_TOL."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm

    cfg = _dist_cfg(spec)
    keys = ("tokens", "logits_sha", "transitions", "rotations", "misses", "host_computed",
            "loads", "replayed", "prefill_replays", "routes_sha")
    for label, _, _ in ROT_RUNS:
        for key in keys:
            vals = [r["runs"][label][key] for r in ranks]
            if any(v != vals[0] for v in vals[1:]):
                raise AssertionError(f"{spec.label} {label}: the model ranks' {key} differ")
    runs = next(r for r in ranks if r["tp_rank"] == 0)["runs"]
    for label in ("rotary", "rotary-spec4"):
        r = runs[label]
        if r["misses"] <= 0 or r["host_computed"] != r["misses"] or (
                r["replayed"] + r["prefill_replays"]) <= 0:
            raise AssertionError(f"{spec.label} {label}: {r['misses']} misses, "
                                 f"{r['host_computed']} corrected, {r['replayed']} steps and "
                                 f"{r['prefill_replays']} chunks replayed: a miss must be "
                                 f"corrected and a suffix replayed")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, dev, expert_device="cpu")
    twin = _rot_engine(dev, cfg, params, tfm.Runtime(cache_len=ROT_CACHE), ROT_SLOTS, 1)
    del params
    twin_log = _recording_routes(twin)
    prompt = _dist_tokens(cfg, spec).astype(np.int32)
    n, layers, k = prompt.shape[1], twin.num_moe_layers, cfg.moe.top_k
    toks = runs["rotary"]["tokens"]
    rows = [twin.prefill(prompt)[0]]
    for tok in toks[:-1]:
        forced = np.zeros((1, cfg.vocab_size), np.float32)
        forced[0, tok] = 1.0                       # decode takes the argmax: this token
        twin.decode(forced, 1)
        rows.append(twin.last_logits[0])
    want = np.stack(rows)
    got = runs["rotary"]["logits"]
    rms = np.sqrt(((got - want) ** 2).mean(1)) / np.sqrt((want ** 2).mean(1))
    seq_len = n + len(toks) - 1
    twin_routes = _routes_of(twin_log, layers, seq_len)
    shared = np.ones(len(toks), bool)          # decode positions n-1 .. routed alike
    for a, b in zip(twin_routes, runs["rotary"]["routes"]):
        shared &= (np.sort(a[n - 1:], -1) == np.sort(b[n - 1:], -1)).all(-1)
    twin_s = time.perf_counter() - t0
    refs, agree, far, flips = {}, {}, [], {}
    for label, _, _ in ROT_RUNS:
        seq = np.concatenate([prompt[0], np.asarray(runs[label]["tokens"][:-1], np.int32)])[None]
        routes = [torch.as_tensor(r[None]) for r in runs[label]["routes"]]
        zt, zp = [], []
        truth = reference_logits(cfg, twin, seq, torch.float32, zt, routes)[n - 1:].cpu().numpy()
        plain = reference_logits(cfg, twin, seq, torch.bfloat16, zp, routes)[n - 1:].cpu().numpy()
        refs[label] = (truth, plain)
        f_run, d_run = _route_flips(runs[label]["routes"], zt, k)
        f_pl, d_pl = _route_flips([z[0].float().topk(k, dim=-1).indices.numpy() for z in zp],
                                  zt, k)
        flips[label] = dict(flips=f_run, depth=d_run, plain_flips=f_pl, plain_depth=d_pl)
        limit = ROUTE_DEPTH_RATIO * d_pl + ROUTE_DEPTH_SLACK
        log(f"  {spec.label} {label}: fed its committed routing, the truth's own top-k differs at "
            f"{f_run} of {layers * seq_len} (layer, position) pairs, the run's pick at most "
            f"{d_run:.4f} below the truth's k-th router logit (limit {limit:.4f}); the plain "
            f"bf16 forward's own top-k differs at {f_pl}, at most {d_pl:.4f} below")
        if d_run > limit:
            far.append(f"{label} routing")
        if not judge(f"{spec.label} {label}", runs[label]["logits"], truth, plain):
            far.append(label)
    agree["rotary"] = _held_to(f"{spec.label} rotary vs full", runs["rotary"]["tokens"],
                               runs["full"]["tokens"], *refs["full"])
    agree["rotary-spec4"] = _held_to(f"{spec.label} spec 4 vs spec 1",
                                     runs["rotary-spec4"]["tokens"], runs["rotary"]["tokens"],
                                     *refs["rotary"])
    spec4_bitwise = runs["rotary-spec4"]["logits_sha"] == runs["rotary"]["logits_sha"]
    twin_stats = dict(misses=twin.stats.misses, replayed=twin.stats.replayed_steps,
                      prefill_replays=twin.stats.prefill_replays)
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    worst = float(rms[shared].max()) if shared.any() else float("inf")
    log(f"[5/{spec.label}] ranks bitwise equal in tokens, logits, telemetry, routing and "
        f"transitions on every run; against the unsharded RotaryEngine on {dev.type} "
        f"({ROT_SLOTS} slots, fed the rotary run's tokens; {twin_s:.1f} s; its misses "
        f"{twin_stats['misses']}, replayed {twin_stats['replayed']} steps and "
        f"{twin_stats['prefill_replays']} chunks): routed alike at {int(shared.sum())} of "
        f"{len(shared)} positions, worst RMS(diff) / RMS(logits) there {worst:.5f} (median "
        f"{float(np.median(rms[shared])) if shared.any() else float('nan'):.5f}; tolerance "
        f"{ROT_RMS_TOL}; over all positions worst {float(rms.max()):.5f}); greedy ids: rotary "
        f"equals full at {agree['rotary']} of {spec.steps} positions, spec 4 equals spec 1 at "
        f"{agree['rotary-spec4']} (logits bitwise: {spec4_bitwise})")
    if far:
        raise AssertionError(f"{spec.label} {far}: farther from the truth than bf16")
    if shared.sum() < ROT_SURE_MIN * len(shared) or not worst <= ROT_RMS_TOL:
        raise AssertionError(f"{spec.label}: logits part from the unsharded twin")
    return dict(rms_rel=worst, rms_all=float(rms.max()),
                rms_median=float(np.median(rms[shared])), shared=int(shared.sum()),
                agree=agree, spec4_bitwise=spec4_bitwise, twin=twin_stats, flips=flips)


def _dpt_rank(rank: int, nprocs: int, spec: DistSpec) -> dict:
    """dp-train-qwen36 on one rank: its data rank's rows of each step's
    global batch (``trainer.data_rows``), ``make_train_step`` over the
    (data 2) mesh with ZeRO-1 (the moments at ``opt_spec``, gradients
    reduce-scattered or all-reduced, AdamW on the shards, parameters
    all-gathered); the data ranks' parameters compared bit for bit after
    every step."""
    import torch

    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.trainer import data_rows

    dev, mesh, coll = _rank_setup(spec)
    cfg = _dist_cfg(spec)
    sh = ShardingConfig(remat_policy="dots_saveable", moe_impl="epsum", zero1=True)
    rt = tfm.Runtime(sharding=sh, mesh=mesh)
    data = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=spec.prompt,
                         global_batch=spec.rows, kind="topic", seed=0)
    dp, r = spec.mesh[0], mesh.get_local_rank("data")
    t0 = time.perf_counter()
    state = init_train_state(cfg, tfm.init_params(cfg, 0, dev), sh, mesh=mesh)
    step_fn = make_train_step(cfg, rt, RunConfig(**TRAIN_LR))
    setup_s = time.perf_counter() - t0
    moment_gb = sum(t.numel() * t.element_size() for key in ("m", "v")
                    for t in _leaves(state["opt"][key])) / 1e9
    whole_gb = 2 * 4 * sum(p.numel() for p in _leaves(state["params"])) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    coll.update(ms=0.0, calls=0, by={})
    losses, xents, norms, times, same, step_coll = [], [], [], [], [], []
    for i in range(spec.steps):
        tokens, labels = (data_rows(torch.from_numpy(a), 1, r, dp).to(dev)
                          for a in batch_at_step(data, i))
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), coll["ms"]
        state, m = step_fn(state, tokens, labels)
        losses.append(float(m["loss"]))
        xents.append(float(m["lm_xent"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_coll.append(coll["ms"] - c0)
        kept = {"ms": coll["ms"], "calls": coll["calls"],
                "by": {n: list(v) for n, v in coll["by"].items()}}
        same.append(_bits_equal(state["params"], mesh.get_group("data"), dp))
        coll.update(kept)                    # the check's gathers are not the step's
    return _rank_close(dict(rank=rank, losses=losses, xents=xents, norms=norms, times=times,
                            same=same, step_coll_ms=step_coll, setup_s=setup_s,
                            moment_gb=moment_gb, whole_moment_gb=whole_gb,
                            moment_shapes=[tuple(t.shape) for t in _leaves(state["opt"]["m"])]),
                       coll)


def _mp_cfg_sh(spec: DistSpec):
    from repro_torch.config import ShardingConfig

    return _dist_cfg(spec), ShardingConfig(remat_policy="dots_saveable", moe_impl="epsum")


def _mp_data(cfg, spec: DistSpec):
    from repro_torch.data import SyntheticSpec

    return SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=spec.prompt,
                         global_batch=spec.rows, kind="topic", seed=0)


def _mp_twin(dev, spec: DistSpec, path: str) -> dict:
    """One process, the whole model: ``make_train_step`` on the world's
    global batch, each data rank's rows a microbatch (so each keeps that
    rank's MoE capacity); step 0's cross-entropy (``lm_loss``'s
    ``lm_xent`` before the step), every step's loss and time, and the
    parameters after step 0 saved to ``path`` for the ranks."""
    import numpy as np
    import torch

    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.data import batch_at_step
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.tree import leaves

    cfg, sh = _mp_cfg_sh(spec)
    sh = dataclasses.replace(sh, moe_impl="sorted")
    data, micro = _mp_data(cfg, spec), spec.mesh[0]
    rt = tfm.Runtime(sharding=sh)
    state = init_train_state(cfg, tfm.init_params(cfg, 0, dev))
    step_fn = make_train_step(cfg, rt, RunConfig(**TRAIN_LR), num_micro=micro)
    losses, norms, times, xent = [], [], [], None
    for i in range(spec.steps):
        tokens, labels = (torch.from_numpy(a).to(dev) for a in batch_at_step(data, i))
        if i == 0:
            mb = spec.rows // micro
            with torch.no_grad():
                xent = float(np.mean([float(tfm.lm_loss(
                    cfg, state["params"], tokens[j * mb:(j + 1) * mb],
                    labels[j * mb:(j + 1) * mb], rt)[1]["lm_xent"]) for j in range(micro)]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, tokens, labels)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            torch.save([p.detach().cpu() for p in leaves(state["params"])], path)
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, norms=norms, xent0=xent, times=times)


def _sq_pieces(pairs, layout, mesh, tp_rank: int, dp_rank: int):
    """[sum of (a - b)^2, sum of b^2, all bitwise] over each element once:
    ``pairs`` (this rank's stored shard a, the reference's same piece b)
    per leaf; a leaf whole on the model ranks counts on model rank 0, one
    whole on the data ranks on data rank 0; summed over the world."""
    import torch
    import torch.distributed as dist

    acc = torch.zeros(3, dtype=torch.float64, device=pairs[0][0].device)
    for (a, b), lay in zip(pairs, layout.values()):
        if (lay.tp is None and tp_rank) or (lay.fsdp is None and dp_rank):
            continue
        a32, b32 = a.detach().float(), b.float()
        acc[0] += float(torch.sum(torch.square(a32 - b32)))
        acc[1] += float(torch.sum(torch.square(b32)))
        acc[2] += 0.0 if torch.equal(a.detach(), b) else 1.0
    dist.all_reduce(acc)
    return acc


def _mpt_rank(rank: int, nprocs: int, spec: DistSpec, twin_path: str) -> dict:
    """mp-train-qwen36 / sp-train-qwen3-4b on one rank: its data rank's rows
    of each step's global batch (``trainer.data_rows``), ``make_train_step``
    over the (data, model) mesh from ``init_train_state(mesh=)`` (each leaf
    at its ``param_spec``, moments at ``opt_spec``: ZeRO-1); after step 0
    its stored shards against the twin's parameters (``_sq_pieces``), the
    leaves whole over the model axis compared bit for bit across the model
    ranks and every leaf across the data ranks. mp-train-qwen36 then runs
    the same steps from the seed with FSDP storage (``fsdp=True``) and
    compares its shards with the first run's."""
    import torch

    from repro_torch.config import RunConfig
    from repro_torch.data import batch_at_step
    from repro_torch.distributed.sharding import shard_tensor
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.trainer import data_rows, state_layout
    from repro_torch.tree import leaves

    dev, mesh, coll = _rank_setup(spec)
    cfg, sh = _mp_cfg_sh(spec)
    rt = tfm.Runtime(sharding=sh, mesh=mesh)
    data = _mp_data(cfg, spec)
    dp, r = spec.mesh[0], mesh.get_local_rank("data")
    tp_rank = rt.tp_rank()
    out, first = {}, None
    for fsdp in ((False, True) if dp > 1 else (False,)):
        layout = state_layout(cfg, mesh, sh, fsdp=fsdp)
        t0 = time.perf_counter()
        state = init_train_state(cfg, tfm.init_params(cfg, 0, dev), sh, mesh=mesh, fsdp=fsdp)
        step_fn = make_train_step(cfg, rt, RunConfig(**TRAIN_LR), fsdp=fsdp)
        gc.collect()
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        ps = leaves(state["params"])               # in the layout's order
        if any(p.device.type != DIST_DEVICE for p in ps):
            raise AssertionError(f"{spec.label}: a parameter is off the card")
        weight_gb = sum(p.numel() * p.element_size() for p in ps) / 1e9
        moment_gb = sum(t.numel() * t.element_size() for key in ("m", "v")
                        for t in _leaves(state["opt"][key])) / 1e9
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        coll.update(ms=0.0, calls=0, by={})
        res = dict(losses=[], xents=[], norms=[], times=[], step_coll_ms=[])
        for i in range(spec.steps):
            tokens, labels = (data_rows(torch.from_numpy(a), 1, r, dp).to(dev)
                              for a in batch_at_step(data, i))
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), coll["ms"]
            state, m = step_fn(state, tokens, labels)
            res["losses"].append(float(m["loss"]))
            res["xents"].append(float(m["lm_xent"]))
            res["norms"].append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            res["times"].append(time.perf_counter() - t0)
            res["step_coll_ms"].append(coll["ms"] - c0)
            if i == 0 and not fsdp:
                kept = {"ms": coll["ms"], "calls": coll["calls"],
                        "by": {n: list(v) for n, v in coll["by"].items()}}
                twin = torch.load(twin_path, mmap=True)
                pairs = [(p, shard_tensor(t, lay.pspec, mesh, device=dev))
                         for p, t, lay in zip(ps, twin, layout.values())]
                res["twin_acc"] = _sq_pieces(pairs, layout, mesh, tp_rank, r).tolist()
                del pairs, twin
                whole = [p for p, lay in zip(ps, layout.values()) if lay.tp is None]
                res["same_tp"] = _bits_equal(whole, rt.tp_group(), spec.mesh[1])
                res["same_dp"] = dp == 1 or _bits_equal(ps, mesh.get_group("data"), dp)
                coll.update(kept)                # the checks' collectives are not the step's
        res.update(setup_s=setup_s, weight_gb=weight_gb, moment_gb=moment_gb,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   counts=ops.launch_counts(), coll_ms=coll["ms"], coll_calls=coll["calls"],
                   coll_by={n: tuple(v) for n, v in coll["by"].items()})
        if not fsdp:
            first = (layout, [p.detach() for p in ps])
            del state, step_fn, ps
        else:
            lay0, ps0 = first
            pairs = []
            for p, q, lay in zip(ps, ps0, layout.values()):
                if lay.fsdp is not None:
                    n = p.shape[lay.fsdp]
                    q = q.narrow(lay.fsdp, r * n, n)
                pairs.append((p, q))
            res["first_acc"] = _sq_pieces(pairs, layout, mesh, tp_rank, r).tolist()
            del state, step_fn, ps, pairs, first
        gc.collect()
        torch.cuda.empty_cache()
        out["fsdp" if fsdp else "whole"] = res
    whole = out["whole"]
    summary = dict(rank=rank, coord=mesh.get_coordinate(), fsdp=out.get("fsdp"), **{
        k: v for k, v in whole.items() if k not in ("counts", "coll_ms", "coll_calls",
                                                    "coll_by", "peak_gib")})
    summary.update(counts=whole["counts"], symbols=ops.symbol_launch_counts(),
                   peak_gib=max(res["peak_gib"] for res in out.values()),
                   coll_ms=whole["coll_ms"], coll_calls=whole["coll_calls"],
                   coll_by=whole["coll_by"])
    return summary


def _ep_unsharded(cfg, params, tokens, ids, routes, spec: DistSpec):
    """One process, the whole expert store: the prefill of ``tokens`` [R, S]
    through K4 and, in each MoE layer, ``moe_sorted`` at the epsum capacity
    (the R x S tokens' ``max(k, ceil(T k / E cf))``), then ``decode_model``
    (``moe_apply_routed``) fed ``ids`` [R, steps]: logits [R, steps, V] f32
    on the host. Every MoE layer takes the sharded run's top-k choice
    (``routes``, in call order) with its own gate weights: a near-tie that
    two sums of one router GEMM break apart would otherwise move the drops
    (prefill) or swap an expert (decode), a difference of routing and not of
    the expert-parallel arithmetic this check holds."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    replay = iter(routes)
    route = moe_mod.route

    def replayed(p, x2d, mcfg):
        chosen = next(replay).to(x2d.device).long()
        probs = torch.softmax(moe_mod.router_logits(p, x2d), dim=-1)
        w = probs.gather(1, chosen)
        if mcfg.norm_topk_prob:
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return chosen.to(torch.int32), w

    moe_mod.route = replayed
    try:
        with torch.no_grad():
            x = tfm.embed_tokens(params, tokens)
            state = tfm.zero_state(cfg, tokens.shape[0], CACHE, tokens.device)
            for li, p in enumerate(params["layers"]):
                x_mid, h2, _ = tfm.attn_half(cfg, p, x, "prefill", state[li], 0, CACHE)
                routing = moe_mod.Routing(next(replay).to(tokens.device).long(), replay=True)
                y2, _ = moe_mod.moe_forward(p["moe"], cfg.moe, h2.reshape(x_mid.shape),
                                            "sorted", routing)
                x = x_mid + y2
            out = [tfm.lm_logits(cfg, params, x[:, -1:])[:, 0].float().cpu()]
            for j in range(spec.steps - 1):
                lg, _ = tfm.decode_model(cfg, params, ids[:, j], state, spec.prompt + j)
                out.append(lg.float().cpu())
    finally:
        moe_mod.route = route
    return torch.stack(out, 1)


def _ep_check(dev, spec: DistSpec, ranks: list) -> dict:
    """The model ranks of a data rank agree bit for bit; each data rank's
    logits against ``_ep_unsharded`` of the same weights fed the sharded
    path's greedy ids and top-k choices: per step RMS(diff) / RMS(logits)
    <= EP_RMS_TOL, and
    the sharded greedy id is the unsharded argmax wherever the unsharded
    top-2 margin exceeds twice that step's largest |diff|."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = _dist_cfg(spec)
    groups = {}
    for r in ranks:
        groups.setdefault(tuple(r["rows"]), []).append(r)
    for rows, rs in groups.items():
        if not all(torch.equal(r["logits"], rs[0]["logits"]) for r in rs[1:]):
            raise AssertionError(f"{spec.label}: the model ranks of rows {rows} disagree")
    params = tfm.init_params(cfg, 0, dev)
    tokens = torch.from_numpy(_dist_tokens(cfg, spec)).to(dev)
    worst_rms = worst_abs = 0.0
    sure = parted = 0
    rms_steps = []
    t0 = time.perf_counter()
    for (lo, hi), rs in sorted(groups.items()):
        got = rs[0]["logits"]
        want = _ep_unsharded(cfg, params, tokens[lo:hi], rs[0]["ids"].to(dev), rs[0]["routes"],
                             spec)
        diff = got - want
        rms = diff.square().mean(dim=(0, 2)).sqrt() / want.square().mean(dim=(0, 2)).sqrt()
        rms_steps.append(rms)
        worst_rms = max(worst_rms, float(rms.max()))
        step_max = diff.abs().amax(dim=(0, 2))                       # [steps]
        worst_abs = max(worst_abs, float(step_max.max()))
        top2 = want.topk(2, dim=-1).values
        ok = (top2[..., 0] - top2[..., 1]) > 2 * step_max[None, :]
        sure += int(ok.sum())
        parted += int((ok & (got.argmax(-1) != want.argmax(-1))).sum())
    unsharded_s = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    n = spec.rows * spec.steps
    per_step = torch.stack(rms_steps).amax(0)
    log(f"[5/{spec.label}] against one process of the same weights unsharded (moe_sorted at the "
        f"epsum capacity, moe_apply_routed in decode; {unsharded_s:.1f} s): worst step RMS(diff) "
        f"/ RMS(logits) {worst_rms:.5f} (tolerance {EP_RMS_TOL}; by step "
        f"{' '.join(f'{x:.4f}' for x in per_step.tolist())}), largest |diff| "
        f"{worst_abs:.4f}; greedy ids equal at {sure - parted} of {sure} sure positions "
        f"({n - sure} of {n} under the margin guard)")
    if not worst_rms <= EP_RMS_TOL:
        raise AssertionError(f"{spec.label}: logits part from the unsharded run")
    if parted:
        raise AssertionError(f"{spec.label}: {parted} greedy ids differ at sure positions")
    return dict(rms_rel=worst_rms, max_abs=worst_abs, sure=sure, positions=n)


def _sp_check(dev, spec: DistSpec, ranks: list) -> dict:
    """Every rank holds the same logits and caches; they match the unsharded
    ``prefill_model`` of the same weights (K4's causal entry over the whole
    prompt) within SP_TOL."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = _dist_cfg(spec)
    for r in ranks[1:]:
        if not (torch.equal(r["logits"], ranks[0]["logits"])
                and all(torch.equal(r["caches"][k], v) for k, v in ranks[0]["caches"].items())):
            raise AssertionError(f"{spec.label}: rank {r['rank']} disagrees with rank 0")
    params = tfm.init_params(cfg, 0, dev)
    tokens = torch.from_numpy(_dist_tokens(cfg, spec)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = tfm.prefill_model(cfg, params, tokens, RG_CACHE)
    torch.cuda.synchronize()
    unsharded_ms = (time.perf_counter() - t0) * 1e3
    got = ranks[0]
    err = check_close(f"{spec.label} logits", got["logits"], logits.float().cpu(), **SP_TOL)
    bitwise = torch.equal(got["logits"], logits.float().cpu())
    cache_err = 0.0
    for li, st in enumerate(state):
        for n in ("k", "v"):
            if n in st:
                want = st[n].cpu()
                cache_err = max(cache_err, check_close(f"{spec.label} cache {n}/{li}",
                                                       got["caches"][f"{n}/{li}"], want, **SP_TOL))
                bitwise = bitwise and torch.equal(got["caches"][f"{n}/{li}"], want)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[5/{spec.label}] against the unsharded prefill_model ({unsharded_ms:.1f} ms): logits "
        f"max |diff| {err:.3e}, {len(got['caches'])} caches max |diff| {cache_err:.3e}, bitwise "
        f"{bitwise}")
    return dict(max_abs=err, cache_max_abs=cache_err, bitwise=bitwise,
                unsharded_ms=unsharded_ms)


def _pod_check(dev, spec: DistSpec, ranks: list) -> dict:
    """The pods' parameters equal after every step (checksums) and their
    losses equal; step 0's int8 payloads of every leaf up to PAYLOAD_MAX
    elements bitwise a plain numpy recomputation; against one process taking
    the same global batch uncompressed (``make_train_step(num_micro=2)``:
    the pods' halves as microbatches, their f32 gradients averaged): step
    0's loss within TRAIN_LOSS_TOL, the later losses printed."""
    import numpy as np
    import torch

    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step

    cfg = _dist_cfg(spec)
    if not all(all(r["same"]) for r in ranks):
        raise AssertionError(f"{spec.label}: the pods' parameters part: "
                             f"{[r['same'] for r in ranks]}")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"{spec.label}: the pods' losses differ")
    if any(s[0] != 1 for r in ranks for s in r["ef"]):
        raise AssertionError(f"{spec.label}: a residual is not this pod's [1, *shape] slice")
    checked = 0
    for r in ranks:
        for gf, amax, q in r["payloads"]:
            scale = np.float32(amax) / np.float32(127.0) + np.float32(1e-12)
            plain = np.clip(np.rint(gf.numpy() / scale), -127, 127).astype(np.int8)
            if not np.array_equal(plain, q.numpy()):
                raise AssertionError(f"{spec.label}: an int8 payload differs from the plain one")
            checked += gf.numel()
    sh = ShardingConfig(remat_policy="dots_saveable", moe_impl="sorted")
    data = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=spec.prompt,
                         global_batch=spec.rows, kind="topic", seed=0)
    state = init_train_state(cfg, tfm.init_params(cfg, 0, dev))
    step_fn = make_train_step(cfg, tfm.Runtime(sharding=sh), RunConfig(**TRAIN_LR),
                              num_micro=spec.mesh[0])
    plain_losses, plain_times = [], []
    for i in range(spec.steps):
        tokens, labels = (torch.from_numpy(a).to(dev) for a in batch_at_step(data, i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, tokens, labels)
        plain_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        plain_times.append(time.perf_counter() - t0)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    losses = ranks[0]["losses"]
    log(f"[5/{spec.label}] pods' parameters bitwise equal after each of {spec.steps} steps; "
        f"{checked} int8 payload elements (leaves up to {PAYLOAD_MAX}) bitwise the plain "
        f"recomputation; losses {' '.join(f'{x:.5f}' for x in losses)} against one process "
        f"uncompressed {' '.join(f'{x:.5f}' for x in plain_losses)} (step 0 |diff| "
        f"{abs(losses[0] - plain_losses[0]):.5f}, tolerance {TRAIN_LOSS_TOL}); uncompressed "
        f"step ms {' '.join(f'{1e3 * x:.1f}' for x in plain_times)}")
    if checked == 0:
        raise AssertionError(f"{spec.label}: no payload was checked")
    if not abs(losses[0] - plain_losses[0]) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"{spec.label}: step 0's loss parts from the uncompressed step")
    return dict(payload_elements=checked, plain_losses=plain_losses,
                plain_median_ms=float(np.median(plain_times[1:])) * 1e3)


def _tp_check(dev, spec: DistSpec, ranks: list) -> dict:
    """The model ranks of a data rank hold the same logits bit for bit; each
    data rank's logits against one process of the same weights unsharded
    (``prefill_model``, then ``decode_model`` fed the sharded run's greedy
    ids): per step RMS(diff) / RMS(logits) <= EP_RMS_TOL, the greedy ids
    equal wherever the unsharded top-2 margin exceeds twice the step's
    largest |diff|; each rank's slice of every KV cache against the same
    positions of the unsharded cache, RMS(diff) / RMS(cache) <= EP_RMS_TOL
    (bitwise slices counted)."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = _dist_cfg(spec)
    groups = {}
    for r in ranks:
        groups.setdefault(tuple(r["rows"]), []).append(r)
    for rows, rs in groups.items():
        if not all(torch.equal(r["logits"], rs[0]["logits"]) for r in rs[1:]):
            raise AssertionError(f"{spec.label}: the model ranks of rows {rows} disagree")
    params = tfm.init_params(cfg, 0, dev)
    tokens = torch.from_numpy(_dist_tokens(cfg, spec)).to(dev)
    worst_rms = worst_abs = cache_rms = 0.0
    sure = parted = slices = bitwise = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for (lo, hi), rs in sorted(groups.items()):
            got, ids = rs[0]["logits"], rs[0]["ids"].to(dev)
            logits, state = tfm.prefill_model(cfg, params, tokens[lo:hi], CACHE)
            out = [logits.float().cpu()]
            for j in range(spec.steps - 1):
                lg, _ = tfm.decode_model(cfg, params, ids[:, j], state, spec.prompt + j)
                out.append(lg.float().cpu())
            want = torch.stack(out, 1)
            diff = got - want
            rms = diff.square().mean(dim=(0, 2)).sqrt() / want.square().mean(dim=(0, 2)).sqrt()
            worst_rms = max(worst_rms, float(rms.max()))
            step_max = diff.abs().amax(dim=(0, 2))
            worst_abs = max(worst_abs, float(step_max.max()))
            top2 = want.topk(2, dim=-1).values
            ok = (top2[..., 0] - top2[..., 1]) > 2 * step_max[None, :]
            sure += int(ok.sum())
            parted += int((ok & (got.argmax(-1) != want.argmax(-1))).sum())
            for r in rs:
                for key, mine in r["caches"].items():
                    n, li = key.split("/")
                    c = mine.shape[1]
                    whole = state[int(li)][n][:, r["tp_rank"] * c:(r["tp_rank"] + 1) * c].cpu()
                    err = (mine.float() - whole.float()).square().mean().sqrt() / max(
                        float(whole.float().square().mean().sqrt()), 1e-30)
                    cache_rms = max(cache_rms, float(err))
                    slices += 1
                    bitwise += torch.equal(mine, whole)
            del state
    unsharded_s = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    n = spec.rows * spec.steps
    log(f"[5/{spec.label}] against one process of the same weights unsharded "
        f"({unsharded_s:.1f} s): worst step RMS(diff) / RMS(logits) {worst_rms:.5f} (tolerance "
        f"{EP_RMS_TOL}), largest |diff| {worst_abs:.4f}; greedy ids equal at {sure - parted} of "
        f"{sure} sure positions ({n - sure} of {n} under the margin guard); {slices} cache "
        f"slices, worst RMS(diff) / RMS(cache) {cache_rms:.5f}, {bitwise} bitwise")
    if not worst_rms <= EP_RMS_TOL:
        raise AssertionError(f"{spec.label}: logits part from the unsharded run")
    if parted:
        raise AssertionError(f"{spec.label}: {parted} greedy ids differ at sure positions")
    if not cache_rms <= EP_RMS_TOL:
        raise AssertionError(f"{spec.label}: a cache slice parts from the unsharded cache")
    return dict(rms_rel=worst_rms, max_abs=worst_abs, sure=sure, positions=n,
                cache_rms=cache_rms, cache_slices=slices, cache_bitwise=bitwise)


def _dpt_check(dev, spec: DistSpec, ranks: list) -> dict:
    """The data ranks' parameters equal after every step and their losses
    equal; against one process taking the same global batch
    (``make_train_step(num_micro=2)``: each data rank's rows a microbatch,
    so each keeps the same MoE capacity as that rank): step 0's loss within
    TRAIN_LOSS_TOL, the later losses printed."""
    import numpy as np
    import torch

    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step

    cfg = _dist_cfg(spec)
    if not all(all(r["same"]) for r in ranks):
        raise AssertionError(f"{spec.label}: the data ranks' parameters part: "
                             f"{[r['same'] for r in ranks]}")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"{spec.label}: the data ranks' losses differ")
    sh = ShardingConfig(remat_policy="dots_saveable", moe_impl="sorted")
    data = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=spec.prompt,
                         global_batch=spec.rows, kind="topic", seed=0)
    state = init_train_state(cfg, tfm.init_params(cfg, 0, dev))
    step_fn = make_train_step(cfg, tfm.Runtime(sharding=sh), RunConfig(**TRAIN_LR),
                              num_micro=spec.mesh[0])
    plain_losses, plain_times = [], []
    for i in range(spec.steps):
        tokens, labels = (torch.from_numpy(a).to(dev) for a in batch_at_step(data, i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, tokens, labels)
        plain_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        plain_times.append(time.perf_counter() - t0)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    losses = ranks[0]["losses"]
    log(f"[5/{spec.label}] data ranks' parameters bitwise equal after each of {spec.steps} "
        f"steps; losses {' '.join(f'{x:.5f}' for x in losses)} (cross-entropy "
        f"{' '.join(f'{x:.5f}' for x in ranks[0]['xents'])}) against one process "
        f"{' '.join(f'{x:.5f}' for x in plain_losses)} (step 0 |diff| "
        f"{abs(losses[0] - plain_losses[0]):.5f}, tolerance {TRAIN_LOSS_TOL}); one process's "
        f"step ms {' '.join(f'{1e3 * x:.1f}' for x in plain_times)}")
    if not abs(losses[0] - plain_losses[0]) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"{spec.label}: step 0's loss parts from the one-process step")
    return dict(plain_losses=plain_losses,
                plain_median_ms=float(np.median(plain_times[1:])) * 1e3)


def _mpt_check(dev, spec: DistSpec, ranks: list, twin: dict) -> dict:
    """Every rank's losses equal; the whole leaves bitwise across the model
    ranks and the data ranks' parameters bitwise after step 0; step 0's
    loss and cross-entropy within MP_LOSS_TOL of the twin's, the
    parameters after step 0 within MP_RMS_TOL relative RMS; with FSDP: its
    losses within MP_FSDP_TOL of the run without it and its final
    parameters within MP_FSDP_TOL relative RMS; no kernel launched."""
    import numpy as np

    r0 = ranks[0]
    if any(r["losses"] != r0["losses"] for r in ranks):
        raise AssertionError(f"{spec.label}: the ranks' losses differ")
    if not all(r["same_tp"] and r["same_dp"] for r in ranks):
        raise AssertionError(f"{spec.label}: replicated parameters part across ranks: "
                             f"{[(r['same_tp'], r['same_dp']) for r in ranks]}")
    for r in ranks:
        for res in (r, r["fsdp"] or {}):
            if any(res.get("counts", {}).values()):
                raise AssertionError(f"{spec.label}: a kernel launched on the training path: "
                                     f"{res['counts']}")
    acc = r0["twin_acc"]
    rms = float(np.sqrt(acc[0] / acc[1]))
    d_loss, d_xent = abs(r0["losses"][0] - twin["losses"][0]), abs(r0["xents"][0] - twin["xent0"])
    d_norm = abs(r0["norms"][0] / twin["norms"][0] - 1)
    out = dict(twin_losses=twin["losses"], twin_xent0=twin["xent0"], twin_rms=rms,
               twin_leaves_differing=int(acc[2]), d_loss0=d_loss, d_xent0=d_xent, d_norm0=d_norm,
               plain_median_ms=float(np.median(twin["times"][1:])) * 1e3)
    what = (f"step 0 loss {r0['losses'][0]:.5f} (twin {twin['losses'][0]:.5f}, |diff| {d_loss:.5f}),"
            f" cross-entropy {r0['xents'][0]:.5f} (twin {twin['xent0']:.5f}, |diff| {d_xent:.5f}), "
            f"grad norm {r0['norms'][0]:.4f} (twin {twin['norms'][0]:.4f}, ratio - 1 {d_norm:.2e}); "
            f"parameters after step 0 RMS {rms:.2e} of the twin's ({int(acc[2])} leaves not "
            f"bitwise); later losses {' '.join(f'{x:.5f}' for x in r0['losses'][1:])} (twin "
            f"{' '.join(f'{x:.5f}' for x in twin['losses'][1:])}); twin step ms "
            f"{' '.join(f'{1e3 * x:.1f}' for x in twin['times'])}")
    fs = r0["fsdp"]
    if fs is not None:
        fa = fs["first_acc"]
        f_rms = float(np.sqrt(fa[0] / max(fa[1], 1e-30)))
        f_loss = max(abs(a - b) for a, b in zip(fs["losses"], r0["losses"]))
        out.update(fsdp_rms=f_rms, fsdp_d_loss=f_loss, fsdp_leaves_differing=int(fa[2]))
        what += (f"; FSDP: losses {' '.join(f'{x:.5f}' for x in fs['losses'])} (largest |diff| "
                 f"{f_loss:.2e}), final parameters RMS {f_rms:.2e} of the run without it "
                 f"({int(fa[2])} leaves not bitwise)")
    log(f"[5/{spec.label}] tolerances: loss {MP_LOSS_TOL} nats, grad norm {MP_GNORM_TOL}, RMS "
        f"{MP_RMS_TOL}, FSDP {MP_FSDP_TOL}; {what}")
    if not (d_loss <= MP_LOSS_TOL and d_xent <= MP_LOSS_TOL):
        raise AssertionError(f"{spec.label}: step 0's loss parts from the twin's")
    if not d_norm <= MP_GNORM_TOL:
        raise AssertionError(f"{spec.label}: step 0's gradient norm parts from the twin's")
    if not rms <= MP_RMS_TOL:
        raise AssertionError(f"{spec.label}: the parameters after step 0 part from the twin's")
    if fs is not None and not (out["fsdp_d_loss"] <= MP_FSDP_TOL and out["fsdp_rms"] <= MP_FSDP_TOL):
        raise AssertionError(f"{spec.label}: FSDP storage parts from the run without it")
    return out


DIST_RANKS = {"ep-qwen36": (_ep_rank, _ep_check), "sp-recurrentgemma-2b": (_sp_rank, _sp_check),
              "pod-train-qwen36": (_pod_rank, _pod_check), "tp-qwen3-4b": (_tp_rank, _tp_check),
              "dp-train-qwen36": (_dpt_rank, _dpt_check),
              "mp-train-qwen36": (_mpt_rank, _mpt_check),
              "sp-train-qwen3-4b": (_mpt_rank, _mpt_check),
              "mp-rotary-qwen36": (_rot_rank, _rot_check)}
DIST_TWINS = {"mp-train-qwen36": _mp_twin, "sp-train-qwen3-4b": _mp_twin}


def dist_line(r: dict) -> str:
    """A sharded path's summary on one line (phase 6)."""
    head = f"{r['label']:>23}: {r['backend']}, {r['world']} ranks, mesh {r['mesh']}; "
    if r["label"] in ("ep-qwen36", "tp-qwen3-4b"):
        body = (f"prefill {r['prefill_ms']:.1f} ms ({r['prefill_tok_s']:.0f} tok/s), decode "
                f"{r['decode_tok_s']:.1f} tok/s ({r['step_ms']:.2f} ms a step); weights "
                f"{r['weight_gb']:.2f} GB a rank; logits RMS {r['rms_rel']:.5f} of the unsharded "
                f"run's, ids equal at {r['sure']} sure of {r['positions']}")
        if "cache_rms" in r:
            body += (f"; cache slices RMS {r['cache_rms']:.5f}, {r['cache_bitwise']} of "
                     f"{r['cache_slices']} bitwise")
    elif r["label"] == "dp-train-qwen36":
        body = (f"step {r['step_ms']:.1f} ms ({r['tok_s']:.0f} tokens/s; one process "
                f"{r['plain_median_ms']:.1f} ms), collectives {r['step_coll_ms']:.1f} ms a step "
                f"({r['coll_split']}); moments {r['moment_gb']:.2f} GB a rank of "
                f"{r['whole_moment_gb']:.2f} GB; losses {' '.join(f'{x:.4f}' for x in r['losses'])} "
                f"(one process {' '.join(f'{x:.4f}' for x in r['plain_losses'])})")
    elif r["label"] in DIST_TWINS:
        body = (f"step {r['step_ms']:.1f} ms ({r['tok_s']:.0f} tokens/s; one process "
                f"{r['plain_median_ms']:.1f} ms), collectives {r['step_coll_ms']:.1f} ms a step "
                f"({r['coll_split']}); weights {r['weight_gb']:.2f} GB and moments "
                f"{r['moment_gb']:.2f} GB a rank; step 0 loss |diff| {r['d_loss0']:.5f} of the "
                f"twin's, parameters RMS {r['twin_rms']:.2e}; losses "
                f"{' '.join(f'{x:.4f}' for x in r['losses'])} (twin "
                f"{' '.join(f'{x:.4f}' for x in r['twin_losses'])})")
        if r.get("fsdp_step_ms") is not None:
            body += (f"; FSDP: step {r['fsdp_step_ms']:.1f} ms, collectives "
                     f"{r['fsdp_step_coll_ms']:.1f} ms, weights {r['fsdp_weight_gb']:.2f} GB and "
                     f"moments {r['fsdp_moment_gb']:.2f} GB a rank, peak "
                     f"{r['fsdp_peak_gib']:.2f} GiB, RMS {r['fsdp_rms']:.2e} of the run without "
                     f"it")
    elif r["label"] == "mp-rotary-qwen36":
        body = "; ".join(
            f"{label} prefill {x['prefill_ms']:.1f} ms, decode {x['tok_s']:.2f} tok/s "
            f"({x['median_ms']:.1f} ms), misses {x['misses']}, replayed {x['replayed']} + "
            f"{x['prefill_replays']} chunks, collectives {x['coll_ms']:.1f} ms"
            for label, x in r["rot"].items())
        body += (f"; logits RMS {r['rms_rel']:.5f} of the unsharded twin's (median "
                 f"{r['rms_median']:.5f}), spec 4 logits bitwise spec 1: {r['spec4_bitwise']}")
    elif r["label"] == "sp-recurrentgemma-2b":
        body = (f"prefill {r['prefill_ms']:.1f} ms ({r['prefill_tok_s']:.0f} tok/s; unsharded "
                f"{r['unsharded_ms']:.1f} ms); logits max |diff| {r['max_abs']:.3e}, caches "
                f"{r['cache_max_abs']:.3e}, bitwise {r['bitwise']}")
    else:
        body = (f"step {r['step_ms']:.1f} ms ({r['tok_s']:.0f} tokens/s; uncompressed "
                f"{r['plain_median_ms']:.1f} ms), collectives {r['step_coll_ms']:.1f} ms a step; "
                f"losses {' '.join(f'{x:.4f}' for x in r['losses'])} (uncompressed "
                f"{' '.join(f'{x:.4f}' for x in r['plain_losses'])})")
    return (f"{head}{body}; peak {r['peak_gib']:.2f} GiB a rank, collectives "
            f"{r['coll_ms']:.1f} ms over {r['coll_calls']} calls")


def run_dist_path(dev, spec: DistSpec) -> dict:
    """Phases 4 and 5 for a sharded path: its ranks through
    ``distributed/world.py`` (a rank that fails or outlives DIST_TIMEOUT
    fails the path), each rank's kernel launches counted from a reset just
    before its work; the check against the unsharded run in this process
    after the world has exited (its memory freed). Every rank must launch
    the path's kernels: K3's fused entry and K1's tiled grouped entry on
    every ep rank, K4's chunk entry on every sp rank."""
    import numpy as np
    import torch

    from repro_torch.distributed.world import choose_backend, run_world

    import tempfile

    fn, check = DIST_RANKS[spec.label]
    nprocs = int(np.prod(spec.mesh))
    backend, _ = choose_backend("cuda", nprocs)          # run_world prints its choice
    log(f"[4/{spec.label}] {spec.arch}, mesh {dict(zip(spec.axes, spec.mesh))}, {nprocs} ranks")
    twin, args = None, (spec,)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_twin_") as tdir:
        if spec.label in DIST_TWINS:                     # the unsharded twin first, then freed
            t0 = time.perf_counter()
            path = os.path.join(tdir, "twin_params.pt")
            twin = DIST_TWINS[spec.label](dev, spec, path)
            args = (spec, path)
            log(f"  twin: one process, {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranks = run_world(fn, nprocs, args=args, device="cuda", timeout=DIST_TIMEOUT)
        world_s = time.perf_counter() - t0
    counts, symbols = {}, {}
    for r in ranks:
        for name, n in r["counts"].items():
            counts[name] = counts.get(name, 0) + n
        for name, syms in r["symbols"].items():
            for sym, n in syms.items():
                symbols.setdefault(name, {})[sym] = symbols.get(name, {}).get(sym, 0) + n
        need = {"ep-qwen36": ("router_topk", "slot_gmm_tiled", "decode_attention_partial"),
                "sp-recurrentgemma-2b": ("flash_attention_chunk",),
                "tp-qwen3-4b": ("flash_attention", "decode_attention_partial"),
                "mp-rotary-qwen36": ("router_topk", "slot_gmm", "slot_gmm_ragged",
                                     "decode_attention_partial", "flash_attention_chunk_partial"),
                }.get(spec.label, ())
        for entry in need:
            got = (entry_launches(r["symbols"], entry) if entry in ENTRY
                   else r["counts"][entry])
            if got <= 0:
                raise AssertionError(f"{spec.label}: rank {r['rank']} never launched {entry}")
    peak = max(r["peak_gib"] for r in ranks)
    coll_ms = max(r["coll_ms"] for r in ranks)
    summary = dict(label=spec.label, dist=True, counts=counts, symbols=symbols, backend=backend,
                   world=nprocs, mesh=dict(zip(spec.axes, spec.mesh)), world_s=world_s,
                   peak_gib=peak, coll_ms=coll_ms, coll_calls=ranks[0]["coll_calls"],
                   setup_s=max(r["setup_s"] for r in ranks))
    if spec.label in ("ep-qwen36", "tp-qwen3-4b"):
        pre = max(r["prefill_s"] for r in ranks)
        dec = max(r["decode_s"] for r in ranks)
        summary.update(prefill_ms=pre * 1e3, prefill_tok_s=spec.rows * spec.prompt / pre,
                       decode_tok_s=spec.rows * (spec.steps - 1) / dec,
                       step_ms=dec / (spec.steps - 1) * 1e3,
                       prefill_coll_ms=max(r["prefill_coll_ms"] for r in ranks),
                       weight_gb=ranks[0]["weight_gb"])
        what = (f"prefill {summary['prefill_ms']:.1f} ms ({summary['prefill_tok_s']:.0f} tok/s "
                f"over {spec.rows} x {spec.prompt}; collectives {summary['prefill_coll_ms']:.1f} "
                f"ms), decode {summary['decode_tok_s']:.1f} tok/s over {spec.rows} rows "
                f"({summary['step_ms']:.2f} ms a step), weights a rank "
                f"{summary['weight_gb']:.2f} GB")
        if spec.label == "tp-qwen3-4b":
            per = [(r["rank"], entry_launches(r["symbols"], "decode_attention_partial"),
                    r["counts"]["flash_attention"]) for r in ranks]
            summary["rank_launches"] = per
            what += "; K2 partial / K4 launches a rank " + ", ".join(
                f"rank {k}: {a} / {b}" for k, a, b in per)
    elif spec.label == "sp-recurrentgemma-2b":
        pre = max(r["prefill_s"] for r in ranks)
        summary.update(prefill_ms=pre * 1e3, prefill_tok_s=spec.prompt / pre)
        what = f"prefill {summary['prefill_ms']:.1f} ms of {spec.prompt} tokens"
    elif spec.label == "mp-rotary-qwen36":
        rot = {}
        for label, _, _ in ROT_RUNS:
            per = [r["runs"][label] for r in ranks]
            rot[label] = dict(
                prefill_ms=1e3 * max(p["prefill_s"] for p in per),
                tok_s=min(p["tok_s"] for p in per), median_ms=max(p["median_ms"] for p in per),
                coll_ms=max(p["coll_ms"] for p in per), coll_calls=per[0]["coll_calls"],
                prefill_coll_ms=max(p["prefill_coll_ms"] for p in per),
                peak_gib=max(p["peak_gib"] for p in per), coll_by=per[0]["coll_by"],
                **{k: per[0][k] for k in ("misses", "host_computed", "loads", "bytes_uploaded",
                                          "replayed", "prefill_replays", "prefill_chunks",
                                          "windows", "accepted", "drafted", "slot_gb",
                                          "weight_gb", "build_s")})
        summary["rot"] = rot
        what = "; ".join(
            f"{label}: prefill {r['prefill_ms']:.1f} ms ({r['prefill_chunks']} chunks, "
            f"{r['prefill_replays']} replayed; collectives {r['prefill_coll_ms']:.1f} ms), decode "
            f"{r['tok_s']:.2f} tok/s (median {'window' if label.endswith('spec4') else 'step'} "
            f"{r['median_ms']:.1f} ms; {r['replayed']} steps replayed, windows {r['windows']}), "
            f"misses {r['misses']}, loads {r['loads']}, collectives {r['coll_ms']:.1f} ms over "
            f"{r['coll_calls']} calls, slots {r['slot_gb']:.3f} GB and weights "
            f"{r['weight_gb']:.3f} GB a rank, peak {r['peak_gib']:.2f} GiB"
            for label, r in rot.items())
    else:
        times = ranks[0]["times"]
        med = float(np.median(times[1:]))
        summary.update(step_ms=med * 1e3, tok_s=spec.rows * spec.prompt / med, losses=ranks[0]["losses"],
                       step_coll_ms=float(np.median(ranks[0]["step_coll_ms"][1:])))
        by = ranks[0]["coll_by"]
        summary["coll_split"] = ", ".join(f"{n} {v[0]:.1f} ms / {v[1]} calls"
                                          for n, v in sorted(by.items()))
        if spec.label == "dp-train-qwen36":
            summary.update(moment_gb=ranks[0]["moment_gb"],
                           whole_moment_gb=ranks[0]["whole_moment_gb"])
        if spec.label in DIST_TWINS:
            fs = ranks[0]["fsdp"]
            summary.update(weight_gb=ranks[0]["weight_gb"], moment_gb=ranks[0]["moment_gb"],
                           fsdp_step_ms=None if fs is None else float(
                               np.median(fs["times"][1:])) * 1e3)
            if fs is not None:
                summary.update(fsdp_step_coll_ms=float(np.median(fs["step_coll_ms"][1:])),
                               fsdp_weight_gb=fs["weight_gb"], fsdp_moment_gb=fs["moment_gb"],
                               fsdp_peak_gib=max(r["fsdp"]["peak_gib"] for r in ranks),
                               fsdp_losses=fs["losses"])
        what = (f"median step {med * 1e3:.1f} ms ({summary['tok_s']:.0f} tokens/s over "
                f"{spec.rows} x {spec.prompt}), collectives {summary['step_coll_ms']:.1f} ms a "
                f"step; step ms {' '.join(f'{1e3 * x:.1f}' for x in times)}")
    log(f"  world {world_s:.1f} s (set-up {summary['setup_s']:.1f} s a rank); {what}; peak "
        f"{peak:.2f} GiB a rank; collectives {coll_ms:.1f} ms over {summary['coll_calls']} calls "
        f"(host-timed, {backend}); kernel launches {counts}")
    summary.update(check(dev, spec, ranks) if twin is None else check(dev, spec, ranks, twin))
    del ranks
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def cli_phase() -> dict:
    """``repro_torch.launch.serve.main`` once, in process: the batch engine
    on qwen36 at published widths, 2 layers, with ``--trace-out`` and
    ``--metrics-port`` (a free loopback port). Its trace must audit through
    ``repro_torch.obs``'s ``main`` with exit code 0 and its one scrape show
    the ``ttft_ms`` and ``itl_ms`` histograms."""
    import contextlib
    import io
    import re
    import socket

    from repro_torch.launch import serve
    from repro_torch.obs.audit import main as audit_main

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    out = TRACE_DIR / "cli.json"
    argv = ["--engine", "batch", "--arch", "qwen36-35b-a3b", "--full-width", "--layers", "2",
            "--batch-slots", "4", "--requests", "4", "--max-new", "8",
            "--trace-out", str(out), "--metrics-port", str(port)]
    log(f"[4/cli] python -m repro_torch.launch.serve {' '.join(argv)} (in process)")
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        serve.main(argv)
        rc = audit_main([str(out)])
    wall = time.perf_counter() - t0
    text = text.getvalue()
    for line in text.splitlines():
        if line.startswith(("stats:", "metrics:", "trace:", "audit:", "VIOLATION")):
            log(f"  {line}")
    hists = re.search(r"histograms (.*)$", text, re.M)
    names = set(hists.group(1).split(", ")) if hists else set()
    log(f"  {wall:.1f} s; audit exit code {rc}; histograms in the scrape: {sorted(names)}")
    if rc != 0 or not {"ttft_ms", "itl_ms"} <= names:
        raise AssertionError(f"the serve CLI: audit exit code {rc}, histograms {sorted(names)}")
    return dict(wall_s=wall, audit_rc=rc, histograms=sorted(names))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port package under {ROOT / 'src'}; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 1 ---------------------------------------------------------------
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2 ---------------------------------------------------------------
    from repro_torch.kernels.build import build

    t0 = time.perf_counter()
    logs = build()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")

    # phase 3 ---------------------------------------------------------------
    log("[3] kernels vs plain versions at the main path's shapes")
    rows = kernel_phase(dev)
    gc.collect()
    log(f"  device memory still allocated after phase 3: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    # phases 4 and 5, path by path -------------------------------------------
    from repro_torch.config import get_config
    from repro_torch.kernels import ops

    full = get_config("qwen36-35b-a3b")
    cfg = dataclasses.replace(full, segments=((("attn_moe",), LAYERS),))
    counts = {name: 0 for name in ops.KERNELS}
    symbols = {}
    done = {}

    def add(summary):
        done[summary["label"]] = summary
        for name, n in summary["counts"].items():
            counts[name] += n
        for name, syms in summary["symbols"].items():
            for sym, n in syms.items():
                symbols.setdefault(name, {})[sym] = symbols.get(name, {}).get(sym, 0) + n

    for path in PATHS:
        add(run_path(dev, cfg, full.num_layers, path, done))
    for spec in SERVE_PATHS:          # qwen36's cut, then each dense arch whole
        arch = get_config(spec.arch) if spec.arch else full
        add(run_serve_path(dev, arch if spec.arch else cfg, arch.num_layers, spec, done))
    for spec in FRONT_PATHS:
        arch = get_config(spec.arch)
        add(run_frontend_path(dev, dataclasses.replace(
            arch, segments=((arch.segments[0][0], spec.layers or arch.num_layers),)),
            arch.num_layers, spec))
    for spec in DECODE_PATHS:
        add(run_decode_path(dev, get_config(spec.arch), spec))
    for spec in TRAIN_PATHS:
        arch = get_config(spec.arch)
        if spec.layers:
            arch = dataclasses.replace(arch, segments=((arch.segments[0][0], spec.layers),))
        add(run_train_path(dev, arch, get_config(spec.arch).num_layers, spec))
    for spec in DIST_PATHS:
        add(run_dist_path(dev, spec))
    dbrx = get_config("dbrx-132b")
    add(run_path(dev, dataclasses.replace(dbrx, segments=((("attn_moe",), DBRX_LAYERS),)),
                 dbrx.num_layers, DBRX_PATH, done))
    cli_phase()
    n_paths = (len(PATHS) + len(SERVE_PATHS) + len(FRONT_PATHS) + len(DECODE_PATHS)
               + len(TRAIN_PATHS) + len(DIST_PATHS) + 1)
    multi = {counter for counter, _ in ENTRY.values()}          # kernels with several entries
    log(f"  kernel launches over the {n_paths} paths: {counts}; by entry: "
        f"{ {name: syms for name, syms in symbols.items() if name in multi and syms} }")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on any path")

    # phase 6 ---------------------------------------------------------------
    log(f"[6] {card}: paths side by side (decode tok/s per request, over all its new tokens "
        "and over those after the first step or window, whose time holds the graph's capture on a "
        "path's first request; median step or window ms after it; prefill ms; steps replayed / "
        "relaunched of decode steps; MB uploaded per decode token; host conversion; loads; "
        "overlapped pulls; windows and accept rate)")
    for r in done.values():
        if r["label"].startswith("serve-") or r.get("frontend") or r.get("train") or r.get("dist"):
            continue
        accept = f"{r['accept_rate']:.3f}" if r["accept_rate"] is not None else "-"
        log(f"  {r['label']:>19}: decode {' / '.join(f'{x:.2f}' for x in r['tok_s'])} tok/s "
            f"({' / '.join(f'{x:.2f}' for x in r['steady_tok_s'])} after the first {r['unit']}, "
            f"median {r['unit']} {' / '.join(f'{x:.2f}' for x in r['median_ms'])} ms), "
            f"prefill {' / '.join(f'{x:.1f}' for x in r['prefill_ms'])} ms, replayed "
            f"{r['replayed']} relaunched {r['relaunched']} of {r['steps']}, "
            f"{r['mb_per_token']:.2f} MB/token, host conversion {r['host_convert_s']:.3f} s over "
            f"{r['host_converted']} experts, misses {r['misses']}, loads {r['loads']}, graph "
            f"replays {r['replays']}, overlapped pulls {r['overlapped_pulls']}, windows "
            f"{r['windows']} accept rate {accept}, prefetch launched {r['prefetch_launched']} "
            f"hits {r['prefetch_hits']}, prefill chunks {r['prefill_chunks']} replayed "
            f"{r['prefill_replays']}, peak {r['peak_gib']:.2f} GiB")
    log(f"  {card}: serving paths (aggregate tok/s; TTFT and ITL p50 / p99 ms; windows, spec "
        "windows, accept rate; misses per token; pages high-water; MB uploaded per token; peak; graph "
        "captures and their ms)")
    for spec in SERVE_PATHS:
        r = done[spec.label]
        log(f"  {r['label']:>19}: {r['tok_s']:.1f} tok/s, TTFT {r['ttft'][0]:.1f} / "
            f"{r['ttft'][1]:.1f} ms, ITL {r['itl'][0]:.2f} / {r['itl'][1]:.2f} ms, windows "
            f"{r['windows']} spec {r['spec_windows']} accept {r['accept_rate']:.3f}, misses/token "
            f"{r['misses_per_token']:.3f}, pages hwm {r['hwm']}, {r['mb_per_token']:.2f} MB/token, "
            f"peak {r['peak_gib']:.2f} GiB, {r['graphs']} graphs in {r['capture_ms']:.0f} ms, "
            f"median tick {r['tick_ms']:.2f} ms")
    log(f"  {card}: frontend paths (prefill ms of frontend + prompt positions; decode tok/s and "
        f"median step ms of decode_model, one pull a step; peak)")
    for spec in FRONT_PATHS + DECODE_PATHS:
        r = done[spec.label]
        log(f"  {r['label']:>19}: prefill {r['prefill_ms']:.1f} ms, decode {r['tok_s']:.2f} tok/s "
            f"(median step {r['median_ms']:.2f} ms), peak {r['peak_gib']:.2f} GiB")
    log(f"  {card}: training paths (median step ms, tokens/s, MFU over 989 TFLOP/s, peak; "
        f"step 0 loss and grad norm beside f32; checkpoint MB, snapshot / write / restore ms)")
    for spec in TRAIN_PATHS:
        r = done[spec.label]
        log(f"  {r['label']:>23}: step {r['median_ms']:.1f} ms ({r['writing_ms']:.1f} while the "
            f"checkpoint writes), {r['tok_s']:.0f} tokens/s, MFU "
            f"{100 * r['mfu']:.2f}%, peak {r['peak_gib']:.2f} GiB; loss {r['loss0']:.4f} (f32 "
            f"{r['loss0_f32']:.4f}) -> {r['losses'][-1]:.4f}, grad norm {r['gnorm0']:.4f} (f32 "
            f"{r['gnorm0_f32']:.4f}); checkpoint {r['ckpt_mb']:.0f} MB, {r['save_ms']:.0f} / "
            f"{r['write_ms']:.0f} / {r['restore_ms']:.0f} ms")
    log(f"  {card}: sharded paths (backend, ranks, mesh; tokens/s or ms; peak GiB a rank; "
        f"collective ms, host-timed; the check against the unsharded run)")
    for spec in DIST_PATHS:
        log(f"  {dist_line(done[spec.label])}")
    log(f"  {card}: traces of the engine paths (units checked, miss-free; launches, pulls, "
        f"rotations, prefetch spans, KV events; events recorded; overlap ms from the spans / "
        f"stats.overlap_ms; MB; 0 violations on every path)")
    for r in done.values():
        t = r.get("trace")
        if t is None:
            continue
        twin = (f", median step {r['median_ms'][0]:.4f} ms traced / "
                f"{t['untraced_median_ms']:.4f} untraced" if "untraced_median_ms" in t else "")
        log(f"  {r['label']:>23}: {t['units_checked']} units, {t['miss_free_units']} miss-free; "
            f"{t['launches']} / {t['pulls']} / {t['rotations']} / {t['prefetch_spans']} / "
            f"{t['kv_events']}; {t['events']} events; {t['overlap_ms_from_spans']:.3f} / "
            f"{t['overlap_stats_ms']:.3f} ms; {t['trace_mb']:.2f} MB{twin}")
    for name in ("decode_attention", "decode_attention_paged", "decode_attention_partial",
                 "flash_attention_chunk_partial"):
        if entry_launches(symbols, name) <= 0:
            raise AssertionError(f"entry {name} never launched on any path")
    kernels = []
    for name, r in rows.items():
        base = r.get("base", name)             # a row at a new width: the kernel or entry it is of
        counter, prefix = ENTRY.get(base, (base, None))
        row = {
            "name": name, "route": "cuda", "source": SOURCE[base], "replaces": REPLACES[base],
            "launches": counts[counter], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
        }
        if prefix:            # an entry of K3 or K1's tiled body: its own launches beside the kernel's
            row["entry_launches"] = entry_launches(symbols, base)
        paths = width_paths(name)
        if paths is not None:  # the launches of the paths that run this width (and no other)
            row["width_launches"] = sum(
                entry_launches(done[p]["symbols"], base) if prefix else done[p]["counts"][counter]
                for p in paths)
        for key in ("three_call_ms", "three_call_device_ms", "gather_k2_ms", "gather_k2_device_ms",
                    "contiguous_ms", "contiguous_device_ms"):
            if key in r:
                row[key] = r[key]
        if "prefill" in r:
            row["prefill"] = {key: r["prefill"][key] for key in (
                "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
                "library_device_ms", "three_call_ms", "three_call_device_ms", "bound_ms",
                "bound_by")}
        kernels.append(row)
    log(f"  done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
