"""K3, the router gate on the card (``csrc/topk_gate.cu``), two entries with
one launch count (``KERNEL``, named ``topk_gate``):

* :func:`topk_gate`: logits [T, E] f32 -> (ids, weights), the counterpart
  of ``repro/kernels/topk_gate.py:topk_gate`` (Pallas ``_topk_kernel``);
* :func:`router_topk`: the MoE input h2 [T, D] and the f32 router [D, E]
  -> (ids, weights), the router GEMM (``repro/models/moe.py:router_logits``)
  and the gate in one launch; the model's routing sites call this.

Both select on the probabilities, k rounds of argmax with the lowest index
winning ties, then the optional renormalization. The fused entry's plan
(:func:`router_plan`: how D is cut into the spans of one thread block
cluster) reads D and E only, and the row tile (:func:`router_tile`) sets
only how many rows share a block's loads, so a row's ids and weights have
the same bits whatever T. Bound: bytes at decode (the 1 MiB router),
f32 operations at prefill (2 T D E). Plain versions:
``kernels.ref.topk_gate_ref`` and ``kernels.ref.router_topk_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("topk_gate", "topk_gate.cu", {
    "topk_gate_f32": [_P, _I, _I, _I, _I, _P, _P],
    # x, router, T, D, E, k, normalize, splits, span, R, CV, rows, etiles,
    # ecols, workspace, counters, ids, weights
    "router_topk_bf16": [_P, _P] + [_I] * 12 + [_P, _P, _P, _P],
    "router_topk_f32": [_P, _P] + [_I] * 12 + [_P, _P, _P, _P],
})

ROUTER_CHUNK = 32          # router rows per ring stage (RT_CHUNK)
ROUTER_MAX_SPLITS = 16     # the blocks of one cluster (RT_MAXSPLITS)
ROUTER_THREADS = 256       # a block (RT_THREADS)
ROUTER_MAX_E = 1024        # one row group of 4 columns a thread spans E (RT_MAXE)


@dataclasses.dataclass(frozen=True)
class RouterPlan:
    """How the fused entry cuts the router: ``splits`` spans of ``span`` rows
    of D (a multiple of the 32-row chunk), one block each, in one cluster;
    ``etiles`` > 1 cuts E into tiles of ``ecols`` columns (the E-split
    variant, a sweep option)."""
    splits: int
    span: int
    etiles: int = 1
    ecols: int = 0


@functools.lru_cache(maxsize=None)
def router_plan(d: int, e: int) -> RouterPlan:
    """The spans of D: as many as a cluster holds (16) in whole 32-row
    chunks; at D 2048 that is 16 spans of 128 rows (64 KB of the f32 router
    at E 128, all in flight at once). Reads D and E only, never T."""
    chunks = -(-d // ROUTER_CHUNK)
    span = -(-chunks // ROUTER_MAX_SPLITS) * ROUTER_CHUNK
    return RouterPlan(-(-d // span), span, 1, e)


@functools.lru_cache(maxsize=None)
def router_tile(t: int, e: int) -> Tuple[int, int, int]:
    """(R, CV, rows): each thread sums R rows x CV columns, and a block takes
    a tile of ``rows`` rows (as many row groups as 256 threads hold). At
    decode one column a thread (T <= 2, or two rows a thread up to T = 4),
    so a span's chain is spread over E threads; from T = 5 on 4 columns a
    thread and 2 rows, 4 from 32 rows on (prefill: 32-row tiles at E 128,
    16 tiles x 16 spans = 256 blocks at T = 512, the fastest tile of the
    sweep). Changes which rows share a block's loads, never the order of a
    row's sums."""
    ldw = -(-e // 4) * 4
    if t <= 2 and t * ldw <= ROUTER_THREADS:
        return 1, 1, t
    if t <= 4 and 2 * ldw <= ROUTER_THREADS:
        return 2, 1, 4
    groups = ROUTER_THREADS // (ldw // 4)
    r = 1 if t <= 4 else 2 if t < 32 else 4
    return r, 4, max(1, min(-(-t // r), groups)) * r


def topk_gate(
    logits: torch.Tensor, k: int, *, normalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] f32 on a CUDA device -> (ids int32 [T, k], weights f32 [T, k])."""
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gate launches on a CUDA tensor, got {logits.device}")
    if logits.dim() != 2:
        raise ValueError(f"logits must be [T, E], got {tuple(logits.shape)}")
    t, e = logits.shape
    if not 1 <= k <= e:
        raise ValueError(f"k={k} outside [1, E={e}]")
    logits = logits.float().contiguous()
    ids = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    w = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    if t:
        KERNEL("topk_gate_f32", logits.device, logits.data_ptr(), t, e, k,
               int(normalize), ids.data_ptr(), w.data_ptr())
    return ids, w


def router_topk(
    h2: torch.Tensor, router: torch.Tensor, k: int, *, normalize: bool = True,
    plan: Optional[RouterPlan] = None, tile: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h2 [T, D] bf16/f32 and router [D, E] f32, both contiguous on one CUDA
    device -> (ids int32 [T, k], weights f32 [T, k]) of
    ``topk_gate(h2.float() @ router, k)``, in one launch. ``plan`` and
    ``tile`` override :func:`router_plan` / :func:`router_tile` (sweeps)."""
    if h2.device.type != "cuda" or router.device != h2.device:
        raise ValueError(f"router_topk launches on CUDA tensors of one device, got "
                         f"{h2.device} and {router.device}")
    if h2.dtype not in (torch.bfloat16, torch.float32) or router.dtype != torch.float32:
        raise ValueError(f"router_topk takes bf16/f32 h2 and an f32 router, got {h2.dtype} "
                         f"and {router.dtype}")
    if h2.dim() != 2 or router.dim() != 2 or router.shape[0] != h2.shape[1]:
        raise ValueError(f"h2 [T, D] and router [D, E] expected, got {tuple(h2.shape)} and "
                         f"{tuple(router.shape)}")
    if not (h2.is_contiguous() and router.is_contiguous()):
        raise ValueError("router_topk takes contiguous h2 and router")
    t, d = h2.shape
    e = router.shape[1]
    if not 1 <= k <= e or e > ROUTER_MAX_E:
        raise ValueError(f"router_topk takes 1 <= k <= E <= {ROUTER_MAX_E}, got k={k}, E={e}")
    plan = plan or router_plan(d, e)
    r, cv, rows = tile or router_tile(t, e)
    dev = h2.device
    ids = torch.empty((t, k), dtype=torch.int32, device=dev)
    w = torch.empty((t, k), dtype=torch.float32, device=dev)
    ws = counters = None
    if plan.etiles > 1:                   # E-split: merged logits, a zeroed counter a row tile
        ws = torch.empty((t, e), dtype=torch.float32, device=dev)
        counters = torch.zeros(-(-t // rows), dtype=torch.int32, device=dev)
    if t:
        KERNEL("router_topk_bf16" if h2.dtype == torch.bfloat16 else "router_topk_f32", dev,
               h2.data_ptr(), router.data_ptr(), t, d, e, k, int(normalize), plan.splits,
               plan.span, r, cv, rows, plan.etiles, plan.ecols,
               0 if ws is None else ws.data_ptr(), 0 if counters is None else counters.data_ptr(),
               ids.data_ptr(), w.data_ptr())
    return ids, w
