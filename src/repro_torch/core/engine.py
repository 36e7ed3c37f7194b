"""RotaryEngine on the card: the paper's engine with rotary expert residency.

The counterpart of ``repro/core/engine.py``: prefill by the legacy walk or
in chunks (``prefill_chunk=C``), greedy or sampled decode on the fused step
(synchronous, or with predictive prefetch and the miss relaunch,
``prefetch=True``), speculative windows (``spec_k > 1``), the per-layer hot
walk (``fused_decode=False``) and the per-layer sync walk
(``host_routing=True``, LRU residency). The full model
weights live in host memory (pinned); only attention / router / embedding
weights, the KV caches and each MoE layer's slot group are device-resident.

* **Prefill** walks the layers once over the whole prompt (the reference's
  ``_run_layers``): attention (flash-attention kernel), router + top-k gate
  kernel, one sync to pull the routing, LUT resolve on the host, the routed
  experts through the slot stores (grouped-matmul kernel), host correction
  of misses, and pre-gating of the next MoE layer from this layer's hidden.
  It writes the engine's own KV caches in place (allocated once, at start).
* **Chunked prefill** (``prefill_chunk=C``, a power of two;
  ``prefill_chunk_plan``) ingests the prompt in chunks appended to the same
  caches (K4's chunk-append entry, ``cur_len`` a device scalar) whose MoE
  half sorts the picks by slot on the device (K1's ragged entry): the fused
  engine launches one CUDA graph per chunk length (the head only on the
  last chunk), one blocking pull a chunk, and replays a missed chunk's
  suffix per layer (``_replay_prefill_chunk``); the walking engines, and a
  windowed cache, walk the same chunks layer by layer. Both rotate once per
  chunk boundary through the same demand program, so their logits and KV
  are bit-identical. Chunks never wrap the cache (a longer prompt takes the
  legacy walk); the engine checks that on the host before every launch.
* **Decode** runs ONE fused step per token over every layer
  (``tfm.decode_model``: decode-attention kernel, gate kernel, grouped-matmul
  kernel per layer) plus the on-device demand GEMM for the next step's
  rotation: the counterpart of ``build_fused_decode_step``. On the card the
  step is captured once per engine as a CUDA graph and REPLAYED every token:
  its inputs (token, ``cur_len``) sit in a static device buffer the host
  fills first, and everything it reads (planes, device LUTs, caches) keeps
  its address; a replay whose inputs moved raises, as does a failed capture
  (there is no eager fall back). The first capture's warm-up is the step the
  engine needed anyway. On the CPU the same step runs eagerly. The routing
  telemetry goes to pinned host buffers with non-blocking copies queued
  after the replay, before the logits pull, which is the one blocking read
  of a miss-free token (``stats.sync_pulls``).
* **Exactness under misses** is the reference's suffix REPLAY: when the
  step's miss masks show a routed expert was not resident, the layers from
  the first missed one re-run per layer from the step's saved block input
  (``route_x``) against the same residency, host-correcting each miss
  (``_host_correct``). Re-running attention rewrites the same KV slot in
  place, so the post-step cache is a valid replay substrate.
* **The miss relaunch** (``prefetch=True``): the telemetry names the missed
  experts exactly, so ``ensure_resident`` uploads them and the whole step
  runs again (a second graph replay at the same ``cur_len``), up to twice;
  the suffix replay remains the fall back when the slots cannot cover a
  layer's routed set or misses persist, as in the reference.
* **Rotation** runs strictly after the step and its replay or relaunch
  (``rotate_from_telemetry``). Synchronous uploads go on the compute stream,
  so a slot is never overwritten while a queued step still reads it. With
  ``prefetch=True``, right after the replay is issued ``begin_prefetch``
  ships the predicted next transition's uploads into a shadow generation of
  the slot planes on a copy stream, and the boundary corrects, catches up and
  flips it; the next replay waits on the copy stream.
* **Speculative windows** (``spec_k = K > 1``): ``K`` self-drafted positions
  (``tfm.decode_window``, argmax drafting on the device) against one
  residency, each window size one CUDA graph captured on first use, sharing
  the step's static inputs, caches and planes; one launch and one blocking
  pull per window. When the window's KV may need a rollback (misses are
  possible and corrected), the graph's first operation gathers the K slots
  it will write (``tfm.snapshot_kv_window``). The first position with a miss
  (``j*``) rejects the rest: the KV slots after it are restored
  (``tfm.rollback_kv_window``, eager: it depends on ``j*``) and position
  ``j*`` replays like a missed step; with ``prefetch=True`` the window is
  first relaunched with each layer's routed union made resident. Rotation
  runs at the window boundary (``rotate_window_from_telemetry``).
* **The per-layer hot walk** (``fused_decode=False``): per layer, attention
  and routing, the routing copied to pinned memory behind an event, the MoE
  half queued, then the host waits on the event only (not on the MoE half)
  and pre-gates the next layer; one blocking pull per miss-free token. A miss
  replays the suffix per layer from the walk's saved layer input
  (``_replay_step``) against the residency each layer gathered from: the one
  transition that would change a layer the step has already read (the last
  layer pre-gating layer 0) runs after the pull and any replay.
* **Sampled decode** (``decode(sampler=...)`` or ``greedy=False``) keys
  every draw by its cache position (``models/sampling.py``: JAX's threefry
  keys and bits as torch integer ops). The fused engine always runs the
  window family (size-1 windows at ``spec_k`` 1, each window size and
  sampler one CUDA graph reading the static per-row keys): the window draws
  its drafts on the device and accepts by ``stochastic_accept`` over the
  pulled distributions; the draw between windows runs on the device too
  (one CUDA graph per sampler), so spec-K and single-token streams are the
  same. The walks draw between their steps, through the same graph.
* **The per-layer sync walk** (``host_routing=True``, or a policy that
  resolves misses mid-step such as LRU): the prefill walk at decode, one
  blocking routing pull per layer; host routing pulls the router logits and
  picks the top-k on the host (the seed engine, kept as the baseline), LRU
  answers each miss with a blocking upload and rewrites the device LUT in
  place before the MoE half, both on the compute stream.

Tokens do not depend on residency: a miss is corrected exactly on the host
(or relaunched miss-free), so every path and residency, with or without
prefetch, windows or chunks, emits the same greedy tokens and, for a seed,
the same sampled ones.

Quantized stores (``ResidencyConfig.quantization`` int8 / int4): the
warehouse is quantized once, at start, into packed planes in pinned memory
(on the card, one layer at a time), and the float warehouse is not kept.
Uploads ship packed rows, the grouped-matmul kernel reads them straight from
the slots, and a miss dequantizes only its expert from the packed warehouse
with the plain version's arithmetic, so it adds what a resident slot would
have computed and full and rotary residency still emit the same tokens.

The walks, and the replays of a missed step or chunk, run eagerly, layer by
layer (the reference jits each half).

**Over a mesh** (``rt.mesh`` with a tensor axis, ``torch.distributed``; one
engine a rank, every rank of the tensor axis fed the same prompts): each
rank holds its shard of every non-expert leaf (``tfm.shard_params``:
attention by heads, the vocabulary split), its slice of every KV cache by
sequence (``tfm._sharded_zero_state``), and its slice of the expert width F
in the warehouse and every slot (``RotaryResidencyManager(shard=)``; the
reference's ``_residency_shardings``). Chunked prefill, the fused step and
speculative windows run the sharded model functions (``_tp_chunk``,
``_tp_decode``, the slots' partial sums and one f32 all-reduce a MoE layer);
a miss is corrected on every rank alike, each rank's host GEMM over its F
slice and one f32 all-reduce of the correction, then the suffix replay
through the sharded layers. Routing reads all-reduced hiddens, so every
rank sees the same telemetry and makes the same transitions (rotation is
synchronous). Nothing is captured: gloo's collectives cannot be. What is
not ported under a mesh raises in ``__init__``: host routing, LRU, the hot
walk, prefetch, int8 / int4 slots, the legacy prefill walk (no
``prefill_chunk``), rows split over a data axis, a ring cache.
"""
from __future__ import annotations

import functools
import gc
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config.base import ModelConfig, ResidencyConfig
from repro_torch.core.policies import make_policy
from repro_torch.core.predictor import DemandPredictor, host_topk_route
from repro_torch.core.residency import RotaryResidencyManager
from repro_torch.core.stats import EngineStats
from repro_torch.core.transfer import CostModel, TransferClock
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sampling as sampling_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params
from repro_torch.models.transformer import Runtime
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import resolve_tracer
from repro_torch.quant import dequantize_int4
from repro_torch.models.sampling import SampleParams
from repro_torch.serving.sampler import SamplerConfig, greedy_accept, stochastic_accept


def _host_ffn(hw: Dict[str, torch.Tensor], e: int, x: torch.Tensor,
              scratch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, float]:
    """Host expert GEMM in f32 (the paper's CPU-resident expert execution):
    x [n, D] f32 on the host -> ([n, D], seconds spent converting weights).
    The reference's ``_np_ffn`` in torch CPU ops, so the host path runs on one
    thread pool. Only the missed expert leaves the warehouse, converted into
    ``scratch`` (one f32 buffer per weight tensor, reused across calls) as the
    plain grouped matmul sees it: int4 dequantized (``q * s + m``), int8 as
    its integers with the per-channel scale applied to the product."""
    t0 = time.perf_counter()
    w: Dict[str, torch.Tensor] = {}
    for name in ("w_gate", "w_up", "w_down"):
        if name not in hw:
            continue
        buf = scratch.get(name)
        if buf is None:
            shape = tuple(hw[name].shape[1:])
            if f"min_{name}" in hw:                     # int4 rows are packed two a byte
                shape = shape[:-2] + (2 * shape[-2], shape[-1])
            buf = scratch[name] = torch.empty(shape, dtype=torch.float32)
        if f"min_{name}" in hw:
            w[name] = buf.copy_(dequantize_int4(hw[name][e], hw[f"scale_{name}"][e],
                                                hw[f"min_{name}"][e]))
        else:
            w[name] = buf.copy_(hw[name][e])
    convert_s = time.perf_counter() - t0

    def mm(a: torch.Tensor, name: str) -> torch.Tensor:
        y = a @ w[name]
        if hw[name].dtype == torch.int8:
            y = y * hw[f"scale_{name}"][e]
        return y

    if "w_gate" in hw:
        g = mm(x, "w_gate")
        h = (g / (1.0 + torch.exp(-g))) * mm(x, "w_up")
    else:
        u = mm(x, "w_up")
        h = 0.5 * u * (1.0 + torch.tanh(math.sqrt(2 / math.pi) * (u + 0.044715 * u**3)))
    return mm(h, "w_down"), convert_s


def host_correct(x: torch.Tensor, h2: torch.Tensor, ids: np.ndarray, weights: np.ndarray,
                 miss: np.ndarray, hw: Dict[str, torch.Tensor],
                 scratch: Dict[str, torch.Tensor],
                 group=None) -> Tuple[torch.Tensor, int, float, int]:
    """Exact host GEMM correction of a layer's missed picks (the reference's
    ``_host_correct``, shared by both engines): ``x`` [.., D] on the device
    plus, per missed pick ``(t, j)`` of ``miss`` [T, k], its routing weight
    times the pick's expert FFN of ``h2`` row t, computed on the host from
    the warehouse ``hw`` (one GEMM per missed expert over all its rows, summed
    in pick order). ``group`` (the tensor axis; ``hw`` this rank's slice of
    the expert width): each rank's correction is a partial sum, summed over
    the group in f32 on the device before it is added. Returns (x, picks
    corrected, seconds converting weights, experts converted)."""
    h2_host = h2.detach().cpu().float().reshape(ids.shape[0], -1)
    corr = torch.zeros_like(h2_host)
    picks = list(zip(*np.nonzero(miss)))
    by_expert: Dict[int, List[Tuple[int, int]]] = {}
    for t_i, j in picks:
        by_expert.setdefault(int(ids[t_i, j]), []).append((t_i, j))
    outs: Dict[Tuple[int, int], torch.Tensor] = {}
    convert = 0.0
    for e, tj in by_expert.items():
        y, convert_s = _host_ffn(hw, e, h2_host[[t_i for t_i, _ in tj]], scratch)
        convert += convert_s
        outs.update(zip(tj, y))
    for t_i, j in picks:
        corr[t_i] += float(weights[t_i, j]) * outs[(t_i, j)]
    corr = corr.to(device=x.device)
    if group is not None:
        dist.all_reduce(corr, group=group)
    x = x + corr.to(dtype=x.dtype).reshape(x.shape)
    return x, len(picks), convert, len(by_expert)


def demand_program(h_all: torch.Tensor, routers_next: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pre-gating demand program over stacked per-layer MoE inputs
    h_all [L, T, D] and the next layers' routers [L, D, E]:
    ``softmax(h_l @ R_{l+1})`` averaged over tokens, [L, E] (the
    reference's in-graph demand GEMM, ``_demand_aux_fn``). ``rows`` (a
    device scalar) averages over the first ``rows`` tokens only: the serving
    engine runs every window at its full row count and averages over the
    rows bucket the reference's window would have run."""
    probs = torch.softmax(torch.einsum("ltd,lde->lte", h_all.float(), routers_next), dim=-1)
    if rows is None:
        return probs.mean(dim=1)
    keep = (torch.arange(probs.shape[1], device=probs.device) < rows).to(probs.dtype)
    return (probs * keep[None, :, None]).sum(dim=1) / rows.to(probs.dtype)


def window_outputs(cfg: ModelConfig, params: Params, tok: torch.Tensor, state: Any,
                   cur: torch.Tensor, k: int, residency: Any,
                   aux_fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]], *,
                   snapshot: bool, sample: Optional[SampleParams] = None,
                   keys: Optional[torch.Tensor] = None,
                   page_table: Optional[torch.Tensor] = None,
                   rt: Optional[Runtime] = None) -> Dict[str, Any]:
    """A ``k``-position window on the device, the body both engines capture
    (the counterpart of ``build_window_fns``): first, with ``snapshot``, the
    pre-window contents of the KV slots it writes (``saved``); then
    ``tfm.decode_window``, drafting by argmax or, with ``sample``, by
    position-keyed draws from ``keys``. ``page_table`` (the serving engine):
    ``state`` is the paged pool and ``cur`` per row. Outputs: ``draft``
    [K, B], ``logits`` [K, B, V] f32, the telemetry stacked [K, L, ...] and,
    sampled, ``sample_probs`` / ``sample_p``. ``rt`` (a mesh): the sharded
    window over this rank's cache slices and shards."""
    out: Dict[str, Any] = {}
    if snapshot:
        out["saved"] = tfm.snapshot_kv_window(state, cur, k, page_table=page_table, rt=rt)
    draft, logits, aux = tfm.decode_window(cfg, params, tok, state, cur, k, residency,
                                           aux_fn=aux_fn, sample=sample, rng_keys=keys,
                                           page_table=page_table, rt=rt)
    return {**out, "draft": draft, "logits": logits, **aux}


def _pinned(lead: Tuple[int, ...], **shapes) -> Dict[str, torch.Tensor]:
    """Host buffers for telemetry, pinned where a card is present:
    ``name=(tail shape, dtype)``, each ``lead + tail``."""
    pin = torch.cuda.is_available()
    return {n: torch.empty(lead + tail, dtype=dt, pin_memory=pin)
            for n, (tail, dt) in shapes.items()}


def resolve_device(device) -> torch.device:
    """``cuda`` unless told otherwise; a requested card that is missing is
    an error, never a quiet fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available; "
                           "pass device='cpu' to run the plain path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def prefill_chunk_plan(s: int, chunk: int) -> List[int]:
    """Split a prompt of ``s`` tokens into power-of-two chunk lengths.

    ``chunk`` (itself a power of two) repeats while the remainder allows, then
    the tail decomposes into descending powers of two, so a prompt of any
    length takes at most ``log2(chunk)`` distinct chunk lengths beyond the
    steady one: the number of CUDA graphs chunked prefill captures."""
    if s < 1:
        raise ValueError("empty prompt")
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"prefill_chunk must be a power of two, got {chunk}")
    plan = [chunk] * (s // chunk)
    rem, bit, bits = s - chunk * (s // chunk), 1, []
    while rem:
        if rem & 1:
            bits.append(bit)
        rem >>= 1
        bit <<= 1
    return plan + sorted(bits, reverse=True)


@dataclass
class _Graph:
    """One captured launch (the decode step, one window size and sampler, or
    one prefill chunk length with or without the head): the graph, its
    outputs, the addresses it reads and the kernel launches one replay
    makes."""

    graph: Any
    out: Dict[str, Any]
    ptrs: Tuple[int, ...]
    launches: Dict[str, Dict[str, int]]


class GraphSet:
    """The captured launches of one engine, one CUDA graph per key (a
    window size, a rows bucket, a sampler, a chunk length): :meth:`launch`
    captures a body on its key's first use and replays it after, checking
    first that nothing it reads has moved. ``capture`` False runs every body
    eagerly (the CPU, and the card's graph-against-eager tests)."""

    def __init__(self, capture: bool):
        self.capture = capture
        self.graphs: Dict[Any, _Graph] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0                  # wall s of first uses: the warm-up and the capture

    def launch(self, key: Any, body: Callable[[], Dict[str, Any]],
               ptrs: Callable[[], Tuple[int, ...]]) -> Dict[str, Any]:
        """Run ``body`` once: eagerly, or a replay of ``key``'s graph
        (captured now on first use). ``ptrs()`` lists the addresses of
        everything a replay reads besides the weights; a replay whose
        addresses moved since the capture raises."""
        if not self.capture:
            return body()
        g = self.graphs.get(key)
        if g is None:
            return self._capture_graph(key, body, ptrs())
        if ptrs() != g.ptrs:
            raise RuntimeError("captured graph: a plane, LUT, cache or input it reads has moved "
                               "since the capture")
        g.graph.replay()
        ops.add_launches(g.launches)
        self.replays += 1
        return g.out

    def _capture_graph(self, key: Any, body: Callable[[], Dict[str, Any]],
                       ptrs: Tuple[int, ...]) -> Dict[str, Any]:
        """Capture ``body`` as a CUDA graph. Its warm-up, eager on the compute
        stream (the kernels' first launches set their attributes there), IS
        this launch, whose outputs are returned; the capture launches nothing.
        A capture that fails raises (the launch has no eager fall back).
        Python's cyclic garbage collector is off while capturing: a dead
        engine's graphs it freed then would destroy CUDA graphs mid-capture,
        which invalidates the capture."""
        t0 = time.perf_counter()
        out = body()
        before = ops.symbol_launch_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                graph_out = body()
        finally:
            if collecting:
                gc.enable()
        launches = ops.launches_since(before)
        ops.add_launches(launches, -1)     # recorded, not launched
        self.graphs[key] = _Graph(graph, graph_out, ptrs, launches)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return out


class RotaryEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        rescfg: ResidencyConfig,
        *,
        rt: Optional[Runtime] = None,
        cost: Optional[CostModel] = None,
        batch: int = 1,
        seed: int = 0,
        host_routing: bool = False,
        fused_decode: Optional[bool] = None,
        spec_k: int = 1,
        prefetch: bool = False,
        prefill_chunk: Optional[int] = None,
        trace=None,
        device="cuda",
    ):
        """``params`` as ``tfm.init_params`` or ``bridge.from_reference``
        build them. Attention, router and embedding weights move to
        ``device``; the routed experts stay in (or move to) host memory, the
        warehouse. ``cost`` defaults to a link figure measured on the card at
        start, or to an unmeasured model on the CPU. ``prefetch=True`` turns
        on double-buffered predictive prefetch and the miss relaunch (full
        residency accepts the flag and builds no shadow); ``False`` keeps
        the synchronous rotation path, the exactness baseline.

        The decode-path switches, with the reference's rules:
        ``fused_decode=None`` takes the fused step when the routing is on the
        device and the policy resolves no miss mid-step, else the per-layer
        walk; ``False`` forces the per-layer hot walk; ``True`` requires the
        fused step. ``host_routing=True`` routes every layer on the host
        (the seed baseline; the sync walk). ``spec_k = K > 1`` decodes in
        K-position windows, which ride the fused step. ``prefill_chunk=C``
        (a power of two) ingests prompts in chunks of at most C tokens
        (``prefill_chunk_plan``): the fused engine launches one CUDA graph
        per chunk length, the walks walk the same chunks layer by layer.
        Every combination the reference refuses raises here, before
        anything is built. The architecture must be MoE (the reference
        asserts so). A stack may mix dense layers (``attn_mlp``,
        ``local_attn``) with its ``attn_moe`` ones: every path runs a dense
        layer's MLP on the device, without residency, and the residency,
        telemetry and predictor count MoE layers by ordinal. Recurrent
        layers (the reference's walks take them) are not ported here.

        ``rt.mesh`` (this process is a rank of it): the engine runs over
        the tensor axis (the module's "Over a mesh"); what is not ported
        there raises here, before anything is built."""
        m = cfg.require_moe("RotaryEngine")
        if not cfg.kv_only:
            raise NotImplementedError(
                f"{cfg.name}: RotaryEngine runs KV-cache stacks (attn_moe beside attn_mlp / "
                f"local_attn); recurrent layers are not ported here, got "
                f"{sorted(set(cfg.layer_kinds))}")
        probe = make_policy(rescfg.mode, m.num_experts, rescfg.num_slots or m.num_experts, rescfg)
        if rt is not None and rt.mesh is not None:
            _check_mesh_engine(cfg, rt, rescfg, host_routing=host_routing,
                               lru=getattr(probe, "needs_sync_resolve", False),
                               fused_decode=fused_decode, prefetch=prefetch,
                               prefill_chunk=prefill_chunk)
        self.host_routing = bool(host_routing)
        # LRU answers misses with blocking loads mid-step: that needs the
        # routed ids on the host before the MoE half, i.e. the sync walk
        self._hot_decode = not host_routing and not getattr(probe, "needs_sync_resolve", False)
        fused_ok = self._hot_decode          # every block is a KV kind
        if fused_decode and not fused_ok:
            raise ValueError("fused decode requires device routing (no host_routing, no "
                             "LRU) and KV-cache-only block kinds")
        self._fused_decode = fused_ok if fused_decode is None else bool(fused_decode)
        if spec_k < 1:
            raise ValueError("spec_k is a window size (>= 1)")
        self.rt = rt or Runtime(cache_len=1024)
        if spec_k > 1:
            if not self._fused_decode:
                raise ValueError("speculative decode (spec_k > 1) rides the fused whole-stack "
                                 "step: it needs device routing (no host_routing, no LRU) and "
                                 "KV-cache-only block kinds")
            cap = attn_mod.cache_capacity(cfg.attention, self.rt.cache_len)
            if spec_k > cap:
                raise ValueError(f"spec_k={spec_k} exceeds the KV cache capacity ({cap})")
        self.spec_k = int(spec_k)
        if prefill_chunk is not None and (prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk must be a power of two, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        # every block is a KV kind and prompts are plain
        # tokens: chunked prefill is open to every engine; the fused chunk
        # path also needs a window-free cache, because its suffix replay
        # re-reads pre-chunk cache content a ring overwrite would destroy
        self._chunk_prefill_fused_ok = cfg.attention.window is None
        if prefetch and host_routing:
            raise ValueError(
                "prefetch=True is incompatible with host_routing=True: the host-routing "
                "baseline blocks on per-layer logits pulls, so there is no in-flight "
                "launch to hide shadow uploads under")
        if prefetch and not self._fused_decode:
            raise ValueError(
                "prefetch=True requires the fused whole-stack hot path (no LRU / recurrent "
                "stacks, fused_decode not disabled): synchronous per-layer walks rotate "
                "mid-step, so there is nothing to overlap")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rescfg = rescfg
        if cost is None:
            cost = (CostModel.measure(self.device) if self.device.type == "cuda"
                    else CostModel.unmeasured())
        self.cost = cost
        self.batch = batch
        self.stats = EngineStats()
        self.clock = TransferClock(self.cost)
        self._tr = resolve_tracer(trace)
        self.tracer = self._tr
        self.metrics = MetricsRegistry()
        dev = self.device

        host = torch.device("cpu")
        pin = torch.cuda.is_available()
        # every layer on the device (a MoE layer without its experts; under a
        # mesh this rank's shard of it); the residency, predictor and
        # telemetry index MoE layers by ordinal
        layers: List[Params] = []
        experts: List[Dict[str, torch.Tensor]] = []
        routers: List[np.ndarray] = []
        for p_l in params["layers"]:
            if "moe" not in p_l:
                layers.append(p_l)
                continue
            hw = dict(p_l["moe"]["experts"])
            if rescfg.quantization is None and self.rt.mesh is None:
                # else the manager packs them, or keeps this rank's slice
                for n, w in hw.items():
                    if w.device != host or (pin and not w.is_pinned()):
                        hw[n] = torch.empty(w.shape, dtype=w.dtype, pin_memory=pin).copy_(w)
            experts.append(hw)
            routers.append(p_l["moe"]["router"].float().cpu().numpy())
            layers.append({**p_l, "moe": {k: v for k, v in p_l["moe"].items() if k != "experts"}})
        dense = {**{k: params[k] for k in ("embed", "final_norm", "lm_head") if k in params},
                 "layers": layers}
        if self.rt.mesh is not None:
            dense = tfm.shard_params(cfg, dense, self.rt)
        dense = _to_device(dense, dev)
        self.layers: List[Params] = dense.pop("layers")
        self.embed_params = dense
        # the tensor axis' group where the slots hold this rank's F slice
        self._tp_group = self.rt.tp_group() if tfm._tensor_axis(self.rt) else None
        shard = (self.rt.tp_rank(), self.rt.tp_size()) if self._tp_group is not None else None
        # layer index -> MoE ordinal (None: dense), and MoE ordinal -> layer index
        self.moe_of = tfm.moe_ordinals({"layers": self.layers})
        self.moe_pos = [li for li, mi in enumerate(self.moe_of) if mi is not None]
        self.num_moe_layers = len(self.moe_pos)
        self._dparams = {**self.embed_params, "layers": self.layers}

        self.predictor = DemandPredictor(routers, ema=rescfg.predictor_ema)
        self.manager = RotaryResidencyManager(
            cfg, rescfg, experts,
            batch=batch, cache_len=self.rt.cache_len, device=dev,
            cost=self.cost, stats=self.stats, seed=seed,
            tracer=self._tr, metrics=self.metrics, shard=shard,
        )
        del experts
        # the warehouse: float stacks, or packed planes when quantized
        self.host_experts: List[Dict[str, torch.Tensor]] = self.manager.host_experts
        self.prefetch = bool(prefetch)
        if self.prefetch and rescfg.mode != "full":
            # margin 0, as in the reference: steering measured negative there;
            # the gain is the relaunch, which needs no prediction. Before the
            # warm start, which then lands in the folded planes
            self.manager.enable_prefetch(margin=0)
        n_l, k, e = self.num_moe_layers, cfg.moe.top_k, cfg.moe.num_experts
        if self._fused_decode or prefill_chunk is not None:
            # stacked next-layer routers [L, D, E] for the on-device demand GEMM
            # (the decode step's, and the chunk boundary's of both chunked paths)
            self._routers_next = torch.as_tensor(self.predictor.next_layer_routers()).to(dev)

        routing = dict(ids=((batch, k), torch.int32), weights=((batch, k), torch.float32),
                       miss=((batch, k), torch.bool))
        # the fused step's telemetry, [L, ...]; a window's, [spec_k, L, ...] and
        # its drafts (sampled decode runs windows at spec_k 1 too); the hot
        # walk's per-layer rows, the MoE inputs included
        self._pull = _pinned((n_l,), **routing, demand_next=((e,), torch.float32))
        self._win_pull = (_pinned((self.spec_k,), draft=((batch,), torch.int64))
                          | _pinned((self.spec_k, n_l), **routing,
                                   demand_next=((e,), torch.float32))
                          if self._fused_decode else {})
        # made on first use: a sampled window's distributions [spec_k, B, V]
        # and drawn-token probabilities; per chunk length, the chunk's
        # routing [L, B*C, k] and its static tokens (device and host)
        self._sample_pull: Dict[str, torch.Tensor] = {}
        self._chunk_pull: Dict[int, Dict[str, torch.Tensor]] = {}
        self._chunk_tokens: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._chunk_telem: List[Tuple[Any, ...]] = []      # the chunked walk's per layer
        self._walk_pull = (_pinned((n_l,), **routing,
                                  h2=((batch, cfg.d_model), tfm.torch_dtype(cfg)))
                           if self._hot_decode and not self._fused_decode else {})
        self._routed = ([torch.cuda.Event() for _ in range(n_l)]
                        if self._walk_pull and dev.type == "cuda" else [])
        # a window's KV snapshot exists to make its rollback exact: with full
        # residency (no miss) or uncorrected misses it is never read
        self._spec_needs_rollback = rescfg.mode != "full" and rescfg.host_compute_misses
        self._cost_cache: Dict[str, Tuple[float, float]] = {}
        self._f32_scratch: Dict[str, torch.Tensor] = {}      # host miss GEMM
        # the KV caches, allocated once: prefill rewrites them in place, so a
        # captured step's addresses hold across requests (under a mesh, this
        # rank's slice of each by sequence)
        self.state = tfm._sharded_zero_state(cfg, batch, self.rt.cache_len, self.rt, dev)
        self.cur_len = 0
        # the step's inputs: [tokens (B), cur_len] in one static device buffer,
        # filled from a pinned host buffer before each launch
        self._inputs_host = torch.empty((batch + 1,), dtype=torch.int64, pin_memory=pin)
        self._inputs = torch.zeros((batch + 1,), dtype=torch.int64, device=dev)
        # the sampled windows' per-row base keys [B, 2] and the seed they hold
        self._keys = torch.zeros((batch, 2), dtype=torch.int64, device=dev)
        self._keys_seed: Optional[int] = None
        # the draw between windows: the host logits [B, V] land in a pinned
        # row and a static device buffer (both made at the first draw)
        self._draw_host: Optional[torch.Tensor] = None
        self._draw_logits: Optional[torch.Tensor] = None
        self._residency: List[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = []
        # the captured launches (card only): 1 the step, K a greedy window,
        # (K, SampleParams) a sampled one, ("chunk", C, with_head) a chunk,
        # ("draw", SampleParams) the draw between windows
        # capture False: eager on the card (parity tests, and a mesh: gloo's
        # collectives cannot be captured)
        self._gs = GraphSet(dev.type == "cuda" and self.rt.mesh is None)
        self.launches = 0                        # fused launches: captures, replays, eager
        # None, or a list each decoded position appends the logits it
        # produced to (``logged_logits``), for checks against a reference
        self.logit_log: Optional[List[Any]] = None
        self._warm_start()

    @property
    def _capture(self) -> bool:
        return self._gs.capture

    @_capture.setter
    def _capture(self, on: bool) -> None:
        self._gs.capture = on

    @property
    def _graphs(self) -> Dict[Any, _Graph]:
        return self._gs.graphs

    @property
    def graph_captures(self) -> int:
        return self._gs.captures

    @property
    def graph_replays(self) -> int:
        return self._gs.replays

    # ------------------------------------------------------------------
    def _warm_start(self) -> None:
        """Initial residency: rotate every layer once on the uniform prior."""
        for li in range(self.num_moe_layers):
            self.manager.prepare_layer(li, self.predictor.smoothed[li])

    def _embed(self, tokens: np.ndarray) -> torch.Tensor:
        self.stats.device_dispatches += 1
        return tfm._embed(self.cfg, self.embed_params, torch.as_tensor(tokens).to(self.device),
                          self.rt)

    def _lm_head(self, h: torch.Tensor) -> torch.Tensor:
        self.stats.device_dispatches += 1
        return tfm.lm_logits(self.cfg, self.embed_params, h, self.rt)

    # ------------------------------------------------------------------
    def _host_correct(self, x: torch.Tensor, moe_li: int, h2: torch.Tensor,
                      ids: np.ndarray, weights: np.ndarray,
                      miss: np.ndarray) -> torch.Tensor:
        """Exact host GEMM correction for missed experts (:func:`host_correct`)."""
        x, n_host, convert_s, n_experts = host_correct(x, h2, ids, weights, miss,
                                                       self.host_experts[moe_li],
                                                       self._f32_scratch, self._tp_group)
        self.stats.host_dequant_s += convert_s
        self.stats.host_dequant_experts += n_experts
        self.stats.layer(moe_li).host_computed += n_host
        self.clock.host(self.cost.host_compute_s(self.manager.host_expert_flops(n_host)))
        return x

    def _moe_layer(self, mi: int, x_mid: torch.Tensor, h2: torch.Tensor,
                   ids_dev: torch.Tensor, w_dev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """MoE layer ``mi`` (its ordinal)'s routed experts through its residency."""
        slots, lut = self.manager.layer_residency(mi)
        y2, miss = moe_mod.moe_apply_routed(self.layers[self.moe_pos[mi]]["moe"], h2, ids_dev,
                                            w_dev, slot_buffer=slots, lut=lut,
                                            tp_group=self._tp_group, mcfg=self.cfg.moe)
        return x_mid + y2.reshape(x_mid.shape), miss

    def _dense_layer(self, li: int, x: torch.Tensor, mode: str, cur) -> torch.Tensor:
        """Dense layer ``li`` of a mixed stack: attention, then its MLP, on
        the device (no residency, no routing)."""
        x_mid, h2, _ = tfm.attn_half(self.cfg, self.layers[li], x, mode, self.state[li], cur,
                                     self.rt.cache_len, rt=self.rt)
        self.stats.device_dispatches += 1
        return tfm.mlp_half(self.cfg, self.layers[li], x_mid, h2, self.rt)

    def _suffix(self, start: int) -> List[Tuple[int, Optional[int]]]:
        """(layer index, MoE ordinal or None) of every layer from MoE layer
        ``start`` to the end of the stack: what a replay from that MoE
        layer's saved input re-runs."""
        first = self.moe_pos[start] if start < self.num_moe_layers else len(self.layers)
        return [(li, self.moe_of[li]) for li in range(first, len(self.layers))]

    # ------------------------------------------------------------------
    # per-layer sync walk (prefill; decode for LRU / the host-routing baseline)
    # ------------------------------------------------------------------
    def _run_layers(self, x: torch.Tensor, mode: str, cur_len: int) -> torch.Tensor:
        """The reference's ``_run_layers``: per layer, attention, the routing
        pulled to the host (one blocking read), the LUT resolved there (LRU
        uploads a missed expert here, and the device LUT is rewritten in place
        before the MoE half reads it: both on the compute stream), the MoE
        half, the host correction of what still missed, and the pre-gating of
        the next layer. ``mode`` is ``prefill`` (cache written from 0),
        ``decode`` (one token at ``cur_len``) or ``chunk`` (a prefill chunk
        appended at ``cur_len``; each layer's routing and MoE input go to
        ``_chunk_telem`` for the chunk-boundary rotation instead of
        pre-gating the next layer)."""
        cfg, clock, m = self.cfg, self.clock, self.cfg.moe
        cur = cur_len if mode == "prefill" else self._device_scalar(cur_len)
        for layer, p_l in enumerate(self.layers):
            li = self.moe_of[layer]
            if li is None:
                x = self._dense_layer(layer, x, mode, cur)
                continue
            x_mid, h2, _ = tfm.attn_half(cfg, p_l, x, mode, self.state[layer], cur,
                                         self.rt.cache_len)
            self.stats.sync_pulls += 1
            self.stats.device_dispatches += 1
            if self.host_routing:
                # the seed baseline: the router logits pulled, top-k on the host
                logits = moe_mod.router_logits(p_l["moe"], h2).cpu().numpy()
                ids, weights = host_topk_route(logits, m.top_k, normalize=m.norm_topk_prob)
                ids_dev = torch.from_numpy(ids).to(self.device)
                w_dev = torch.from_numpy(weights).to(self.device)
            else:
                ids_dev, w_dev = moe_mod.route(p_l["moe"], h2, m)
                ids = ids_dev.cpu().numpy()
                weights = w_dev.cpu().numpy()
            _, miss = self.manager.resolve(li, ids, clock)
            x, _ = self._moe_layer(li, x_mid, h2, ids_dev, w_dev)
            self.stats.device_dispatches += 1
            if miss.any() and self.rescfg.host_compute_misses:
                x = self._host_correct(x, li, h2, ids, weights, miss)
            flops, byts = self._layer_cost("attn_moe", x.shape, cur_len, hits=int((~miss).sum()))
            clock.compute(self.cost.compute_s(flops, byts))
            if mode == "chunk":
                # rotation waits for the chunk boundary, where the shared
                # demand program reads this chunk's hiddens (the fused path's)
                self._chunk_telem.append((ids, weights, miss, h2))
                continue
            # pre-gate the NEXT MoE layer from THIS hidden (cyclic)
            nxt = (li + 1) % self.num_moe_layers
            h2_np = h2.float().cpu().numpy().reshape(ids.shape[0], -1)
            demand = self.predictor.predict(nxt, h2_np)
            self.manager.prepare_layer(nxt, demand, clock)
            self.predictor.observe(li, ids, weights)
        return x

    def _device_scalar(self, v: int) -> torch.Tensor:
        return torch.full((), v, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------------
    # per-layer hot walk (fused_decode=False)
    # ------------------------------------------------------------------
    def _decode_step_hot(self, tok: np.ndarray) -> np.ndarray:
        """One decode step walked layer by layer with a single blocking pull
        (the reference's ``_decode_step_hot``). Per layer: attention and the
        routing; the routing and the MoE input copied without blocking into
        pinned rows, then an event; the MoE half queued (its miss mask copied
        behind it); the host waits on the event only, so it pre-gates the
        next layer while the MoE half runs. The next layer's uploads queue
        behind this layer's MoE half. The last layer's pre-gating of layer 0
        runs after the pull and any replay: layer 0 has already gathered
        this step, and a replay from it must gather what it gathered (the
        reference keeps per-layer residency snapshots). Returns host logits
        [B, V] (f32)."""
        cfg, n = self.cfg, self.num_moe_layers
        cur_len = self.cur_len
        cur = self._device_scalar(cur_len)
        x = self._embed(np.asarray(tok)[:, None])
        buf = self._walk_pull
        x_ins: List[torch.Tensor] = []                   # per-layer inputs (replay anchors)
        moved: List[Optional[int]] = []                  # bytes of the pre-gating each layer ran
        ids_all: List[np.ndarray] = []
        deferred = None
        for layer, p_l in enumerate(self.layers):
            li = self.moe_of[layer]
            if li is None:
                x = self._dense_layer(layer, x, "decode", cur)
                continue
            x_ins.append(x)
            x_mid, h2, _ = tfm.attn_half(cfg, p_l, x, "decode", self.state[layer], cur, 0)
            ids_dev, w_dev = moe_mod.route(p_l["moe"], h2, cfg.moe)
            for name, t in (("ids", ids_dev), ("weights", w_dev), ("h2", h2)):
                buf[name][li].copy_(t, non_blocking=True)
            if self._routed:
                self._routed[li].record()
            x, miss_dev = self._moe_layer(li, x_mid, h2, ids_dev, w_dev)
            buf["miss"][li].copy_(miss_dev, non_blocking=True)
            self.stats.device_dispatches += 2
            self.stats.overlapped_pulls += 4
            if self._routed:
                self._routed[li].synchronize()           # the routing, not the MoE half
            ids = buf["ids"][li].numpy().copy()
            weights = buf["weights"][li].numpy().copy()
            h2_np = buf["h2"][li].float().numpy()
            # pre-gate the next layer + predictor feedback (seed order)
            nxt = (li + 1) % n
            demand = self.predictor.predict(nxt, h2_np)
            if nxt > li:
                moved.append(self.manager.prepare_layer(nxt, demand, clock=None))
            else:
                deferred = (nxt, demand)
                moved.append(None)
            self.predictor.observe(li, ids, weights)
            ids_all.append(ids)
        logits = self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()   # THE one blocking pull
        self.stats.sync_pulls += 1
        miss = buf["miss"].numpy().copy()                # landed: the pull drained the stream
        missed = np.flatnonzero(miss.reshape(n, -1).any(axis=1))
        start = int(missed[0]) if (missed.size and self.rescfg.host_compute_misses) else n
        self._account_step_prefix(np.stack(ids_all), miss, start, cur_len, moved=moved)
        if start < n:
            logits = self._replay_step(x_ins[start], start, moved, cur_len, cur)
        if deferred is not None:
            self.clock.prefetch(self.manager.prepare_layer(*deferred, clock=None))
        return logits

    def _replay_step(self, x0: torch.Tensor, start: int, moved: List[Optional[int]],
                     cur_len: int, cur: torch.Tensor) -> np.ndarray:
        """Exact re-execution of a hot-walk step's SUFFIX after an observed
        miss (the reference's ``_replay_step``): layers before ``start`` stand;
        from ``start`` on, each layer re-runs from the corrected activations
        against the residency the walk gathered it from, re-deriving the
        routing and host-correcting its misses, with one blocking pull per
        layer. Re-running attention rewrites the same KV slot. The walk's
        pre-gating is not repeated; its modeled upload time is charged here
        in seed order."""
        cfg, clock = self.cfg, self.clock
        x = x0
        for layer, li in self._suffix(start):
            if li is None:
                x = self._dense_layer(layer, x, "decode", cur)
                continue
            p_l = self.layers[layer]
            x_mid, h2, _ = tfm.attn_half(cfg, p_l, x, "decode", self.state[layer], cur, 0)
            ids_dev, w_dev = moe_mod.route(p_l["moe"], h2, cfg.moe)
            x, miss_dev = self._moe_layer(li, x_mid, h2, ids_dev, w_dev)
            ids = ids_dev.cpu().numpy()
            weights = w_dev.cpu().numpy()
            miss = miss_dev.cpu().numpy()
            self.stats.sync_pulls += 1
            self.manager.record_routing(li, ids, miss)
            if miss.any() and self.rescfg.host_compute_misses:
                x = self._host_correct(x, li, h2, ids, weights, miss)
            flops, byts = self._layer_cost("attn_moe", x.shape, cur_len, hits=int((~miss).sum()))
            clock.compute(self.cost.compute_s(flops, byts))
            if moved[li] is not None:
                clock.prefetch(moved[li])
        logits = self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()
        self.stats.sync_pulls += 1
        return logits

    # ------------------------------------------------------------------
    # fused decode (one step over every layer per token; windows of K)
    # ------------------------------------------------------------------
    def _telemetry(self, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A position's telemetry from ``decode_model``'s aux (the reference's
        ``_demand_aux_fn``): the routing, the demand GEMM's result (``route_h``
        stays on the device) and the replay anchors."""
        return {"ids": aux["route_ids"], "weights": aux["route_weights"],
                "miss": aux["route_miss"], "demand_next": self._demand_all(aux["route_h"]),
                "route_x": aux["route_x"]}

    def _demand_all(self, h_all: torch.Tensor) -> torch.Tensor:
        """The pre-gating demand program over stacked per-layer MoE inputs
        h_all [L, T, D]: ``softmax(h_l @ R_{l+1})`` averaged over tokens,
        [L, E]. The decode step runs it inside its graph; both chunked
        prefill paths run it eagerly at the chunk boundary on the same
        inputs, so their residency evolves bit for bit alike."""
        return demand_program(h_all, self._routers_next)

    def _step_body(self) -> Dict[str, torch.Tensor]:
        """The decode step on the device, from the static inputs and the
        residency of ``_residency``: logits and the telemetry (the
        counterpart of ``build_fused_decode_step`` with ``_demand_aux_fn``)."""
        tok = self._inputs[:self.batch]
        cur = self._inputs[self.batch]
        logits, aux = tfm.decode_model(self.cfg, self._dparams, tok, self.state, cur,
                                       self._residency, rt=self.rt)
        return {"logits": logits, **self._telemetry(aux)}

    def _window_body(self, k: int, sample: Optional[SampleParams] = None) -> Dict[str, Any]:
        """A ``k``-position window on the device from the static inputs (the
        counterpart of ``build_window_fns``): first, when a rollback may be
        needed, the pre-window contents of the ``k`` KV slots it writes
        (``saved``); then ``tfm.decode_window``, drafting by argmax or, with
        ``sample``, by position-keyed draws from the static keys. Outputs:
        ``draft`` [K, B], ``logits`` [K, B, V] f32, the telemetry stacked
        [K, L, ...] and, sampled, ``sample_probs`` / ``sample_p``."""
        return window_outputs(self.cfg, self._dparams, self._inputs[:self.batch], self.state,
                              self._inputs[self.batch], k, self._residency, self._telemetry,
                              snapshot=self._spec_needs_rollback, sample=sample,
                              keys=self._keys, rt=self.rt)

    def _chunk_body(self, c: int, with_head: bool) -> Dict[str, Any]:
        """A prefill chunk of ``c`` tokens on the device from its static token
        buffer, at the static ``cur_len`` (the counterpart of
        ``build_fused_prefill_step`` without the in-graph demand: the
        boundary's demand program reads hiddens a replay may patch).
        Outputs: ``logits`` [B, V] (``with_head``) and the telemetry
        ``route_*`` [L, B*c, ...]."""
        logits, aux = tfm.prefill_chunk_model(self.cfg, self._dparams, self._chunk_tokens[c][0],
                                              self.state, self._inputs[self.batch],
                                              self._residency, with_head=with_head, rt=self.rt)
        return aux if logits is None else {"logits": logits, **aux}

    def _set_inputs(self, tok: np.ndarray, cur_len: int) -> None:
        host = self._inputs_host
        host[:self.batch] = torch.from_numpy(np.asarray(tok, np.int64))
        host[self.batch] = cur_len
        self._inputs.copy_(host, non_blocking=True)

    def _graph_inputs(self, extra: Tuple[torch.Tensor, ...] = (),
                      model: bool = True) -> Tuple[int, ...]:
        """Addresses of everything a replay reads besides the weights: the
        static inputs (``extra``: a graph's own, a chunk's tokens, the
        sampling keys or the draw's logits) and, for a graph that runs the
        model (``model``), every plane and device LUT, every cache."""
        ptrs = [self._inputs.data_ptr()] + [t.data_ptr() for t in extra]
        if not model:
            return tuple(ptrs)
        for planes, lut in self._residency:
            ptrs += [t.data_ptr() for t in planes.values()] + [lut.data_ptr()]
        for cache in self.state:
            ptrs += [cache["k"].data_ptr(), cache["v"].data_ptr()]
        return tuple(ptrs)

    def _launch(self, key: Any = 1, body: Optional[Callable[[], Dict[str, Any]]] = None,
                extra: Tuple[torch.Tensor, ...] = (), model: bool = True) -> Dict[str, Any]:
        """Run ``body`` (default: the step) once at the inputs set: a replay
        of the graph captured for ``key`` on the card (captured on first
        use), eager on the CPU. ``extra``: static inputs of this graph
        alone, whose addresses the replay checks too. ``model``: the body
        runs the model (reads the residency and the caches); the draw does
        not."""
        if model:
            self._residency = self.manager.residency()     # device LUTs rewritten in place
        self.launches += 1
        return self._gs.launch(key, body or self._step_body,
                               lambda: self._graph_inputs(extra, model))

    def _queue_telemetry(self, out: Dict[str, torch.Tensor], pull: Dict[str, torch.Tensor],
                         k: Optional[int] = None) -> None:
        """Non-blocking copies of a launch's telemetry into the pinned
        buffers (a window's into their first ``k`` rows), queued on the
        compute stream after it: they have landed once the logits pull that
        follows returns."""
        for name, buf in pull.items():
            (buf if k is None else buf[:k]).copy_(out[name], non_blocking=True)

    def _read_telemetry(self, k: Optional[int] = None) -> Tuple[np.ndarray, ...]:
        """The step's (ids, weights, miss [L, T, k], demand_next [L, E]), or
        with ``k`` a window's (draft [K, B], ids, weights, miss [K, L, T, k],
        demand_next [K, L, E]), from the pinned buffers."""
        if k is None:
            return tuple(self._pull[n].numpy().copy()
                         for n in ("ids", "weights", "miss", "demand_next"))
        return tuple(self._win_pull[n][:k].numpy().copy()
                     for n in ("draft", "ids", "weights", "miss", "demand_next"))

    def _decode_step_fused(self, tok: np.ndarray) -> np.ndarray:
        """One decode step. Returns host logits [B, V] (f32)."""
        cur_len = self.cur_len
        tr = self._tr
        if tr is not None:
            tr.new_unit("decode")
            t_trace = time.perf_counter()
        self._set_inputs(tok, cur_len)
        out = self._launch()
        self.stats.device_dispatches += 1
        if tr is not None:
            tr.complete("launch", "launch", t_trace, time.perf_counter(),
                        args={"cur_len": cur_len})
        self._queue_telemetry(out, self._pull)
        self.stats.overlapped_pulls += len(self._pull)
        if self.prefetch:
            # the step is still in flight: plan the predicted next transition
            # and ship its uploads into the shadow generation now
            self.manager.begin_prefetch(self.predictor, self.clock)
        if tr is not None:
            t_trace = time.perf_counter()
        logits = out["logits"].float().cpu().numpy()          # THE one blocking pull
        self.stats.sync_pulls += 1
        if tr is not None:
            tr.complete("pull", "pull", t_trace, time.perf_counter(),
                        args={"cur_len": cur_len})
        ids, weights, miss, demand_next = self._read_telemetry()
        missed = np.flatnonzero(miss.reshape(miss.shape[0], -1).any(axis=1))
        if tr is not None and missed.size:
            tr.instant("miss", "launch",
                       args={"first_moe": int(missed[0]), "layers": int(missed.size)})
        start = (int(missed[0]) if (missed.size and self.rescfg.host_compute_misses)
                 else self.num_moe_layers)
        self._account_step_prefix(ids, miss, start, cur_len)
        if start < self.num_moe_layers:
            # the replay anchor outlives a relaunch, which rewrites the outputs
            anchor = out["route_x"][start].clone() if self.prefetch else out["route_x"][start]
            redo = self._relaunch_fused(cur_len, ids, start) if self.prefetch else None
            if redo is not None:
                logits, ids, weights, miss, demand_next = redo
            else:
                logits = self._replay_fused(anchor, start, cur_len)
        # between-step rotation, strictly after the step and its replay
        self.manager.rotate_from_telemetry(
            self.predictor, ids, weights, miss, demand_next,
            clock=self.clock, record=False,
        )
        return logits

    def _account_step_prefix(self, ids: np.ndarray, miss: np.ndarray,
                             stop_li: int, cur_len: int, start_li: int = 0,
                             moved: Optional[List[Optional[int]]] = None,
                             tokens: int = 1) -> None:
        """record_routing + modeled clock for layers ``[start_li, stop_li)``
        of one authoritative step (ids/miss [L, T, k]): the step's prefix, a
        relaunch's suffix, or a prefill chunk's prefix (``tokens`` = its
        positions). ``moved`` (the hot walk) charges the upload of the
        pre-gating each layer ran after its compute, in seed order."""
        xshape = (self.batch, tokens, self.cfg.d_model)
        for li in range(start_li, stop_li):
            self.manager.record_routing(li, ids[li], miss[li])
            flops, byts = self._layer_cost("attn_moe", xshape, cur_len,
                                           hits=int((~miss[li]).sum()))
            self.clock.compute(self.cost.compute_s(flops, byts))
            if moved is not None and moved[li] is not None:
                self.clock.prefetch(moved[li])

    def _relaunch_fused(self, cur_len: int, ids0: np.ndarray, start: int
                        ) -> Optional[Tuple[np.ndarray, ...]]:
        """Miss correction by RE-LAUNCH (prefetch mode; the reference's
        ``_relaunch_fused``): upload the experts the telemetry names as
        missed (``ensure_resident``) and run the whole step again at the same
        ``cur_len``, which rewrites every KV slot the first pass wrote; a
        miss-free pass equals the host-corrected replay, so tokens cannot
        move. At most two covering relaunches (corrected hiddens can route to
        new experts). Returns ``(logits, ids, weights, miss, demand_next)``
        of the miss-free pass, or None when the slots cannot cover a layer's
        routed set (checked before any upload) or misses persist: the caller
        replays."""
        ids_cur = ids0
        n = self.num_moe_layers
        for _ in range(2):
            routed_all = [np.unique(ids_cur[m]) for m in range(start, n)]
            if any(r.size > self.manager.policies[start + i].lut.num_slots
                   for i, r in enumerate(routed_all)):
                return None
            moved = 0
            for i, moe_li in enumerate(range(start, n)):
                loads = self.manager.ensure_resident(moe_li, routed_all[i], routed_all[i])
                if loads is None:
                    return None
                moved += len(loads) * self.manager.stores[moe_li].bytes_per_expert
            if moved:
                self.clock.blocking(moved)
            tr = self._tr
            if tr is not None:
                t_trace = time.perf_counter()
            out = self._launch()
            self.stats.device_dispatches += 1
            self.stats.relaunched_steps += 1
            if tr is not None:
                tr.complete("launch", "launch", t_trace, time.perf_counter(),
                            args={"kind": "relaunch"})
            self._queue_telemetry(out, self._pull)
            if tr is not None:
                t_trace = time.perf_counter()
            logits = out["logits"].float().cpu().numpy()
            self.stats.sync_pulls += 1
            if tr is not None:
                tr.complete("pull", "pull", t_trace, time.perf_counter(),
                            args={"kind": "relaunch"})
            ids, weights, miss, demand_next = self._read_telemetry()
            if not miss.any():
                # the first pass accounted layers < start; this pass is
                # authoritative for the rest
                self._account_step_prefix(ids, miss, n, cur_len, start_li=start)
                return logits, ids, weights, miss, demand_next
            ids_cur = ids
        return None

    def _replay_fused(self, anchor: torch.Tensor, start: int, cur_len: int,
                      step: Optional[int] = None) -> np.ndarray:
        """Exact re-execution of a fused-step SUFFIX after an observed miss:
        layers before ``start`` stand; from ``start`` on, the per-layer walk
        re-runs from the step's saved block input ``anchor`` (``route_x`` of
        layer ``start``) at position ``cur_len`` against the SAME residency
        (rotation runs after this), host-correcting every miss. ``step`` is
        the window position being replayed (its later positions' KV slots
        rolled back first), None for a single step."""
        tr = self._tr
        t_trace = time.perf_counter() if tr is not None else 0.0
        cfg, clock = self.cfg, self.clock
        x = anchor.reshape(self.batch, 1, -1)
        cur = self._device_scalar(cur_len)
        self.stats.device_dispatches += 1             # device-side slice
        for layer, li in self._suffix(start):
            if li is None:
                x = self._dense_layer(layer, x, "decode", cur)
                continue
            p_l = self.layers[layer]
            x_mid, h2, _ = tfm.attn_half(cfg, p_l, x, "decode", self.state[layer], cur, 0,
                                         rt=self.rt)
            ids_dev, w_dev = moe_mod.route(p_l["moe"], h2, cfg.moe)
            x, miss_dev = self._moe_layer(li, x_mid, h2, ids_dev, w_dev)
            self.stats.device_dispatches += 2
            ids = ids_dev.cpu().numpy()
            weights = w_dev.cpu().numpy()
            miss = miss_dev.cpu().numpy()
            self.stats.sync_pulls += 1
            self.stats.replay_pulls += 1
            self.manager.record_routing(li, ids, miss)
            if miss.any() and self.rescfg.host_compute_misses:
                x = self._host_correct(x, li, h2, ids, weights, miss)
            flops, byts = self._layer_cost("attn_moe", x.shape, cur_len,
                                           hits=int((~miss).sum()))
            clock.compute(self.cost.compute_s(flops, byts))
        logits = self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()
        self.stats.sync_pulls += 1
        self.stats.replay_pulls += 1
        self.stats.replayed_steps += 1
        if tr is not None:
            tr.complete("replay", "launch", t_trace, time.perf_counter(),
                        args={"start_li": start, "step": step})
        return logits

    # ------------------------------------------------------------------
    # speculative windows (spec_k > 1)
    # ------------------------------------------------------------------
    def _window_launch(self, k: int, sample: Optional[SampleParams]) -> Dict[str, Any]:
        """A window's launch: its graph is keyed by size and sampler (a
        sampled window also reads the static keys)."""
        if sample is None:
            return self._launch(k, functools.partial(self._window_body, k))
        return self._launch((k, sample), functools.partial(self._window_body, k, sample),
                            (self._keys,))

    def _draw(self, logits: np.ndarray, sample: SampleParams) -> np.ndarray:
        """The draw between windows or steps (``sampling.build_sample_fn``,
        the in-window draw's ops and keys): the host logits [B, V] into the
        static logits buffer, the position ``cur_len - 1`` into the static
        ``cur_len``, then one launch, a replay of the graph captured per
        sampler on the card. Returns the tokens [B] int32 (a blocking pull)."""
        logits = np.asarray(logits, np.float32)
        if self._draw_logits is None:
            self._draw_host = torch.empty(logits.shape, dtype=torch.float32,
                                          pin_memory=self.device.type == "cuda")
            self._draw_logits = torch.empty(logits.shape, dtype=torch.float32,
                                            device=self.device)
        self._draw_host.copy_(torch.from_numpy(logits))
        self._draw_logits.copy_(self._draw_host, non_blocking=True)
        self._inputs_host[self.batch] = self.cur_len - 1
        self._inputs.copy_(self._inputs_host, non_blocking=True)
        fn = sampling_mod.build_sample_fn(sample)
        out = self._launch(("draw", sample),
                           lambda: {"tokens": fn(self._draw_logits, self._keys,
                                                 self._inputs[self.batch])},
                           (self._keys, self._draw_logits), model=False)
        self.stats.sync_pulls += 1
        return out["tokens"].cpu().numpy().astype(np.int32)

    def _window_pulls(self, sample: Optional[SampleParams]) -> Dict[str, torch.Tensor]:
        """The pinned buffers a window's telemetry lands in; a sampled
        window's distributions too (allocated on the first one)."""
        if sample is None:
            return self._win_pull
        if not self._sample_pull:
            self._sample_pull = _pinned(
                (self.spec_k,), sample_probs=((self.batch, self.cfg.vocab_size), torch.float32),
                sample_p=((self.batch,), torch.float32))
        return {**self._win_pull, **self._sample_pull}

    def _accept(self, draft: np.ndarray, k: int, sample: Optional[SampleParams],
                sample_rng: Optional[np.random.Generator]) -> int:
        """The window's accept rule over its drafts: greedy, or the stochastic
        rule with the pulled distributions as draft and verifier (self-drafting
        accepts every position; the call is the plug point for a drafter)."""
        if sample is None:
            return int(greedy_accept(draft, draft).min())
        probs = self._sample_pull["sample_probs"][:k].numpy()
        return int(stochastic_accept(draft, probs, probs, sample_rng)[0].min())

    def _decode_window_fused(self, tok: np.ndarray, k: int,
                             sample: Optional[SampleParams] = None,
                             sample_rng: Optional[np.random.Generator] = None
                             ) -> Tuple[np.ndarray, np.ndarray, int]:
        """One speculative window (the reference's ``_decode_window_fused``):
        ``k`` self-drafted positions in one launch, one blocking pull,
        acceptance by the accept rule and the miss telemetry, the miss
        relaunch of the whole window (``prefetch=True``), else the KV
        rollback past the first missed position ``j*`` and its replay, then
        the window-boundary rotation from the committed steps. With
        ``sample`` the window drafts by position-keyed draws (the engine's
        static keys) and accepts by ``stochastic_accept`` over the pulled
        distributions, drawing its uniforms from ``sample_rng``.

        ``tok`` [B] is position 0's token (already emitted by the caller).
        Returns ``(extra [committed-1, B], logits [B, V], committed)``: the
        drafted tokens committed beyond ``tok`` and the logits that continue
        the chain (the last committed position's, replay-corrected when it
        missed). Positions before the first miss saw the inputs and residency
        the single-token step would have, so the committed tokens equal
        single-token decode's."""
        cur_len0 = self.cur_len
        n = self.num_moe_layers
        tr = self._tr
        if tr is not None:
            tr.new_unit("window")
            if self._spec_needs_rollback:
                # the KV snapshot is the window graph's first operation
                tr.instant("kv_snapshot", "launch", args={"k": k})
            t_trace = time.perf_counter()
        self._set_inputs(tok, cur_len0)
        if self._spec_needs_rollback:
            self.stats.device_dispatches += 1         # the KV snapshot, the window's first op
        out = self._window_launch(k, sample)
        self.stats.device_dispatches += 1
        self.stats.spec_windows += 1
        if tr is not None:
            tr.complete("launch", "launch", t_trace, time.perf_counter(),
                        args={"cur_len": cur_len0, "k": k})
        pulls = self._window_pulls(sample)
        self._queue_telemetry(out, pulls, k)
        self.stats.overlapped_pulls += len(pulls)
        if self.prefetch:
            # the whole window is in flight: shadow-upload the predicted next
            # transition under it (committed at the boundary rotation)
            self.manager.begin_prefetch(self.predictor, self.clock)
        if tr is not None:
            t_trace = time.perf_counter()
        logits = out["logits"][k - 1].cpu().numpy()          # THE one blocking pull
        self.stats.sync_pulls += 1
        if tr is not None:
            tr.complete("pull", "pull", t_trace, time.perf_counter(),
                        args={"cur_len": cur_len0, "k": k})
        draft, ids, weights, miss, demand_next = self._read_telemetry(k)
        # self-drafting with the verifier's weights: the accept rule takes the
        # whole window; rejection comes only from residency misses
        accept = self._accept(draft, k, sample, sample_rng)
        missed = np.flatnonzero(miss.reshape(k, -1).any(axis=1))
        if tr is not None and missed.size:
            tr.instant("miss", "launch",
                       args={"first_step": int(missed[0]), "steps": int(missed.size)})
        j_star = start = None
        if missed.size and self.rescfg.host_compute_misses:
            j_star = int(missed[0])
            accept = min(accept, j_star)
            start = int(np.flatnonzero(miss[j_star].reshape(n, -1).any(axis=1))[0])
            anchor, saved = out["route_x"][j_star, start], out["saved"]
            if self.prefetch:
                # a relaunch rewrites the outputs; a failed one falls back to
                # the rollback + replay of THIS pass's telemetry
                anchor = anchor.clone()
                saved = [{nm: t.clone() for nm, t in c.items()} for c in saved]
                redo = self._relaunch_window(k, cur_len0, ids, sample)
                if redo is not None:
                    out, logits, draft, ids, weights, miss, demand_next = redo
                    accept = self._accept(draft, k, sample, sample_rng)
                    j_star = None
        self.stats.drafted_tokens += k
        self.stats.accepted_tokens += accept
        for s in range(accept):
            self._account_step_prefix(ids[s], miss[s], n, cur_len0 + s)
        committed = accept
        if j_star is not None:
            # reject the suffix: restore the KV slots after j*, then replay
            # position j* from its first missed layer like a missed step
            tfm.rollback_kv_window(self.state, saved, cur_len0, k, j_star + 1, rt=self.rt)
            self.stats.device_dispatches += 1
            if tr is not None:
                tr.instant("kv_rollback", "launch", args={"j_star": j_star})
            self._account_step_prefix(ids[j_star], miss[j_star], start, cur_len0 + j_star)
            logits = self._replay_fused(anchor, start, cur_len0 + j_star, step=j_star)
            committed = j_star + 1
        if self.logit_log is not None:
            self.logit_log.append(out["logits"][:committed - 1].clone())
            self.logit_log.append(logits)
        # window-boundary rotation from the committed telemetry: the host
        # transitions per step, the uploads one batch per layer
        self.manager.rotate_window_from_telemetry(
            self.predictor, ids[:committed], weights[:committed], miss[:committed],
            demand_next[:committed], clock=self.clock, record=False,
        )
        return draft[:committed - 1], logits, committed

    def _relaunch_window(self, k: int, cur_len0: int, ids0: np.ndarray,
                         sample: Optional[SampleParams] = None) -> Optional[Tuple[Any, ...]]:
        """Window-sized miss relaunch (the reference's ``_relaunch_window``):
        make each layer's routed union over the ``k`` positions resident
        (None when it exceeds the slots: windows route wider than a step) and
        run the window again from the same inputs; it rewrites all ``k`` KV
        slots, so no rollback is needed when it comes back miss-free. A
        sampled window re-draws with the same keys (position keys depend on
        the cache position alone). Returns ``(out, logits, draft, ids,
        weights, miss, demand_next)`` of the miss-free pass (its
        distributions in the pinned buffers), else None."""
        ids_cur = ids0                                   # [K, L, T, kk]
        n = self.num_moe_layers
        for _ in range(2):
            routed_all = [np.unique(ids_cur[:, m]) for m in range(n)]
            if any(r.size > self.manager.policies[m].lut.num_slots
                   for m, r in enumerate(routed_all)):
                return None
            moved = 0
            for m in range(n):
                loads = self.manager.ensure_resident(m, routed_all[m], routed_all[m])
                if loads is None:
                    return None
                moved += len(loads) * self.manager.stores[m].bytes_per_expert
            if moved:
                self.clock.blocking(moved)
            tr = self._tr
            if tr is not None:
                t_trace = time.perf_counter()
            out = self._window_launch(k, sample)    # the static inputs still hold tok, cur_len0
            self.stats.device_dispatches += 1
            self.stats.relaunched_steps += 1
            if tr is not None:
                tr.complete("launch", "launch", t_trace, time.perf_counter(),
                            args={"kind": "relaunch"})
            self._queue_telemetry(out, self._window_pulls(sample), k)
            if tr is not None:
                t_trace = time.perf_counter()
            logits = out["logits"][k - 1].cpu().numpy()
            self.stats.sync_pulls += 1
            if tr is not None:
                tr.complete("pull", "pull", t_trace, time.perf_counter(),
                            args={"kind": "relaunch"})
            draft, ids, weights, miss, demand_next = self._read_telemetry(k)
            if not miss.any():
                return out, logits, draft, ids, weights, miss, demand_next
            ids_cur = ids
        return None

    def _layer_cost(self, kind: str, xshape, cur_len: int, hits: int) -> Tuple[float, float]:
        """(flops, bytes) estimate of one layer at current shapes (modeled clock)."""
        cfg = self.cfg
        cached = self._cost_cache.get(kind)
        if cached is None:
            from repro_torch.models.params import _block_params

            n_static = float(_block_params(cfg, kind, active_only=True))
            m = cfg.moe
            mats = 3 if cfg.mlp == "swiglu" else 2
            n_static -= m.top_k * mats * cfg.d_model * m.expert_d_ff
            cached = (n_static, float(mats * cfg.d_model * m.expert_d_ff))
            self._cost_cache[kind] = cached
        n_static, per_hit = cached
        tokens = int(np.prod(xshape[:-1]))
        flops = 2.0 * tokens * n_static + 2.0 * hits * per_hit
        byts = 2.0 * n_static + 2.0 * hits * per_hit
        a = cfg.attention
        ctx = min(cur_len + 1, self.rt.cache_len)
        flops += 4.0 * tokens * ctx * a.num_heads * a.head_dim
        byts += 2.0 * xshape[0] * ctx * a.num_kv_heads * a.head_dim * 2
        return flops, byts

    # ------------------------------------------------------------------
    # chunked prefill (prefill_chunk=C)
    # ------------------------------------------------------------------
    def _check_no_wrap(self, cur_len: int, c: int) -> None:
        """A chunk's KV lands at slots ``cur_len .. cur_len + c - 1``, which
        K4's chunk entry scores as positions: it must not wrap the cache. The
        engine's gating keeps it so (prefill starts at 0 and is capped at the
        capacity); this holds the line before every launch."""
        cap = attn_mod.cache_capacity(self.cfg.attention, self.rt.cache_len)
        if cur_len + c > cap:
            raise RuntimeError(f"prefill chunk at {cur_len} + {c} would wrap the KV cache ({cap})")

    def _rotate_chunk_boundary(self, ids: np.ndarray, weights: np.ndarray, miss: np.ndarray,
                               h_all: Optional[torch.Tensor] = None,
                               demand: Optional[np.ndarray] = None) -> None:
        """One coalesced rotation at a chunk boundary, shared by both chunked
        paths (the reference's ``_rotate_chunk_boundary``): the demand
        program over the chunk's stacked MoE inputs ``h_all`` [L, T, D]
        (``_demand_all``; the fused path passes the result it queued behind
        its launch as ``demand``), then ``rotate_from_telemetry`` (EMA fold,
        each layer's transition once, batched uploads). Hits and misses
        were recorded already (walk: ``resolve``; fused: the prefix
        accounting and the replay)."""
        if demand is None:
            demand = self._demand_all(h_all).cpu().numpy()
            self.stats.device_dispatches += 1
        self.manager.rotate_from_telemetry(self.predictor, ids, weights, miss, demand,
                                           clock=self.clock, record=False)

    def _prefill_walk_chunked(self, tokens: np.ndarray) -> np.ndarray:
        """The chunked layer walk (the baseline, and the chunked path of the
        walking engines): each chunk walks the stack with the chunk-append
        attention the fused graph runs, one blocking pull per layer, then
        rotates once at the chunk boundary. Returns host logits [B, V]."""
        s, d = tokens.shape[1], self.cfg.d_model
        cur, x = 0, None
        for c in prefill_chunk_plan(s, self.prefill_chunk):
            self._check_no_wrap(cur, c)
            self._chunk_telem = []
            x = self._embed(tokens[:, cur:cur + c])
            x = self._run_layers(x, "chunk", cur)
            self.stats.prefill_chunks += 1
            telem = self._chunk_telem
            self._rotate_chunk_boundary(*(np.stack([t[i] for t in telem]) for i in range(3)),
                                        h_all=torch.stack([t[3].reshape(-1, d) for t in telem]))
            cur += c
        self._chunk_telem = []       # the last chunk's device hiddens are not kept
        return self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()

    def _chunk_buffers(self, c: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """Chunk length ``c``'s pinned telemetry buffers and its static tokens
        [B, c] (device, pinned host), made on first use."""
        if c not in self._chunk_pull:
            k = self.cfg.moe.top_k
            self._chunk_pull[c] = _pinned(
                (self.num_moe_layers, self.batch * c), ids=((k,), torch.int32),
                weights=((k,), torch.float32), miss=((k,), torch.bool))
            self._chunk_tokens[c] = (
                torch.zeros((self.batch, c), dtype=torch.int64, device=self.device),
                torch.empty((self.batch, c), dtype=torch.int64,
                            pin_memory=torch.cuda.is_available()))
        return (self._chunk_pull[c], *self._chunk_tokens[c])

    def _prefill_fused_chunked(self, tokens: np.ndarray) -> np.ndarray:
        """Fused chunked prefill (the reference's ``_prefill_fused_chunked``):
        per chunk, one launch (a CUDA graph replay on the card, one graph per
        chunk length, the head only on the last chunk), the boundary's
        demand program queued behind it, the routing copied to pinned
        memory, ``begin_prefetch`` under the launch (``prefetch=True``), one
        blocking pull (the logits on the last chunk, else the routing); a
        chunk that missed replays its suffix per layer from the first missed
        layer's saved input (``_replay_prefill_chunk``), which patches the
        authoritative routing and hiddens into the telemetry; then one
        rotation at the boundary. Returns host logits [B, V]."""
        s = tokens.shape[1]
        plan = prefill_chunk_plan(s, self.prefill_chunk)
        n = self.num_moe_layers
        cur, logits = 0, None
        tr = self._tr
        for ci, c in enumerate(plan):
            last = ci == len(plan) - 1
            self._check_no_wrap(cur, c)
            if tr is not None:
                tr.new_unit("chunk")
                t_trace = time.perf_counter()
            pull, tok_dev, tok_host = self._chunk_buffers(c)
            tok_host.copy_(torch.from_numpy(np.asarray(tokens[:, cur:cur + c], np.int64)))
            tok_dev.copy_(tok_host, non_blocking=True)
            self._inputs_host[self.batch] = cur
            self._inputs.copy_(self._inputs_host, non_blocking=True)
            out = self._launch(("chunk", c, last), functools.partial(self._chunk_body, c, last),
                               (tok_dev,))
            self.stats.device_dispatches += 1
            self.stats.prefill_chunks += 1
            if tr is not None:
                tr.complete("launch", "launch", t_trace, time.perf_counter(),
                            args={"chunk": c, "cur_len": cur})
            for name, buf in pull.items():
                buf.copy_(out[f"route_{name}"], non_blocking=True)
            self.stats.overlapped_pulls += len(pull)
            # the boundary's demand program behind the launch: usable when no
            # replay patches the hiddens
            demand_dev = self._demand_all(out["route_h"])
            self.stats.device_dispatches += 1
            if self.prefetch:
                # the chunk is in flight: ship the predicted next boundary's
                # uploads into the shadow generation under it
                self.manager.begin_prefetch(self.predictor, self.clock)
            if tr is not None:
                t_trace = time.perf_counter()
            if last:
                logits = out["logits"].float().cpu().numpy()        # THE one blocking pull
            demand = demand_dev.cpu().numpy()    # non-final chunks: THE pull (drains the queue)
            self.stats.sync_pulls += 1
            if tr is not None:
                tr.complete("pull", "pull", t_trace, time.perf_counter(), args={"chunk": c})
            ids, weights, miss = (pull[name].numpy().copy() for name in ("ids", "weights", "miss"))
            missed = np.flatnonzero(miss.reshape(n, -1).any(axis=1))
            if tr is not None and missed.size:
                tr.instant("miss", "launch",
                           args={"first_moe": int(missed[0]), "layers": int(missed.size)})
            start = int(missed[0]) if (missed.size and self.rescfg.host_compute_misses) else n
            self._account_step_prefix(ids, miss, start, cur, tokens=c)
            if start < n:
                h_rows = list(out["route_h"].unbind(0))          # per layer [T, D], patched
                replay_logits = self._replay_prefill_chunk(out, start, cur, c, ids, weights,
                                                           miss, h_rows, with_head=last)
                if last:
                    logits = replay_logits
                # the replay patched the hiddens: the demand reads the
                # authoritative stack
                self._rotate_chunk_boundary(ids, weights, miss, h_all=torch.stack(h_rows))
            else:
                self._rotate_chunk_boundary(ids, weights, miss, demand=demand)
            cur += c
        return logits

    def _replay_prefill_chunk(self, out: Dict[str, torch.Tensor], start: int, cur_len: int,
                              c: int, ids_all: np.ndarray, weights_all: np.ndarray,
                              miss_all: np.ndarray, h_rows: List[torch.Tensor],
                              with_head: bool) -> Optional[np.ndarray]:
        """Exact re-execution of a prefill chunk's SUFFIX after an observed
        miss (the reference's ``_replay_prefill_chunk``): layers before
        ``start`` stand; from ``start`` on, each layer re-runs from the
        chunk's saved block input (``route_x``) against the residency the
        launch gathered from, host-correcting every miss, one blocking pull
        per layer. Re-running a chunk's attention rewrites the very slots
        the launch wrote (window-free caches only: the fused gate). The
        replayed layers' routing and hiddens are patched into the caller's
        telemetry (``ids_all`` .. ``h_rows``), so the boundary rotation sees
        what the chunked walk would. Returns host logits [B, V] with
        ``with_head``, else None."""
        tr = self._tr
        t_trace = time.perf_counter() if tr is not None else 0.0
        cfg, clock, d = self.cfg, self.clock, self.cfg.d_model
        x = out["route_x"][start].reshape(self.batch, c, d)
        cur = self._device_scalar(cur_len)
        self.stats.device_dispatches += 1             # device-side slice
        for layer, li in self._suffix(start):
            if li is None:
                x = self._dense_layer(layer, x, "chunk", cur)
                continue
            p_l = self.layers[layer]
            x_mid, h2, _ = tfm.attn_half(cfg, p_l, x, "chunk", self.state[layer], cur, 0,
                                         rt=self.rt)
            ids_dev, w_dev = moe_mod.route(p_l["moe"], h2, cfg.moe)
            x, miss_dev = self._moe_layer(li, x_mid, h2, ids_dev, w_dev)
            self.stats.device_dispatches += 2
            ids = ids_dev.cpu().numpy()
            weights = w_dev.cpu().numpy()
            miss = miss_dev.cpu().numpy()
            self.stats.sync_pulls += 1
            self.stats.replay_pulls += 1
            self.manager.record_routing(li, ids, miss)
            if miss.any() and self.rescfg.host_compute_misses:
                x = self._host_correct(x, li, h2, ids, weights, miss)
            ids_all[li], weights_all[li], miss_all[li] = ids, weights, miss
            h_rows[li] = h2.reshape(-1, d)
            flops, byts = self._layer_cost("attn_moe", x.shape, cur_len, hits=int((~miss).sum()))
            clock.compute(self.cost.compute_s(flops, byts))
        self.stats.prefill_replays += 1
        if tr is not None:
            tr.complete("replay", "launch", t_trace, time.perf_counter(),
                        args={"start_li": start, "chunk": c})
        if not with_head:
            return None
        logits = self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()
        self.stats.sync_pulls += 1
        self.stats.replay_pulls += 1
        return logits

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def prefill(self, tokens: np.ndarray) -> np.ndarray:
        """tokens [B, S] -> logits [B, V] (f32); builds the decode state.

        With ``prefill_chunk=C`` the prompt ingests in power-of-two chunks:
        the fused engine launches one graph per chunk (window-free caches),
        the walking engines (and a windowed cache) walk the same chunks
        layer by layer; both rotate once per chunk boundary through the same
        demand program, so their logits and KV are bit-identical. A prompt
        longer than the cache capacity takes the legacy walk (a chunk would
        wrap the ring)."""
        b, s = tokens.shape
        assert b == self.batch
        if s > self.rt.cache_len and self.cfg.attention.window is None:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len {self.rt.cache_len}")
        cap = attn_mod.cache_capacity(self.cfg.attention, self.rt.cache_len)
        chunked = self.prefill_chunk is not None and s <= cap
        t0 = time.perf_counter()
        if chunked:
            for cache in self.state:          # in place: captured graphs keep their addresses
                cache["k"].zero_()
                cache["v"].zero_()
            if self._fused_decode and self._chunk_prefill_fused_ok:
                logits = self._prefill_fused_chunked(tokens)
            else:
                logits = self._prefill_walk_chunked(tokens)
        else:
            x = self._embed(tokens)
            x = self._run_layers(x, "prefill", 0)
            logits = self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()
        self.stats.wall_s += time.perf_counter() - t0
        self.cur_len = s
        self.stats.tokens += b * s
        return logits

    def decode(self, last_logits: np.ndarray, steps: int, *, greedy: bool = True,
               seed: int = 0, sampler: Optional[Any] = None) -> np.ndarray:
        """Generate ``steps`` tokens. Returns [B, steps] int32. With ``spec_k
        > 1`` decode advances in windows of ``min(spec_k, steps left)``
        positions (the same tokens as single-token decode); else one step per
        token on the fused step, the hot walk or the sync walk. A windowed
        (ring) cache decodes past ``cache_len``; a window-free one refuses to.

        Sampled decode: pass ``sampler`` (a ``SamplerConfig``) or
        ``greedy=False`` (temperature 1.0 seeded by ``seed``). Every draw is
        keyed by its cache position (``models/sampling.py``); the draw
        between windows or steps is one launch on the device. The fused engine then
        always runs the window family (size-1 windows at ``spec_k`` 1,
        drafting by the same draws and accepting by ``stochastic_accept``),
        so single-token and spec-K streams are the same program; the walks
        draw between their steps."""
        if sampler is None and not greedy:
            sampler = SamplerConfig(temperature=1.0, seed=seed)
        sampled = sampler is not None and sampler.temperature > 0.0
        sp = sample_rng = None
        if sampled:
            sp = SampleParams(float(sampler.temperature), int(sampler.top_k),
                              float(sampler.top_p))
            if self._keys_seed != sampler.seed:
                self._keys.copy_(sampling_mod.row_keys(sampler.seed, self.batch, self.device))
                self._keys_seed = sampler.seed
            sample_rng = np.random.default_rng(sampler.seed)
        if (self.cur_len + steps > self.rt.cache_len
                and self.cfg.attention.window is None):
            raise ValueError(f"{self.cur_len} + {steps} positions exceed cache_len "
                             f"{self.rt.cache_len}")
        out = np.zeros((self.batch, steps), np.int32)
        logits = last_logits
        spec = self._fused_decode and self.spec_k > 1
        t0 = time.perf_counter()
        i = 0
        while i < steps:
            if sampled:
                tok = self._draw(logits, sp)
            else:
                tok = np.argmax(logits, axis=-1).astype(np.int32)
            out[:, i] = tok
            t_win = time.perf_counter()
            k = min(self.spec_k, steps - i) if spec else 1
            if k > 1 or (sampled and self._fused_decode):
                extra, logits, advanced = self._decode_window_fused(tok, k, sp, sample_rng)
                out[:, i + 1:i + advanced] = extra.T
            else:
                if self._fused_decode:
                    logits = self._decode_step_fused(tok)
                elif self._hot_decode:
                    logits = self._decode_step_hot(tok)
                else:
                    x = self._embed(tok[:, None])
                    x = self._run_layers(x, "decode", self.cur_len)
                    logits = self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()
                    self.stats.sync_pulls += 1
                if self.logit_log is not None:
                    self.logit_log.append(logits)
                advanced = 1
            i += advanced
            self.cur_len += advanced
            self.stats.steps += advanced
            self.stats.tokens += self.batch * advanced
            self.metrics.histogram(
                "window_ms", "wall ms per decode step/window"
            ).observe((time.perf_counter() - t_win) * 1e3)
        self.stats.wall_s += time.perf_counter() - t0
        self.stats.compute_s = self.clock.compute_s
        self.stats.transfer_s = self.clock.transfer_s
        self.stats.stall_s = self.clock.stall_s
        self.stats.host_compute_s = self.clock.host_s
        self.last_logits = logits          # resume point for chained decodes
        return out

    def generate(self, prompt: np.ndarray, max_new: int, **kw) -> np.ndarray:
        logits = self.prefill(prompt)
        return self.decode(logits, max_new, **kw)

    def logged_logits(self) -> np.ndarray:
        """What ``logit_log`` holds, as one host array [positions, B, V] f32
        (window positions are logged as device tensors, pulled here)."""
        rows: List[np.ndarray] = []
        for item in self.logit_log or []:
            if isinstance(item, torch.Tensor):
                rows.extend(item.float().cpu().numpy())
            else:
                rows.append(np.asarray(item, np.float32))
        return np.stack(rows)


def _check_mesh_engine(cfg: ModelConfig, rt: Runtime, rescfg: ResidencyConfig, *,
                       host_routing: bool, lru: bool, fused_decode: Optional[bool],
                       prefetch: bool, prefill_chunk: Optional[int]) -> None:
    """Raise, before anything is built, for what ``RotaryEngine`` does not
    run over a mesh: the sync walk (host routing, LRU), the hot walk,
    prefetch and the miss relaunch, quantized slots (the reference lowers
    only ``cfg.dtype`` slot planes), the legacy prefill walk (no
    ``prefill_chunk``), rows split over a data axis, and what the sharded
    stack refuses (a ring cache, a recurrent layer)."""
    what = [name for name, on in (
        ("host_routing=True", host_routing), ("LRU residency", lru),
        ("fused_decode=False (the hot walk)", fused_decode is False),
        ("prefetch=True", prefetch),
        (f"{rescfg.quantization} slots", rescfg.quantization is not None),
        ("prefill_chunk=None (the legacy prefill walk)", prefill_chunk is None)) if on]
    if what:
        raise ValueError(f"RotaryEngine over a mesh runs rotary or full residency in "
                         f"{cfg.dtype} slots on the fused step with chunked prefill; not "
                         f"ported there: {', '.join(what)}")
    sizes = axis_sizes(rt.mesh)
    split = [a for a in rt.sharding.dp_axes if sizes.get(a, 1) > 1]
    if split:
        raise ValueError(f"RotaryEngine over a mesh runs every row on each rank; rows split "
                         f"over {split} are not ported")
    rt.tp_size()
    tfm._check_mesh_stack(cfg, rt, rt.cache_len, decode=True)


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
