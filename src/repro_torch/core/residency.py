"""RotaryResidencyManager: per-MoE-layer slot stores + policy + LUT +
accounting, and the startup feasibility check.

The counterpart of ``repro/core/residency.py`` for the synchronous rotation
path. The manager owns the host warehouse (every routed expert, in host
memory, pinned when a card is present; under int8/int4 quantized once, when
the manager is built, into the stores' packed planes) and a ``SlotStore``
per MoE layer (the rotating device-resident subset). ``prepare_layer`` runs
the policy's proactive transition and uploads; ``resolve`` maps routed ids
through the LUT and classifies hits/misses; ``rotate_from_telemetry`` is the
host half of one fused decode step.

The reference re-stacks every layer's slots into per-segment planes because
its fused step is one ``lax.scan``; the port's step loops over layers and
reads each layer's store and device LUT where they lie, so nothing is
stacked and an upload patches only the store it targets. Every plane and
device LUT keeps its address for the engine's life (the device LUT is
rewritten in place), which is what lets the engine capture its decode step
as one CUDA graph.

The miss relaunch's ``ensure_resident`` uploads exactly the experts a step
missed. Predictive prefetch (``enable_prefetch``) folds a shadow generation
into every store's planes (``SlotStore.ensure_shadow``); ``begin_prefetch``
ships the simulated next transition's uploads into it on a copy stream of
its own while the step's replay runs, and the boundary's ``_commit_layer``
drifts, uploads live, or corrects + catches up + flips, in the reference's
order. A flip rewrites that layer's device LUT to point into the other half;
the compute stream waits on the copy stream's work before the next step.

``rotate_window_from_telemetry`` is the boundary of a speculative window:
the host transitions run once per committed step, in step order, and the
uploads coalesce to one batch per layer per window.

Under the tensor (model) axis (``shard=(rank, tp)``) the warehouse and every
store hold this rank's slice of the expert width F (``slots.shard_experts``,
``SlotStore(shard=)``); the LUTs, rings, predictor and counters are the
same on every rank, which routes the same all-reduced hiddens and so makes
the same transitions.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.base import KV_KINDS, ModelConfig, ResidencyConfig, ShardingConfig
from repro_torch.core.policies import ResidencyPolicy, make_policy
from repro_torch.core.slots import (
    SlotStore, quantize_experts, quantized_expert_bytes, shard_experts, shard_width,
)
from repro_torch.core.stats import EngineStats
from repro_torch.core.transfer import CostModel, TransferClock
from repro_torch.obs.metrics import BYTES_BUCKETS
from repro_torch.obs.tracer import resolve_tracer


class InitializationError(RuntimeError):
    """Startup failure (the paper's 'failed to initialize', Fig. 3 N36/4096)."""


@dataclass
class FeasibilityReport:
    ok: bool
    reason: str
    slot_bytes: int
    kv_bytes: int
    static_bytes: int            # non-MoE weights always resident
    activation_bytes: int
    total_bytes: int
    budget_bytes: Optional[int]
    min_slots: int


def _attention_static_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Weights that always stay on-device: everything except routed experts."""
    from repro_torch.models.params import analytic_params

    m = cfg.moe
    mats = 3 if cfg.mlp == "swiglu" else 2
    total = analytic_params(cfg, active_only=False)
    total -= cfg.num_moe_layers * m.num_experts * mats * cfg.d_model * m.expert_d_ff
    return total * dtype_bytes


def _static_split_bytes(cfg: ModelConfig, tp: int, dtype_bytes: int) -> int:
    """The bytes of the static weights that a rank of a tensor axis of
    ``tp`` does not hold: each non-expert leaf (shapes from a ``meta``
    tree) less its share under ``shard_params``' rules (the vocabulary of
    ``embed`` / ``lm_head``, the heads of each projection where they
    divide, the MLP and shared-expert columns and rows)."""
    from repro_torch.distributed.sharding import _axes, make_param_shardings
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import items

    params = init_params(cfg, 0, "meta")
    sh = ShardingConfig()
    mesh = {**{a: 1 for a in sh.dp_axes}, sh.tp_axis: tp}
    specs = make_param_shardings(cfg, mesh, sh, params)
    off = 0
    for path, leaf in items(params):
        if "/experts/" not in path:
            parts = math.prod(mesh[a] for entry in specs[path] for a in _axes(entry))
            off += leaf.numel() - leaf.numel() // parts
    return off * dtype_bytes


def check_feasibility(
    cfg: ModelConfig,
    rescfg: ResidencyConfig,
    *,
    batch: int,
    cache_len: int,
    dtype_bytes: int = 2,
    device=None,
    shard: Optional[Tuple[int, int]] = None,
) -> FeasibilityReport:
    """Two-sided startup check:

    (1) capacity floor — ``num_slots >= top_k + prefetch_margin``;
    (2) memory ceiling — slots + KV + static weights + activation bound must
        fit ``hbm_budget_bytes``, or, when no budget is set and ``device`` is
        a card, the card's free memory (``torch.cuda.mem_get_info``).

    ``shard=(rank, tp)`` counts what one rank of a tensor axis of ``tp``
    holds: each slot's F slice (``slots.shard_width``), its slice of every
    KV cache where ``_sharded_zero_state`` splits it (a KV-only stack whose
    capacity the axis divides) and its ``shard_params`` share of the static
    weights. Without it the counts are the whole model's, as the
    reference's.
    """
    m = cfg.require_moe("expert residency")
    moe_layers = cfg.num_moe_layers
    # exact packed bytes per expert (int4 includes its group scale/min planes)
    shapes = {"w_up": (cfg.d_model, m.expert_d_ff), "w_down": (m.expert_d_ff, cfg.d_model)}
    if cfg.mlp == "swiglu":
        shapes["w_gate"] = (cfg.d_model, m.expert_d_ff)
    if shard is not None:
        for name, shape in shapes.items():
            dim, (lo, hi) = shard_width(name, shape, *shard)
            shapes[name] = shape[:dim] + (hi - lo,) + shape[dim + 1:]
    expert_bytes = quantized_expert_bytes(shapes, rescfg.quantization, dtype_bytes,
                                          rescfg.quant_group_size)
    slots = rescfg.num_slots or m.num_experts
    min_slots = m.top_k + rescfg.prefetch_margin
    slot_bytes = moe_layers * (slots + 1) * expert_bytes

    a = cfg.attention
    kv_bytes = cfg.num_layers * 2 * batch * cache_len * a.num_kv_heads * a.head_dim * dtype_bytes
    static_bytes = _attention_static_bytes(cfg, dtype_bytes)
    if shard is not None:
        from repro_torch.models.attention import cache_capacity

        tp = shard[1]
        if (all(kind in KV_KINDS for kind in cfg.layer_kinds)
                and cache_capacity(a, cache_len) % tp == 0):
            kv_bytes //= tp
        static_bytes -= _static_split_bytes(cfg, tp, dtype_bytes)
    act_bytes = 8 * batch * cfg.d_model * dtype_bytes * 16
    total = slot_bytes + kv_bytes + static_bytes + act_bytes
    budget = rescfg.hbm_budget_bytes
    where = "budget"
    if budget is None and device is not None and torch.device(device).type == "cuda":
        budget = int(torch.cuda.mem_get_info(torch.device(device))[0])
        where = "free device memory"

    def report(ok: bool, reason: str) -> FeasibilityReport:
        return FeasibilityReport(ok, reason, slot_bytes, kv_bytes, static_bytes,
                                 act_bytes, total, budget, min_slots)

    if rescfg.mode != "full" and slots < min_slots:
        return report(False, f"num_slots={slots} < top_k({m.top_k}) + prefetch_margin"
                             f"({rescfg.prefetch_margin}) = {min_slots}: no startup margin")
    if budget is not None and total > budget:
        return report(False, f"resident bytes {total/2**30:.2f} GiB exceed {where} "
                             f"{budget/2**30:.2f} GiB")
    return report(True, "ok")


class RotaryResidencyManager:
    """Owns residency state for every MoE layer of one model instance."""

    def __init__(
        self,
        cfg: ModelConfig,
        rescfg: ResidencyConfig,
        host_experts: List[Dict[str, torch.Tensor]],   # per MoE layer: {w_*: [E, ...]} float
        *,
        batch: int,
        cache_len: int,
        device,
        cost: Optional[CostModel] = None,
        stats: Optional[EngineStats] = None,
        seed: int = 0,
        tracer=None,
        metrics=None,
        shard: Optional[Tuple[int, int]] = None,
    ):
        """``shard=(rank, tp)``: this rank of a tensor axis of ``tp`` keeps
        its F slice of every expert, in the warehouse and in the slots
        (unquantized only)."""
        if shard is not None and rescfg.quantization is not None:
            raise ValueError("slots split over the tensor axis hold unquantized planes only")
        self.device = torch.device(device)
        # the card's free memory is the ceiling when no budget is configured
        report = check_feasibility(cfg, rescfg, batch=batch, cache_len=cache_len,
                                   device=self.device, shard=shard)
        if not report.ok:
            raise InitializationError(report.reason)
        self.cfg = cfg
        self.rescfg = rescfg
        self.report = report
        self.cost = cost or CostModel.unmeasured()
        self.stats = stats or EngineStats()
        self.tracer = resolve_tracer(tracer)
        self.metrics = metrics
        m = cfg.moe
        slots = rescfg.num_slots or m.num_experts
        if rescfg.mode == "full":
            slots = m.num_experts
        self.num_slots = slots
        q = rescfg.quantization
        self.shard = shard
        self.host_experts: List[Dict[str, torch.Tensor]] = []
        self.stores: List[SlotStore] = []
        self.policies: List[ResidencyPolicy] = []
        for li, experts in enumerate(host_experts):
            shapes = {name: tuple(w.shape[1:]) for name, w in experts.items()}
            dtype = next(iter(experts.values())).dtype
            # a quantized warehouse keeps only the packed planes, made on the
            # engine's device one layer at a time
            if shard is not None:
                hw = shard_experts(experts, *shard)
            elif q is None:
                hw = experts
            else:
                hw = quantize_experts(experts, q, rescfg.quant_group_size, device=self.device)
            self.host_experts.append(hw)
            store = SlotStore(slots, shapes, dtype, self.device, q, rescfg.quant_group_size,
                              shard=shard)
            policy = make_policy(rescfg.mode, m.num_experts, slots, rescfg, seed=seed + li)
            if rescfg.mode == "full":
                every = list(range(m.num_experts))
                self.stats.bytes_uploaded += store.write_batch(every, hw)
            self.stores.append(store)
            self.policies.append(policy)
        # persistent device LUT per layer, rewritten in place on rotation
        self._lut_dev: List[Optional[torch.Tensor]] = [None] * len(host_experts)
        self._lut_base: List[int] = [0] * len(host_experts)   # the half it points into
        # -- predictive prefetch (double-buffered generations) --------------
        # ``enable_prefetch`` turns it on. ``_pending`` holds the speculative
        # plan between ``begin_prefetch`` and the boundary's commit; the
        # contents dicts track slot -> expert of each generation per layer.
        self._prefetch_enabled = False
        self._pending: Optional[List[List[Tuple[int, int, bool]]]] = None
        self._live_contents: Optional[List[Dict[int, int]]] = None
        self._shadow_contents: Optional[List[Dict[int, int]]] = None
        self._sim_backoff = 1
        self._sim_skip = 0
        self._copy_stream = None       # CUDA stream of the shadow uploads
        # event pairs around each shadow upload not yet summed into _copy_ms
        self._copy_spans: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._copy_ms = 0.0

    # ------------------------------------------------------------------
    def _transition(self, layer: int, demand: np.ndarray,
                    steer: Optional[np.ndarray] = None) -> List[Tuple[int, int]]:
        """Run the policy's proactive transition and account its rotation
        decision; returns the loads without executing them."""
        policy = self.policies[layer]
        loads = policy.prepare(demand, steer)
        ls = self.stats.layer(layer)
        decision = getattr(policy, "last_decision", None)
        if decision is not None:
            if decision.reverse_jump:
                ls.reverse_rotations += 1
            elif decision.delta:
                ls.forward_rotations += 1
        return loads

    def prepare_layer(self, layer: int, demand: np.ndarray,
                      clock: Optional[TransferClock] = None,
                      steer: Optional[np.ndarray] = None) -> int:
        """Run the proactive policy transition; execute uploads. Returns bytes."""
        loads = self._transition(layer, demand, steer)
        moved = self._execute_loads(layer, loads)
        ls = self.stats.layer(layer)
        ls.loads += len(loads)
        ls.bytes_loaded += moved
        if clock is not None:
            clock.prefetch(moved)
        return moved

    def _execute_loads(self, layer: int, loads: Sequence[Tuple[int, int]], *,
                       shadow: bool = False) -> int:
        """Upload ``loads`` (one copy per expert and plane, straight from the
        warehouse rows) into the live generation on the current stream, or
        (``shadow``) into the shadow generation on the copy stream, which an
        in-flight step does not read."""
        if not loads:
            return 0
        hw = self.host_experts[layer]
        store = self.stores[layer]
        experts = [int(e) for e, _ in loads]
        slots = [int(s) for _, s in loads]
        rows = {n: [w[e] for e in experts] for n, w in hw.items()}     # warehouse views
        if shadow and self._copy_stream is not None:
            span = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            with self._on_copy_stream():
                span[0].record()
                moved = store.write_batch(slots, rows, shadow=True)
                span[1].record()
            self._copy_spans.append(span)
        else:
            moved = store.write_batch(slots, rows, shadow=shadow)
        self.stats.upload_dispatches += 1
        self.stats.device_dispatches += 1
        self.stats.bytes_uploaded += moved
        if self._live_contents is not None:
            tracked = self._shadow_contents if shadow else self._live_contents
            for e, s in loads:
                tracked[layer][int(s)] = int(e)
        tr = self.tracer
        if tr is not None:
            tr.instant("upload", "prefetch" if shadow else "rotation",
                       args={"layer": layer, "bytes": moved, "n": len(loads),
                             "shadow": shadow})
        if self.metrics is not None:
            self.metrics.histogram(
                "upload_bytes", "bytes per slot-upload dispatch", buckets=BYTES_BUCKETS,
            ).observe(moved)
        return moved

    def _on_copy_stream(self):
        """Context of the shadow generation's work: the copy stream on the
        card, the current (only) stream on the CPU."""
        if self._copy_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._copy_stream)

    def resolve(self, layer: int, ids: np.ndarray,
                clock: Optional[TransferClock] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Routed ids [T, k] -> (lut array [E], miss mask [T, k]). LRU-style
        policies may answer a miss with a blocking load; others leave misses
        to host compute."""
        policy = self.policies[layer]
        policy.touch(np.unique(ids))
        lut = policy.lut
        miss = lut.e2s[ids] == lut.miss
        if miss.any():
            for e in np.unique(ids[miss]):
                load = policy.on_miss(int(e))
                if load is not None:
                    moved = self._execute_loads(layer, [load])
                    ls = self.stats.layer(layer)
                    ls.loads += 1
                    ls.bytes_loaded += moved
                    if clock is not None:
                        clock.blocking(moved)
            miss = lut.e2s[ids] == lut.miss
        ls = self.stats.layer(layer)
        ls.hits += int((~miss).sum())
        ls.misses += int(miss.sum())
        return lut.as_array(), miss

    # ------------------------------------------------------------------
    def device_lut(self, layer: int) -> torch.Tensor:
        """The persistent device copy of ``layer``'s LUT (int64 [E]): each
        expert's row in the store's planes (its slot plus the live
        generation's ``base``), ``miss_row`` for a non-resident one.

        The first call allocates and fills it; later calls rewrite it IN
        PLACE (one non-blocking copy from pinned memory, on the current
        stream) when the policy changed an entry since (``SlotLUT.take_dirty``)
        or a flip moved the live half, so its address never changes."""
        lut = self.policies[layer].lut
        store = self.stores[layer]
        cached = self._lut_dev[layer]
        moved = self._lut_base[layer] != store.base()
        if cached is not None and not moved and not lut.dirty_count():
            return cached
        lut.take_dirty()
        vals = lut.e2s.astype(np.int64)
        if store.generations > 1:
            vals = np.where(vals == lut.miss, store.miss_row, vals + store.base())
        src = torch.from_numpy(vals)
        if self.device.type == "cuda":
            src = src.pin_memory()
        if cached is None:
            cached = self._lut_dev[layer] = torch.empty(vals.shape, dtype=torch.int64,
                                                        device=self.device)
        else:
            self.stats.lut_patch_dispatches += 1
            self.stats.device_dispatches += 1
        cached.copy_(src, non_blocking=True)
        self._lut_base[layer] = store.base()
        return cached

    def layer_residency(self, layer: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(slot planes, device LUT) that layer's MoE half reads."""
        return self.stores[layer].raw_dict(), self.device_lut(layer)

    def residency(self) -> List[Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
        return [self.layer_residency(l) for l in range(len(self.stores))]

    def record_routing(self, layer: int, ids: np.ndarray, miss: np.ndarray) -> None:
        """Hit/miss accounting + policy usage feedback for routing classified
        ON DEVICE — the bookkeeping half of ``resolve``."""
        self.policies[layer].touch(np.unique(ids))
        ls = self.stats.layer(layer)
        ls.hits += int((~miss).sum())
        ls.misses += int(miss.sum())

    def ensure_resident(self, layer: int, experts: np.ndarray,
                        avoid: np.ndarray) -> Optional[List[Tuple[int, int]]]:
        """Make ``experts`` resident NOW (the miss relaunch's correction):
        give each missing one a slot whose occupant is not in ``avoid`` (the
        step's full routed set: evicting one of those would turn a hit into a
        fresh miss), coldest ring EMA first, and upload them as one batched
        live write. Returns the loads, or None when the residency cannot
        cover them (the caller falls back to the host-corrected replay)."""
        policy = self.policies[layer]
        lut = policy.lut
        need = [int(e) for e in np.unique(experts) if not lut.is_resident(int(e))]
        if not need:
            return []
        avoid_set = set(int(e) for e in avoid)
        free = list(lut.free_slots)
        evictable = [s for s in range(lut.num_slots)
                     if lut.s2e[s] >= 0 and int(lut.s2e[s]) not in avoid_set]
        ring = getattr(policy, "ring", None)
        if ring is not None:
            # the correction is reactive: displace the expert least likely
            # to be routed (and re-uploaded) next step
            evictable.sort(key=lambda s: (ring.ema[int(lut.s2e[s])], s))
        if len(free) + len(evictable) < len(need):
            return None
        loads: List[Tuple[int, int]] = []
        for e in need:
            slot = free.pop(0) if free else evictable.pop(0)
            lut.assign(e, slot)
            loads.append((e, slot))
        moved = self._execute_loads(layer, loads)
        ls = self.stats.layer(layer)
        ls.loads += len(loads)
        ls.bytes_loaded += moved
        return loads

    # -- predictive prefetch over double-buffered generations ------------
    def enable_prefetch(self, margin: Optional[int] = None) -> None:
        """Switch to double-buffered prefetch: fold a shadow generation into
        every store, start tracking both generations' slot contents, hand
        every policy its steering margin (``ResidencyConfig.prefetch_margin``
        unless given) and, on the card, make the copy stream. Called before
        anything reads the planes, since the fold reallocates them."""
        if self._prefetch_enabled:
            return
        if margin is None:
            margin = self.rescfg.prefetch_margin
        for p in self.policies:
            p.prefetch_margin = int(margin)
        self._live_contents = [
            {int(s): int(e) for s, e in enumerate(p.lut.s2e) if e >= 0}
            for p in self.policies
        ]
        for store in self.stores:
            store.ensure_shadow()
        self._shadow_contents = [dict(d) for d in self._live_contents]
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        self._prefetch_enabled = True

    def begin_prefetch(self, predictor, clock: Optional[TransferClock] = None) -> int:
        """Ship the predicted next transition's uploads into the shadow
        generation, on the copy stream. Called right after a step's replay
        is issued (and its telemetry copies queued), so this host work and
        the uploads overlap the step on the card. The plan comes from
        ``simulate_prepare`` on policy clones fed the predictor's current EMA,
        so the authoritative ring/LUT state never advances speculatively.
        Empty plans back the next simulations off (1, 2, 4 .. 16 steps).
        Returns bytes shipped; the boundary's ``_commit_layer`` scores the
        plan."""
        if not self._prefetch_enabled or self._pending is not None:
            return 0
        if self._sim_skip > 0:
            self._sim_skip -= 1
            return 0
        t0 = time.perf_counter()
        self.copy_stream_ms(wait=False)          # keeps the list of event pairs short
        pending: List[List[Tuple[int, int, bool]]] = []
        launched = 0
        total = 0
        for l in range(len(self.policies)):
            plan = self.policies[l].simulate_prepare(
                predictor.forecast(l), predictor.steer_signal(l)
            )
            shadow = self._shadow_contents[l]
            entries: List[Tuple[int, int, bool]] = []
            ship: List[Tuple[int, int]] = []
            for e, s in plan:
                shipped = shadow.get(int(s)) != int(e)
                if shipped:
                    ship.append((int(e), int(s)))
                entries.append((int(e), int(s), shipped))
            moved = self._execute_loads(l, ship, shadow=True)
            launched += len(ship)
            total += moved
            pending.append(entries)
            if clock is not None:
                clock.prefetch(moved)
        self._pending = pending
        if launched:
            self._sim_backoff = 1
        else:
            self._sim_skip = self._sim_backoff
            self._sim_backoff = min(self._sim_backoff * 2, 16)
        self.stats.prefetch_launched += launched
        t1 = time.perf_counter()
        # the reference's definition: host wall time of this call, which runs
        # while the step's replay is in flight
        self.stats.overlap_ms += (t1 - t0) * 1e3
        tr = self.tracer
        if tr is not None:
            tr.complete("prefetch_ship", "prefetch", t0, t1,
                        args={"bytes": total, "launched": launched})
        return total

    def copy_stream_ms(self, wait: bool = True) -> float:
        """Device ms of the shadow uploads on the copy stream so far, each
        timed by a pair of CUDA events around it (0 on the CPU). ``wait``
        waits for the uploads still in flight; else only finished ones are
        summed (the rest stay for a later call)."""
        left = []
        for start, end in self._copy_spans:
            if wait:
                end.synchronize()
            elif not end.query():
                left.append((start, end))
                continue
            self._copy_ms += start.elapsed_time(end)
        self._copy_spans = left
        return self._copy_ms

    def _commit_layer(self, layer: int, loads: List[Tuple[int, int]],
                      clock: Optional[TransferClock] = None) -> int:
        """Boundary reconciliation for one layer: score the speculative plan
        against the authoritative coalesced ``loads``, then (1) nothing
        rotated: drift; (2) the shadow holds nothing this transition can
        reuse: a plain live upload; (3) else correct the shadow's
        mispredicted slots, catch up the slots it lags on (device to
        device), and flip. Corrections and catch-up land BEFORE the flip, so
        the generation the next step reads holds what the synchronous path
        would have uploaded."""
        store = self.stores[layer]
        live = self._live_contents[layer]
        shadow = self._shadow_contents[layer]
        required = dict(live)
        for e, s in loads:
            required[int(s)] = int(e)
        plan = self._pending[layer] if self._pending is not None else []
        hits = wasted = useful = 0
        for e, s, shipped in plan:
            if required.get(s) == e:
                hits += 1
                if shipped:
                    useful += 1
            elif shipped:
                wasted += 1
        self.stats.prefetch_hits += hits
        self.stats.prefetch_wasted_bytes += wasted * store.bytes_per_expert
        tr = self.tracer
        if not loads:
            # nothing rotated: keep the live generation, let the shadow drift
            if tr is not None and plan:
                tr.instant("prefetch_commit", "prefetch",
                           args={"layer": layer, "hits": hits, "wasted": wasted,
                                 "outcome": "drift"})
            return 0
        if useful == 0:
            # no shipped byte is reusable: the flip would cost more dispatches
            # than the plain live upload for no saved transfer
            moved = self._execute_loads(layer, loads)
            ls = self.stats.layer(layer)
            ls.loads += len(loads)
            ls.bytes_loaded += moved
            if clock is not None:
                clock.prefetch(moved)
            if tr is not None:
                tr.instant("prefetch_commit", "prefetch",
                           args={"layer": layer, "hits": hits, "wasted": wasted,
                                 "outcome": "live_fallback"})
            return moved
        # (1) mispredicted / unpredicted load slots: host-upload corrections
        corrections = [(e, s) for e, s in loads if shadow.get(int(s)) != int(e)]
        moved = self._execute_loads(layer, corrections, shadow=True)
        # (2) slots the shadow lags on: device-to-device copy from live
        stale = sorted(s for s in set(live) | set(shadow) if shadow.get(s) != required.get(s))
        if stale:
            with self._on_copy_stream():
                self.stats.device_dispatches += store.sync_shadow_slots(stale)
            for s in stale:
                shadow[s] = required[s]
        # (3) flip: the corrected shadow becomes live (device_lut follows)
        store.flip()
        self._live_contents[layer] = required
        self._shadow_contents[layer] = live
        if tr is not None:
            tr.instant("prefetch_commit", "prefetch",
                       args={"layer": layer, "hits": hits, "wasted": wasted,
                             "corrections": len(corrections), "stale": len(stale),
                             "outcome": "flip"})
        ls = self.stats.layer(layer)
        ls.loads += len(loads)
        ls.bytes_loaded += moved
        if clock is not None:
            clock.prefetch(moved)
        return moved

    def _coalesce_loads(self, layer: int, loads: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        """The last write per slot, dropping writes the LUT no longer
        references."""
        lut = self.policies[layer].lut
        final: Dict[int, int] = {}
        for e, s in loads:
            final[s] = e
        return [(e, s) for s, e in final.items() if lut.s2e[s] == e]

    def rotate_from_telemetry(
        self,
        predictor,                       # DemandPredictor
        ids: np.ndarray,                 # [L, T, k] routed expert ids
        weights: np.ndarray,             # [L, T, k] routing weights
        miss: np.ndarray,                # [L, T, k] device-classified misses
        demand_next: np.ndarray,         # [L, E]; row l = demand of layer (l+1)%L
        clock: Optional[TransferClock] = None,
        record: bool = True,
    ) -> None:
        """Between-step rotation + predictor feedback from ONE fused step's
        telemetry (the reference's ``_rotate_from_telemetry``), committing a
        pending prefetch plan where ``begin_prefetch`` left one."""
        tr = self.tracer
        if tr is not None:
            with tr.span("rotation", "rotation", args={"kind": "step"}):
                return self._rotate(predictor, ids, weights, miss, demand_next, clock, record)
        return self._rotate(predictor, ids, weights, miss, demand_next, clock, record)

    def _rotate(self, predictor, ids, weights, miss, demand_next, clock, record) -> None:
        n = len(self.policies)
        copy = self._copy_stream
        if copy is not None and self._pending is not None:
            # the catch-up copies read live rows the compute stream wrote
            copy.wait_stream(torch.cuda.current_stream(self.device))
        for l in range(n):
            if record:
                self.record_routing(l, ids[l], miss[l])
            predictor.observe(l, ids[l], weights[l])
        for l in range(n):
            nxt = (l + 1) % n
            raw = demand_next[l]
            demand = predictor.update(nxt, raw)
            if self._pending is not None:
                loads = self._coalesce_loads(nxt, self._transition(nxt, demand, steer=raw))
                self._commit_layer(nxt, loads, clock)
            else:
                self.prepare_layer(nxt, demand, clock, steer=raw)
        self._pending = None
        if copy is not None:
            # the next step reads what the copy stream wrote into a flipped half
            torch.cuda.current_stream(self.device).wait_stream(copy)

    def rotate_window_from_telemetry(
        self,
        predictor,                       # DemandPredictor
        ids: np.ndarray,                 # [K, L, T, k] routed ids per committed step
        weights: np.ndarray,             # [K, L, T, k]
        miss: np.ndarray,                # [K, L, T, k]
        demand_next: np.ndarray,         # [K, L, E]; [s, l] = step s's demand of (l+1)%L
        clock: Optional[TransferClock] = None,
        record: bool = True,
        accepted: Optional[np.ndarray] = None,
    ) -> None:
        """Window-boundary rotation from a speculative window's committed
        steps (the reference's ``rotate_window_from_telemetry``). The host
        transitions (EMA folds, ring moves, LUT updates) run once per step in
        step order, so residency after the window is what feeding the steps
        one at a time through ``rotate_from_telemetry`` leaves; the uploads
        coalesce to the last write per slot and ship as one batch per layer
        (or, with a pending prefetch plan, one commit per layer).

        ``accepted`` [B] (the serving engine's ragged commits; None: the
        rotary engine, which commits batch-uniformly and pre-slices): the
        window is cut to ``accepted.max()`` steps, and step ``s`` records a
        row's routing and folds it into the predictor (``observe`` then
        ``update`` per step) only while ``s < accepted[row]``, so pad rows
        and rejected suffixes touch neither."""
        tr = self.tracer
        if tr is not None:
            with tr.span("rotation", "rotation", args={"kind": "window"}):
                return self._rotate_window(predictor, ids, weights, miss, demand_next,
                                           clock, record, accepted)
        return self._rotate_window(predictor, ids, weights, miss, demand_next, clock, record,
                                   accepted)

    def _rotate_window(self, predictor, ids, weights, miss, demand_next, clock, record,
                       accepted=None) -> None:
        n = len(self.policies)
        if accepted is not None:
            accepted = np.asarray(accepted)
            k_eff = int(accepted.max(initial=0))
            if k_eff == 0:
                return
            ids, weights, miss, demand_next = (a[:k_eff] for a in (ids, weights, miss, demand_next))
        k_steps = ids.shape[0]

        def rows(s: int):
            return slice(None) if accepted is None else accepted > s

        copy = self._copy_stream
        if copy is not None and self._pending is not None:
            copy.wait_stream(torch.cuda.current_stream(self.device))
        if record:
            for s in range(k_steps):
                for l in range(n):
                    self.record_routing(l, ids[s, l][rows(s)], miss[s, l][rows(s)])
        pending: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for l in range(n):
            nxt = (l + 1) % n
            if accepted is None:
                smoothed = predictor.fold_window(nxt, ids[:, nxt], weights[:, nxt],
                                                 demand_next[:, l])
            else:
                smoothed = []
                for s in range(k_steps):
                    sel = rows(s)
                    predictor.observe(nxt, ids[s, nxt][sel], weights[s, nxt][sel])
                    smoothed.append(predictor.update(nxt, demand_next[s, l]))
            for s in range(k_steps):
                pending[nxt].extend(self._transition(nxt, smoothed[s], steer=demand_next[s, l]))
        for l in range(n):
            loads = self._coalesce_loads(l, pending[l])
            if self._pending is not None:
                self._commit_layer(l, loads, clock)
                continue
            moved = self._execute_loads(l, loads)
            ls = self.stats.layer(l)
            ls.loads += len(loads)
            ls.bytes_loaded += moved
            if clock is not None:
                clock.prefetch(moved)
        self._pending = None
        if copy is not None:
            torch.cuda.current_stream(self.device).wait_stream(copy)

    def host_expert_flops(self, tokens: int) -> float:
        m = self.cfg.moe
        mats = 3 if self.cfg.mlp == "swiglu" else 2
        return 2.0 * tokens * mats * self.cfg.d_model * m.expert_d_ff
