"""RotaryResidencyManager: per-MoE-layer slot stores + policy + LUT +
accounting, and the startup feasibility check.

The counterpart of ``repro/core/residency.py`` for the synchronous rotation
path. The manager owns the host warehouse (every routed expert, in host
memory, pinned when a card is present) and a ``SlotStore`` per MoE layer
(the rotating device-resident subset). ``prepare_layer`` runs the policy's
proactive transition and uploads; ``resolve`` maps routed ids through the
LUT and classifies hits/misses; ``rotate_from_telemetry`` is the host half
of one fused decode step.

The reference re-stacks every layer's slots into per-segment planes because
its fused step is one ``lax.scan``; the port's step loops over layers and
reads each layer's store and device LUT where they lie, so nothing is
stacked and an upload patches only the store it targets.

Not ported yet: quantized stores, predictive prefetch (shadow generations,
``begin_prefetch``, the miss relaunch's ``ensure_resident``) and speculative
window rotation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ResidencyConfig
from repro_torch.core.policies import ResidencyPolicy, make_policy
from repro_torch.core.slots import SlotStore, gather_rows
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
    total -= cfg.num_layers * m.num_experts * mats * cfg.d_model * m.expert_d_ff
    return total * dtype_bytes


def check_feasibility(
    cfg: ModelConfig,
    rescfg: ResidencyConfig,
    *,
    batch: int,
    cache_len: int,
    dtype_bytes: int = 2,
    device=None,
) -> FeasibilityReport:
    """Two-sided startup check:

    (1) capacity floor — ``num_slots >= top_k + prefetch_margin``;
    (2) memory ceiling — slots + KV + static weights + activation bound must
        fit ``hbm_budget_bytes``, or, when no budget is set and ``device`` is
        a card, the card's free memory (``torch.cuda.mem_get_info``).
    """
    if rescfg.quantization is not None:
        raise NotImplementedError("quantized slot stores are not ported yet")
    m = cfg.moe
    moe_layers = cfg.num_layers
    mats = 3 if cfg.mlp == "swiglu" else 2
    expert_bytes = mats * cfg.d_model * m.expert_d_ff * dtype_bytes
    slots = rescfg.num_slots or m.num_experts
    min_slots = m.top_k + rescfg.prefetch_margin
    slot_bytes = moe_layers * (slots + 1) * expert_bytes

    a = cfg.attention
    kv_bytes = cfg.num_layers * 2 * batch * cache_len * a.num_kv_heads * a.head_dim * dtype_bytes
    static_bytes = _attention_static_bytes(cfg, dtype_bytes)
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
        host_experts: List[Dict[str, torch.Tensor]],   # per MoE layer: {w_*: [E, ...]} on host
        *,
        batch: int,
        cache_len: int,
        device,
        cost: Optional[CostModel] = None,
        stats: Optional[EngineStats] = None,
        seed: int = 0,
        tracer=None,
        metrics=None,
    ):
        self.device = torch.device(device)
        # the card's free memory is the ceiling when no budget is configured
        report = check_feasibility(cfg, rescfg, batch=batch, cache_len=cache_len,
                                   device=self.device)
        if not report.ok:
            raise InitializationError(report.reason)
        self.cfg = cfg
        self.rescfg = rescfg
        self.report = report
        self.cost = cost or CostModel.unmeasured()
        self.stats = stats or EngineStats()
        self.tracer = resolve_tracer(tracer)
        self.metrics = metrics
        self.host_experts = host_experts
        m = cfg.moe
        slots = rescfg.num_slots or m.num_experts
        if rescfg.mode == "full":
            slots = m.num_experts
        self.num_slots = slots
        self.stores: List[SlotStore] = []
        self.policies: List[ResidencyPolicy] = []
        for li, hw in enumerate(host_experts):
            shapes = {name: tuple(w.shape[1:]) for name, w in hw.items()}
            dtype = next(iter(hw.values())).dtype
            store = SlotStore(slots, shapes, dtype, self.device)
            policy = make_policy(rescfg.mode, m.num_experts, slots, rescfg, seed=seed + li)
            if rescfg.mode == "full":
                experts = list(range(m.num_experts))
                self.stats.bytes_uploaded += store.write_batch(
                    experts, {n: gather_rows(w, experts) for n, w in hw.items()}
                )
            self.stores.append(store)
            self.policies.append(policy)
        # persistent device LUT per layer, patched incrementally on rotation
        self._lut_dev: List[Optional[torch.Tensor]] = [None] * len(host_experts)

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

    def _execute_loads(self, layer: int, loads: Sequence[Tuple[int, int]]) -> int:
        """Upload ``loads`` as one batched copy per weight tensor."""
        if not loads:
            return 0
        hw = self.host_experts[layer]
        store = self.stores[layer]
        experts = [int(e) for e, _ in loads]
        slots = [int(s) for _, s in loads]
        moved = store.write_batch(slots, {n: gather_rows(w, experts) for n, w in hw.items()})
        self.stats.upload_dispatches += 1
        self.stats.device_dispatches += 1
        self.stats.bytes_uploaded += moved
        tr = self.tracer
        if tr is not None:
            tr.instant("upload", "rotation",
                       args={"layer": layer, "bytes": moved, "n": len(loads),
                             "shadow": False})
        if self.metrics is not None:
            self.metrics.histogram(
                "upload_bytes", "bytes per slot-upload dispatch", buckets=BYTES_BUCKETS,
            ).observe(moved)
        return moved

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
        """The persistent device copy of ``layer``'s LUT (int64 [E]).

        The first call uploads the whole table; later calls patch only the
        entries the policy changed since (``SlotLUT.take_dirty``), or re-upload
        it whole when more than half changed."""
        lut = self.policies[layer].lut
        cached = self._lut_dev[layer]
        if cached is None or lut.dirty_count() > lut.num_experts // 2:
            lut.take_dirty()
            cached = torch.as_tensor(lut.as_array().astype(np.int64)).to(self.device)
            self._lut_dev[layer] = cached
        elif lut.dirty_count():
            idx = np.asarray(lut.take_dirty(), np.int64)
            vals = torch.as_tensor(lut.e2s[idx].astype(np.int64)).to(self.device)
            cached.index_copy_(0, torch.as_tensor(idx).to(self.device), vals)
            self.stats.lut_patch_dispatches += 1
            self.stats.device_dispatches += 1
        return cached

    def layer_residency(self, layer: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(slot buffers, device LUT) that layer's MoE half reads."""
        return self.stores[layer].as_dict(), self.device_lut(layer)

    def residency(self) -> List[Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
        return [self.layer_residency(l) for l in range(len(self.stores))]

    def record_routing(self, layer: int, ids: np.ndarray, miss: np.ndarray) -> None:
        """Hit/miss accounting + policy usage feedback for routing classified
        ON DEVICE — the bookkeeping half of ``resolve``."""
        self.policies[layer].touch(np.unique(ids))
        ls = self.stats.layer(layer)
        ls.hits += int((~miss).sum())
        ls.misses += int(miss.sum())

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
        telemetry (the reference's ``_rotate_from_telemetry`` without the
        prefetch commit)."""
        tr = self.tracer
        if tr is not None:
            with tr.span("rotation", "rotation", args={"kind": "step"}):
                return self._rotate(predictor, ids, weights, miss, demand_next, clock, record)
        return self._rotate(predictor, ids, weights, miss, demand_next, clock, record)

    def _rotate(self, predictor, ids, weights, miss, demand_next, clock, record) -> None:
        n = len(self.policies)
        for l in range(n):
            if record:
                self.record_routing(l, ids[l], miss[l])
            predictor.observe(l, ids[l], weights[l])
        for l in range(n):
            nxt = (l + 1) % n
            raw = demand_next[l]
            demand = predictor.update(nxt, raw)
            self.prepare_layer(nxt, demand, clock, steer=raw)

    def host_expert_flops(self, tokens: int) -> float:
        m = self.cfg.moe
        mats = 3 if self.cfg.mlp == "swiglu" else 2
        return 2.0 * tokens * mats * self.cfg.d_model * m.expert_d_ff
