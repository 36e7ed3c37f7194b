"""Request-level continuous batching over a paged KV pool, on the card,
and the group tick over a fixed batch.

The counterpart of ``repro/serving/engine.py``. On its paged path every
decode tick is ONE window launch over whatever requests are live right
now: rows join and leave the window BETWEEN launches. A finishing request
frees its KV pages at once (``serving.kv_pool.KVPagePool``), and the next
queued request prefills into them and joins the very next window. Admission
is driven by page-pool pressure (worst-case page reservations at admit, lazy
allocation after, which therefore never fails mid-flight).

* **KV** lives in planes shared by every row (``tfm.paged_zero_state``: per
  layer [pages + 1, ps, Hkv, dh], page 0 the scratch page) addressed
  through per-row page tables. The window's decode attention writes each
  row's new K/V through its table and scores the row's pages with K2's
  paged entry, which reads them through the table itself (on the CPU, the
  plain version gathers the row's view: bitwise the contiguous decode).
* **Windows** run at the engine's full row count (the power-of-two cover of
  ``num_slots``), whatever is live: pad rows carry all-zero page tables,
  zero lengths and tokens (their writes land in the scratch page), and
  ``accepted = 0`` masks them out of acceptance, rotation and the
  predictor. Every matmul of a window then sees one row count, so a row's
  logits and draws are bitwise the same alone or beside other rows (cuBLAS
  picks its kernel, and so its sums' order, by row count). The demand
  program still averages over the rows bucket the reference's window would
  have run (the power-of-two cover of the live rows), so residency moves as
  there. The window size is 1 without speculation, else the slowest live
  row's learned speculative length. On the card each (window size,
  sampler) is one CUDA graph over static device buffers (tokens, lengths
  and the bucket, the page table, the per-request keys) and the persistent
  pool planes, slot planes and LUTs (``core.engine.GraphSet`` and
  ``window_outputs``, shared with ``RotaryEngine``); a moved plane raises,
  as does a failed capture, and nothing falls back to eager.
* **Misses are dropped in-step**, as the reference's serving does: a missed
  expert reads the zero MISS slot, the row commits up to its first missed
  position (at least one), the KV slots past that roll back
  (``tfm.rollback_kv_window`` through the page tables, eager), and the
  window-boundary rotation (``rotate_window_from_telemetry(accepted=)``)
  corrects the next window. There is no suffix replay and no host
  correction in a serving decode window.
* **Admission prefill** (``tfm.prefill_model``): each admitted prompt
  prefilled as a batch-1 row at its exact length (the reference's scan over
  rows) with K4's causal entry. The reference reads every expert from
  ``params``; here the MoE half reads the expert store at full residency;
  under unquantized rotary residency the resident picks through the slot
  stores (K1's ragged entry) and the missed picks on the host
  (``core.engine.host_correct``); under int8/int4 slots the float store,
  staged on the device one layer at a time (the slots hold quantized
  weights, the reference's prefill float ones). So the function is the
  reference's. It never resolves, rotates or records. One scatter per join
  copies the prefix into the request's pages.
* **Sampling** (temperature > 0): the window drafts by position-keyed draws
  with per-request keys (``fold_in(request_key(seed), position)``, each row
  at its own position), ``stochastic_accept`` runs on the pulled
  distributions, and the first token is drawn on the device at the last
  prompt position: a request's stream depends only on its seed.
* **Prefetch** (``prefetch=True``, rotary residency, paged): ``begin_prefetch``
  ships the predicted next boundary's uploads into the shadow generation
  while the window is in flight, at steering margin 0, so the transitions
  stay those of the synchronous run.
* **Dense archs** (``attn_mlp`` stacks): no expert store, router,
  predictor or residency manager; a non-full ``ResidencyConfig`` is
  ignored, as in the reference. Nothing misses, so a greedy window accepts
  every draft and its KV needs no snapshot.

**The group tick** (``paged=False``, and the default for a stack with a
recurrent layer, whose state is per row and cannot be paged): a fixed
contiguous batch of ``num_slots`` rows (``tfm.zero_state``), rows claimed
and freed by the scheduler. A tick is one single-step launch over every
row (``_tick_single``, greedy or through the host ``Sampler``) or, on a
KV-only stack with speculation, one window with contiguous KV snapshot and
rollback (``_tick_window``). A recurrent arch prefills at exact length; the
join splice (``_splice_row``) copies the row's state into the batch IN
PLACE, and the step writes every recurrent state in place, so on the card
the single step and each window size are one CUDA graph over the fixed
batch. A stack without attention (xLSTM) raises: the reference cannot
build it either; its path is ``prefill_model`` + ``decode_model``.

**Tracing** (``trace=`` a ``repro_torch.obs.Tracer``): the reference's
events at the same points of each tick, on the same tracks and lanes. Each
tick that launches is one contract unit (``new_unit("tick")``) holding its
``launch`` span (the graph replay), its ``pull`` span (the one blocking
device-to-host read), ``kv_use`` (the pages the window touches), the
``kv_snapshot`` / ``miss`` / ``kv_rollback`` instants and the residency's
``rotation`` and ``prefetch_ship`` spans; each request has a lane (pid 2,
tid its uid) with ``queued``, ``prefill``, ``token``, ``decode`` and
``finish``; the pool records ``kv_reserve`` / ``kv_ensure`` /
``kv_release``. Every argument comes from host state (page tables,
scheduler, residency bookkeeping): a trace call never reads a device
tensor, so it adds no synchronisation. ``None`` or a disabled tracer
leaves no tracer at all (every emission site is guarded).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ResidencyConfig
from repro_torch.core.engine import (
    GraphSet, _pinned, _to_device, demand_program, host_correct, resolve_device,
    window_outputs,
)
from repro_torch.core.policies import make_policy
from repro_torch.core.predictor import DemandPredictor
from repro_torch.core.residency import RotaryResidencyManager
from repro_torch.core.stats import EngineStats
from repro_torch.models import attention as attn_mod
from repro_torch.models import sampling as sampling_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params
from repro_torch.models.sampling import SampleParams
from repro_torch.models.transformer import Runtime
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import resolve_tracer
from repro_torch.serving.kv_pool import KVPagePool
from repro_torch.serving.sampler import Sampler, SamplerConfig, stochastic_accept
from repro_torch.serving.scheduler import Request, Scheduler


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        *,
        rt: Optional[Runtime] = None,
        num_slots: int = 4,
        residency: Optional[ResidencyConfig] = None,
        sampler: Optional[SamplerConfig] = None,
        eos: Optional[int] = None,
        spec_cap: int = 4,
        paged: Optional[bool] = None,
        kv_page_size: int = 16,
        kv_pages: Optional[int] = None,
        prefetch: bool = False,
        trace=None,
        device="cuda",
    ):
        """``params`` as ``tfm.init_params`` (experts on the host or the
        device) or ``bridge.from_reference`` build them. ``num_slots`` is the
        number of batch rows (requests decoding at once). ``residency`` None
        or full keeps every expert on ``device``; a rotating mode keeps the
        warehouse in (pinned) host memory behind the slot stores.
        ``spec_cap`` bounds the per-row speculative windows (1: none; KV-only
        stacks, and greedy on the group tick). ``paged`` None takes the
        paged pool when every layer is a KV kind, else the group tick;
        ``kv_page_size`` (clamped to the largest divisor of the cache
        capacity) and ``kv_pages`` (default: ``num_slots`` full rows) size
        the pool. ``prefetch`` needs rotary residency and the paged pool.
        ``trace`` (a ``repro_torch.obs.Tracer``) records the ticks, the
        request lanes, the pool's page events and the residency's spans.
        The reference's rules raise here before anything is built."""
        if cfg.attention is None:
            raise ValueError(
                f"{cfg.name}: ServingEngine serves stacks with attention, and "
                f"{sorted(set(cfg.layer_kinds))} has none (the reference fails here too); "
                f"run prefill_model + decode_model")
        kv_only = cfg.kv_only
        if paged is None:
            paged = kv_only
        if paged and not kv_only:
            raise ValueError("paged KV pool requires a KV-cache-only stack; recurrent archs "
                             f"keep the group-tick path ({cfg.layer_kinds})")
        self._paged = bool(paged)
        self.rt = rt or Runtime(cache_len=1024)
        cap = attn_mod.cache_capacity(cfg.attention, self.rt.cache_len)
        # residency rotates MoE layers only: on a dense arch a non-full
        # ResidencyConfig is ignored, as in the reference
        rotating = residency is not None and residency.mode != "full" and cfg.has_moe
        if prefetch:
            if not rotating:
                raise ValueError(
                    "prefetch=True needs a rotating residency manager: pass a non-full "
                    "ResidencyConfig on an MoE architecture (full residency never rotates, "
                    "so there is nothing to prefetch)")
            if not self._paged:
                raise ValueError("prefetch=True rides the paged continuous-batching tick; the "
                                 "group-tick path rotates synchronously")
            m = cfg.moe
            probe = make_policy(residency.mode, m.num_experts,
                                residency.num_slots or m.num_experts, residency)
            if getattr(probe, "needs_sync_resolve", False):
                raise ValueError(
                    "prefetch=True is incompatible with reactive (LRU-style) policies: their "
                    "mid-step blocking loads leave no boundary to flip at")
        self.pool: Optional[KVPagePool] = None
        if self._paged:
            page_size = max(1, min(kv_page_size, cap))
            while cap % page_size:
                page_size -= 1               # largest divisor <= kv_page_size
            row_pages = cap // page_size
            pages = kv_pages if kv_pages is not None else num_slots * row_pages
            if pages < row_pages:
                raise ValueError(f"kv_pages={pages} cannot hold one full row "
                                 f"({row_pages} pages of {page_size})")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.batch = num_slots
        self.eos = eos
        self.sampler = Sampler(sampler or SamplerConfig())
        self.stats = EngineStats()
        self._tr = resolve_tracer(trace)
        self.tracer = self._tr
        self.metrics = MetricsRegistry()
        self._sampled = self.sampler.cfg.temperature > 0.0
        self._sample_params: Optional[SampleParams] = None
        self._accept_rng = None
        if self._sampled:
            c = self.sampler.cfg
            self._sample_params = SampleParams(float(c.temperature), int(c.top_k),
                                               float(c.top_p))
            self._accept_rng = np.random.default_rng(c.seed)
        # windows need KV-only state (rollback restores cache slots; a
        # recurrent update is destructive); the group tick draws sampled
        # tokens through the host Sampler, so it speculates greedy only
        self._spec_ok = spec_cap > 1 and kv_only and (not self._sampled or self._paged)
        self._spec_cap_eff = max(1, min(spec_cap, cap)) if self._spec_ok else 1
        self._spec_ok = self._spec_cap_eff > 1
        self.scheduler = Scheduler(num_slots, spec_cap=self._spec_cap_eff,
                                   max_prompt_len=self.rt.cache_len)
        self.lengths = np.zeros((self.batch,), np.int32)
        self.next_token = np.zeros((self.batch,), np.int32)
        self.active = np.zeros((self.batch,), bool)

        # --- KV: the paged pool (plane page 0 is the scratch page), or the
        # group tick's contiguous batch [num_slots, cap] ----------------
        self.pool_state: Optional[List[Dict[str, torch.Tensor]]] = None
        self.state: Optional[List[Dict[str, torch.Tensor]]] = None
        if self._paged:
            self.pool = KVPagePool(pages, page_size, row_pages, tracer=self._tr)
            self.pool_state = tfm.paged_zero_state(cfg, pages + 1, page_size, dev)
        else:
            self.state = tfm.zero_state(cfg, num_slots, self.rt.cache_len, dev)
        # every window runs at this many rows: one row count for every matmul
        self._rows = 1 << max(0, num_slots - 1).bit_length() if self._paged else num_slots

        # --- weights: experts on the device (full) or the host warehouse --
        pin = torch.cuda.is_available()
        host = torch.device("cpu")
        layers: List[Params] = []
        experts: List[Dict[str, torch.Tensor]] = []
        routers: List[np.ndarray] = []
        for p_l in params["layers"]:
            if "moe" not in p_l:                 # a dense layer: all of it on the device
                layers.append(_to_device(p_l, dev))
                continue
            moe_p = {k: v for k, v in p_l["moe"].items() if k != "experts"}
            if rotating:
                hw = dict(p_l["moe"]["experts"])
                for n, w in hw.items():          # the warehouse: pinned host memory
                    if w.device != host or (pin and not w.is_pinned()):
                        hw[n] = torch.empty(w.shape, dtype=w.dtype, pin_memory=pin).copy_(w)
                experts.append(hw)
                routers.append(p_l["moe"]["router"].float().cpu().numpy())
            else:
                moe_p["experts"] = p_l["moe"]["experts"]
            layers.append(_to_device({**p_l, "moe": moe_p}, dev))
        self.embed_params = _to_device(
            {k: params[k] for k in ("embed", "final_norm", "lm_head") if k in params}, dev)
        self.layers = layers
        self._dparams = {**self.embed_params, "layers": layers}

        # --- residency (rotating modes only) -----------------------------
        self.res_mgr: Optional[RotaryResidencyManager] = None
        self.predictor: Optional[DemandPredictor] = None
        self._routers_next: Optional[torch.Tensor] = None
        self.host_experts: List[Dict[str, torch.Tensor]] = []
        # quantized slots: the float warehouse the admission prefill reads
        self._float_experts: List[Dict[str, torch.Tensor]] = (
            experts if rotating and residency.quantization is not None else [])
        self._stage: Optional[Dict[str, torch.Tensor]] = None
        if rotating:
            # feasibility prices KV bytes: the pool holds pages-worth of KV,
            # not num_slots full rows, so report the pool-equivalent batch
            batch_eff = (max(1, -(-self.pool.num_pages * self.pool.page_size // cap))
                         if self.pool is not None else num_slots)
            self.res_mgr = RotaryResidencyManager(
                cfg, residency, experts, batch=batch_eff, cache_len=self.rt.cache_len,
                device=dev, stats=self.stats, tracer=self._tr, metrics=self.metrics)
            self.host_experts = self.res_mgr.host_experts
            self.predictor = DemandPredictor(routers, ema=residency.predictor_ema)
            if prefetch:
                # margin 0: serving has no replay path (a missed position
                # commits with the expert dropped), so the transition
                # sequence must stay the synchronous run's. Before the warm
                # start, which then lands in the folded planes
                self.res_mgr.enable_prefetch(margin=0)
            for li in range(len(experts)):
                self.res_mgr.prepare_layer(li, self.predictor.smoothed[li])
            self._routers_next = torch.as_tensor(self.predictor.next_layer_routers()).to(dev)
        self.prefetch = bool(prefetch)
        self._f32_scratch: Dict[str, torch.Tensor] = {}      # host miss GEMM (prefill)

        # --- the graphs and their static inputs and pinned pulls ---------
        self._gs = GraphSet(dev.type == "cuda")    # capture False: eager on the card (tests)
        self._static: Dict[str, torch.Tensor] = {}
        self._pulls: Dict[str, torch.Tensor] = {}
        self._residency: Any = None

    # ------------------------------------------------------------------
    @property
    def graph_captures(self) -> int:
        return self._gs.captures

    @property
    def graph_replays(self) -> int:
        return self._gs.replays

    @property
    def graph_capture_s(self) -> float:
        return self._gs.capture_s

    def _request_key(self, req: Request) -> torch.Tensor:
        """[2] base key of one request: a pure function of its seed
        (uid/slot/batch-independent), so its sampled stream is the same
        alone, mid-window or across prefetch."""
        seed = req.seed if req.seed is not None else self.sampler.cfg.seed
        return sampling_mod.request_key(int(seed))

    # ------------------------------------------------------------------
    # admission prefill
    # ------------------------------------------------------------------
    def _prefill_correct(self, last: List[int]):
        """The prefill's host correction of a row's missed picks at
        positions up to its ``last`` (pads need none: the MoE is per token)."""
        def correct(li, row, x, h2, ids, weights, miss):
            miss_np = miss.cpu().numpy()
            miss_np[last[row] + 1:] = False
            if not miss_np.any():
                return x
            x, _, convert_s, n_experts = host_correct(
                x, h2, ids.cpu().numpy(), weights.cpu().numpy(), miss_np,
                self.host_experts[li], self._f32_scratch)
            self.stats.host_dequant_s += convert_s
            self.stats.host_dequant_experts += n_experts
            return x
        return correct

    def _stage_experts(self, li: int) -> Params:
        """Layer ``li``'s float expert store for the prefill under quantized
        slots, copied from the pinned warehouse into one device buffer
        (made on first use) that every layer reuses in turn."""
        src = self._float_experts[li]
        if self.device.type != "cuda":
            return src
        if self._stage is None:
            self._stage = {n: torch.empty(w.shape, dtype=w.dtype, device=self.device)
                           for n, w in src.items()}
        for n, w in src.items():
            self._stage[n].copy_(w, non_blocking=True)
        return self._stage

    def _prefill_rows(self, prompts: List[np.ndarray], width: int
                      ) -> List[Tuple[np.ndarray, List[Dict[str, torch.Tensor]]]]:
        """The prompts right-padded to ``width`` and prefilled in one
        ``prefill_model`` call, each row as a batch-1 prefill at its exact
        length (the reference's scan over rows). Unquantized rotary
        residency reads the resident picks through the slot stores and
        corrects the missed ones on the host; quantized slots read the float
        store, staged on the device a layer at a time, as the reference
        reads ``params``. Returns per row (logits [1, V] f32 on the host,
        its state, every leaf [1, ...])."""
        padded = np.zeros((len(prompts), width), np.int64)
        last = [len(p) - 1 for p in prompts]
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = p
        kw: Dict[str, Any] = {}
        if self._float_experts:
            kw["experts"] = self._stage_experts
        elif self.res_mgr is not None:
            kw.update(residency=self.res_mgr.residency(), correct=self._prefill_correct(last))
        logits, state = tfm.prefill_model(
            self.cfg, self._dparams, torch.from_numpy(padded).to(self.device),
            self.rt.cache_len, last_index=torch.tensor(last), **kw)
        logits = logits.float().cpu().numpy()
        return [(logits[i:i + 1], [{n: t[i:i + 1] for n, t in c.items()} for c in state])
                for i in range(len(prompts))]

    def _prefill_admitted(self, admitted: List[Request]) -> List[Any]:
        """One admission group, each row at its exact length, so per-row
        outputs are the batch-1 path's. Returns [(request, logits [1, V],
        row_state)]."""
        if not admitted:
            return []
        lens = [len(r.prompt) for r in admitted]
        t0 = time.perf_counter()
        rows = self._prefill_rows([r.prompt for r in admitted], max(lens))
        dt = time.perf_counter() - t0
        if dt > 0:
            self.scheduler.observe_prefill_rate(sum(lens) / dt)
        return [(req, logits, state) for req, (logits, state) in zip(admitted, rows)]

    def _splice_row_paged(self, uid: int, row_state: List[Dict[str, torch.Tensor]]) -> None:
        """The join splice: a batch-1 prefill state's KV prefix into the
        pages request ``uid`` owns, one scatter per plane."""
        pages = self.pool.table(uid)
        n, ps = len(pages), self.pool.page_size
        pg = torch.as_tensor(pages, dtype=torch.int64).to(self.device)
        for plane, src in zip(self.pool_state, row_state):
            for name in ("k", "v"):
                blk = src[name][0, :n * ps].reshape((n, ps) + tuple(src[name].shape[2:]))
                plane[name].index_copy_(0, pg, blk)
        self.stats.device_dispatches += 1

    def _splice_row(self, slot: int, row_state: List[Dict[str, torch.Tensor]]) -> None:
        """The group tick's join splice: a batch-1 prefill state (KV caches
        and recurrent states) into batch row ``slot``, in place, so the
        graphs' addresses hold."""
        for dst, src in zip(self.state, row_state):
            for name, t in src.items():
                dst[name][slot].copy_(t[0])

    def _account_pages(self, grew: int) -> None:
        if grew:
            self.stats.kv_pages_allocated += grew
            self.stats.kv_pages_hwm = max(self.stats.kv_pages_hwm, self.pool.pages_in_use)

    def _release_request(self, req: Request) -> None:
        """A finished row leaves the window: its lane closes and its pages
        return to the pool now, for the next queued request at the next
        tick."""
        tr = self._tr
        if tr is not None:
            # lane phase 3: first token -> finished (the decode stretch)
            t1 = req.finished_at or time.perf_counter()
            if req.first_token_at:
                tr.complete("decode", "request", req.first_token_at, t1, lane=req.uid,
                            args={"tokens": len(req.output)})
            tr.instant("finish", "request", lane=req.uid, args={"tokens": len(req.output)})
        if self.pool is not None:
            self.stats.kv_pages_released += self.pool.release(req.uid)

    # ------------------------------------------------------------------
    # the launches: static inputs, graphs, telemetry
    # ------------------------------------------------------------------
    def _static_inputs(self) -> Dict[str, torch.Tensor]:
        """The static device buffers every launch reads (and pinned host
        twins): ``inputs`` [2 * rows + 1] (tokens, lengths, then the demand
        program's rows bucket), ``pt`` [rows, row_pages] int32 (paged),
        ``keys`` [rows, 2]."""
        st = self._static
        if not st:
            pin = self.device.type == "cuda"
            rows = self._rows
            rp = self.pool.row_pages if self.pool is not None else 1
            for n, shape, dt in (("inputs", (2 * rows + 1,), torch.int64),
                                 ("pt", (rows, rp), torch.int32),
                                 ("keys", (rows, 2), torch.int64)):
                st[n] = torch.zeros(shape, dtype=dt, device=self.device)
                st[n + "_h"] = torch.zeros(shape, dtype=dt, pin_memory=pin)
        return st

    def _set_inputs(self, tok: np.ndarray, lens: np.ndarray, bucket: int,
                    pt: Optional[np.ndarray] = None,
                    keys: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        st = self._static_inputs()
        rows = self._rows
        st["inputs_h"][:rows] = torch.from_numpy(tok.astype(np.int64))
        st["inputs_h"][rows:2 * rows] = torch.from_numpy(lens.astype(np.int64))
        st["inputs_h"][2 * rows] = bucket
        st["inputs"].copy_(st["inputs_h"], non_blocking=True)
        if pt is not None:
            st["pt_h"].copy_(torch.from_numpy(pt))
            st["pt"].copy_(st["pt_h"], non_blocking=True)
        if keys is not None:
            st["keys_h"].copy_(torch.from_numpy(keys))
            st["keys"].copy_(st["keys_h"], non_blocking=True)
        return st

    def _telemetry(self, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A position's telemetry: the routing and the on-device demand
        program (the reference's ``_demand_aux_fn`` without replay anchors;
        on the paged path averaged over the rows bucket); none without a
        residency manager, which never rotates."""
        if self.res_mgr is None:
            return {}
        bucket = self._static_inputs()["inputs"][2 * self._rows] if self._paged else None
        return {"ids": aux["route_ids"], "weights": aux["route_weights"],
                "miss": aux["route_miss"],
                "demand_next": demand_program(aux["route_h"], self._routers_next, bucket)}

    def _window_body(self, k: int, sp: Optional[SampleParams]) -> Dict[str, Any]:
        st = self._static_inputs()
        rows = self._rows
        state = self.pool_state if self._paged else self.state
        return window_outputs(self.cfg, self._dparams, st["inputs"][:rows], state,
                              st["inputs"][rows:2 * rows], k, self._residency, self._telemetry,
                              snapshot=self.res_mgr is not None, sample=sp,
                              keys=st["keys"] if sp is not None else None,
                              page_table=st["pt"] if self._paged else None)

    def _step_body(self) -> Dict[str, Any]:
        """The group tick's single step over the fixed batch: logits [B, V]
        f32 and the telemetry."""
        st = self._static_inputs()
        rows = self._rows
        logits, aux = tfm.decode_model(self.cfg, self._dparams, st["inputs"][:rows], self.state,
                                       st["inputs"][rows:2 * rows], self._residency)
        return {"logits": logits.float(), **self._telemetry(aux)}

    def _graph_inputs(self) -> Tuple[int, ...]:
        """Addresses a replay reads besides the weights: the static inputs,
        every slot plane and device LUT, every pool plane or batch state."""
        st = self._static_inputs()
        ptrs = [st[n].data_ptr() for n in ("inputs", "pt", "keys")]
        for planes, lut in self._residency or ():
            ptrs += [t.data_ptr() for t in planes.values()] + [lut.data_ptr()]
        for layer in (self.pool_state if self._paged else self.state):
            ptrs += [t.data_ptr() for t in layer.values()]
        return tuple(ptrs)

    def _launch(self, key: Any, body) -> Dict[str, Any]:
        """One launch: a replay of ``key``'s graph, captured on first use on
        the card; eager on the CPU. The device LUTs are rewritten in place
        first."""
        if self.res_mgr is not None:
            self._residency = self.res_mgr.residency()
        return self._gs.launch(key, body, self._graph_inputs)

    def _window_launch(self, k: int) -> Dict[str, Any]:
        """One window of ``k`` positions over the full row count (key: window
        size, sampler)."""
        sp = self._sample_params
        return self._launch((k, sp), lambda: self._window_body(k, sp))

    def _pull_buffers(self) -> Dict[str, torch.Tensor]:
        """Pinned buffers the launches' outputs land in, leading axis the
        largest window (made on first use); the group tick's single step
        writes position 0 and ``logits``."""
        bufs = self._pulls
        if not bufs:
            kk, rows = self._spec_cap_eff, self._rows
            shapes = dict(draft=((rows,), torch.int64))
            if self.res_mgr is not None:
                n_l, e, k_top = len(self.host_experts), self.cfg.moe.num_experts, self.cfg.moe.top_k
                shapes.update(ids=((n_l, rows, k_top), torch.int32),
                              weights=((n_l, rows, k_top), torch.float32),
                              miss=((n_l, rows, k_top), torch.bool),
                              demand_next=((n_l, e), torch.float32))
            if self._sampled and self._paged:
                shapes.update(sample_probs=((rows, self.cfg.vocab_size), torch.float32))
            bufs.update(_pinned((kk,), **shapes))
            if not self._paged:
                bufs.update(_pinned((), logits=((rows, self.cfg.vocab_size), torch.float32)))
        return bufs

    def _pull_telemetry(self, out: Dict[str, Any], k: Optional[int]) -> None:
        """Queue the telemetry's copies into the pinned buffers (a window's
        first ``k`` positions, or the single step's at position 0), before
        the blocking pull."""
        bufs = self._pull_buffers()
        for name in ("ids", "weights", "miss", "demand_next", "sample_probs"):
            if name in bufs:
                (bufs[name][:k] if k is not None else bufs[name][0]).copy_(
                    out[name], non_blocking=True)
                self.stats.overlapped_pulls += 1

    def _read_telemetry(self, k: Optional[int]) -> Tuple[np.ndarray, ...]:
        bufs = self._pull_buffers()
        sl = slice(None, k) if k is not None else 0
        return tuple(bufs[n][sl].numpy().copy() for n in ("ids", "weights", "miss", "demand_next"))

    # ------------------------------------------------------------------
    def warmup(self) -> int:
        """Capture the launch family before traffic: every window size up
        to the speculative cap at the full row count (for this engine's
        sampler); on the group tick, the single step and the windows. Paged
        warm-up windows write only the scratch page (all-zero page tables,
        zero lengths); the group tick's write row positions a request's
        splice overwrites whole, so call it before submitting. Neither
        touches host bookkeeping, residency or stats. The admission
        prefill runs eagerly, so nothing is captured for it. Returns the
        number of graphs captured."""
        before = self._gs.captures
        rows = self._rows
        zeros = np.zeros((rows,), np.int32)
        ks = range(1, self._spec_cap_eff + 1) if self._spec_ok else (1,)
        if self._paged:
            keys = np.zeros((rows, 2), np.int64) if self._sampled else None
            st = self._set_inputs(zeros, zeros, 1, np.zeros((rows, self.pool.row_pages), np.int32),
                                  keys)
        else:
            st = self._set_inputs(zeros, zeros, rows)
            self._launch(("step",), self._step_body)
            ks = [k for k in ks if k > 1]
        for k in ks:
            out = self._window_launch(k)
            if self.res_mgr is not None:
                tfm.rollback_kv_window(self.pool_state if self._paged else self.state,
                                       out["saved"], st["inputs"][rows:2 * rows], k, 0,
                                       page_table=st["pt"] if self._paged else None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._gs.captures - before

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None) -> Request:
        """``seed`` fixes this request's sampled stream (default: the
        engine sampler's seed); greedy engines ignore it."""
        prompt = np.asarray(prompt, np.int32)
        if self.pool is not None and len(prompt) > self.rt.cache_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the per-request KV capacity "
                f"{self.rt.cache_len} ({self.pool.row_pages} pages x {self.pool.page_size} "
                f"positions at full residency)")
        return self.scheduler.submit(prompt, max_new, time.perf_counter(), deadline_s,
                                     seed=seed)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Drive until all submitted work completes. Returns completed requests."""
        ticks = 0
        t0 = time.perf_counter()
        while not self.scheduler.idle and ticks < max_ticks:
            self.tick()
            ticks += 1
        self.stats.wall_s += time.perf_counter() - t0
        if self.stats.wall_s > 0 and self.stats.steps:
            self.scheduler.observe_rate(self.stats.steps / self.stats.wall_s)
        return self.scheduler.completed

    def tick(self) -> None:
        """One serving iteration: request-level joins (admission against
        pool pressure or free rows, prefill, the splice), then ONE launch
        over the live rows. Public so arrival-driven loops can interleave
        submissions with ticks on the wall clock."""
        now = time.perf_counter()
        tr = self._tr
        admitted = self.scheduler.admit(now, pool=self.pool)
        if tr is not None:
            for req in admitted:
                # lane phase 1: submission -> admission (queueing delay)
                tr.complete("queued", "request", req.submitted_at, now, lane=req.uid,
                            args={"prompt": len(req.prompt)})
        prefilled = self._prefill_admitted(admitted)
        # the first token's time stamp follows its prefill (the reference
        # stamps it with the tick's start, which leaves the prefill out of TTFT)
        t_first = time.perf_counter()
        for req, logits, row_state in prefilled:
            if self._paged:
                self._account_pages(self.pool.ensure(req.uid, len(req.prompt)))
                self._splice_row_paged(req.uid, row_state)
            else:
                self._splice_row(req.slot, row_state)
            self.lengths[req.slot] = len(req.prompt)
            if self._sampled and self._paged:
                # the first token is keyed at the last PROMPT position, so it
                # is the same whenever and wherever the request is admitted
                fn = sampling_mod.build_sample_fn(self._sample_params)
                tok = int(fn(torch.from_numpy(logits).to(self.device),
                             self._request_key(req)[None, :].to(self.device),
                             len(req.prompt) - 1).cpu()[0])
            else:
                tok = int(self.sampler(logits)[0])
            self.next_token[req.slot] = tok
            self.active[req.slot] = True
            self.stats.tokens += len(req.prompt)
            self.scheduler.step_done(req.slot, tok, t_first, self.eos)
            if tr is not None:
                # lane phase 2: admission -> spliced + first token drawn
                tr.complete("prefill", "request", req.admitted_at, time.perf_counter(),
                            lane=req.uid, args={"prompt": len(req.prompt)})
            if req.done:
                self.active[req.slot] = False
                self._release_request(req)
        if not self.scheduler.running:
            return
        if self._paged:
            self._tick_paged()
            return
        # the group tick: the window as far as the slowest running row's
        # learned speculative length allows (acceptance and rollback per row)
        k = 1
        if self._spec_ok:
            k = max(1, min(min(self.scheduler.spec_len(s) for s in self.scheduler.running),
                           self._spec_cap_eff))
        if k > 1:
            self._tick_window(k)
        else:
            self._tick_single()

    def _tick_paged(self) -> None:
        """One continuous-batching window over the paged pool (the
        reference's ``_tick_paged``): the live rows first, pad rows after, at
        the full row count; one launch and one blocking pull, per-row
        acceptance up to the first missed position (at least 1) and the
        budget, the rejected suffixes' pages rolled back, then the
        window-boundary rotation with ``accepted`` masking pad rows and
        rejected positions."""
        sch = self.scheduler
        live = [s for s in sorted(sch.running) if self.active[s]]
        if not live:
            return
        tr = self._tr
        t_tick = time.perf_counter()
        if tr is not None:
            tr.new_unit("tick")
        k = 1
        if self._spec_ok:
            k = max(1, min(min(sch.spec_len(s) for s in live), self._spec_cap_eff))
        # grow each live row's table to cover the window's writes; the
        # admission reservation sized this worst-case, so ensure cannot fail
        for s in live:
            self._account_pages(self.pool.ensure(sch.running[s].uid, int(self.lengths[s]) + k))
        rows = self._rows
        pt = np.zeros((rows, self.pool.row_pages), np.int32)
        tok = np.zeros((rows,), np.int32)
        lens = np.zeros((rows,), np.int32)
        keys = np.zeros((rows, 2), np.int64) if self._sampled else None
        for i, s in enumerate(live):
            pt[i] = self.pool.table_array(sch.running[s].uid)
            tok[i] = self.next_token[s]
            lens[i] = self.lengths[s]
            if keys is not None:
                # request-intrinsic base keys: a row's draws depend only on
                # (its seed, its positions), never its slot or neighbours
                keys[i] = self._request_key(sch.running[s]).numpy()
        # the reference's rows bucket (pow2 cover of the live rows): the
        # rows its demand program averages over
        bucket = 1 << max(0, len(live) - 1).bit_length()
        st = self._set_inputs(tok, lens, bucket, pt, keys)
        if tr is not None:
            # every physical page this window will read or write, for the
            # auditor's use-after-release replay (from the host tables)
            tr.instant("kv_use", "kv_pool", args={
                "pages": sorted({int(p) for row in pt[:len(live)] for p in row if p}),
                "rows": len(live)})
        if self.res_mgr is not None:
            self.stats.device_dispatches += 1     # the KV snapshot, the window's first op
            if tr is not None:
                tr.instant("kv_snapshot", "kv_pool", args={"rows": len(live)})
        if tr is not None:
            t_launch = time.perf_counter()
        out = self._window_launch(k)
        if tr is not None:
            tr.complete("launch", "launch", t_launch, time.perf_counter(),
                        args={"rows": len(live), "k": k})
        self.stats.device_dispatches += 1
        self.stats.windows += 1
        if k > 1:
            self.stats.spec_windows += 1
        self._pull_telemetry(out, k)
        if self.prefetch:
            # the window is in flight: ship the predicted boundary's uploads
            # into the shadow generation under it
            self.res_mgr.begin_prefetch(self.predictor)
        bufs = self._pull_buffers()
        if tr is not None:
            t_pull = time.perf_counter()
        bufs["draft"][:k].copy_(out["draft"])                # THE queue-draining pull
        if tr is not None:
            tr.complete("pull", "pull", t_pull, time.perf_counter(),
                        args={"rows": len(live), "k": k})
        self.stats.sync_pulls += 1
        draft_np = bufs["draft"][:k].numpy().copy()          # [K, rows]
        accepted = np.zeros((rows,), np.int32)
        accepted[:len(live)] = k
        tel = None
        if self.res_mgr is not None:
            tel = self._read_telemetry(k)
            step_row_miss = tel[2].any(axis=(1, 3))           # [K, rows]
            any_miss = step_row_miss.any(axis=0)
            first = np.where(any_miss, step_row_miss.argmax(axis=0), k)
            accepted[:len(live)] = np.maximum(first[:len(live)], 1)
            if tr is not None and bool(any_miss[:len(live)].any()):
                tr.instant("miss", "launch", args={"rows": int(any_miss[:len(live)].sum()),
                                                   "k": k})
        if self._sampled:
            # stochastic accept over the pulled distributions: self-drafting
            # passes the same array as draft and verifier (every position
            # accepts); it composes with the miss cap by per-row min
            probs = bufs["sample_probs"][:k].numpy()
            s_acc, resampled = stochastic_accept(draft_np, probs, probs, self._accept_rng)
            stoch = np.where(s_acc < k, s_acc + 1, k).astype(np.int32)
            rej = np.flatnonzero(s_acc < k)
            if rej.size:
                draft_np[s_acc[rej], rej] = resampled[rej]
            accepted[:len(live)] = np.minimum(accepted[:len(live)], stoch[:len(live)])
        # a finishing row commits only what it can still emit; ``offered`` =
        # drafts the row could have used (the accept-rate denominator)
        offered: Dict[int, int] = {}
        for i, s in enumerate(live):
            req = sch.running[s]
            budget = req.max_new - len(req.output)
            offered[s] = min(k, budget)
            accepted[i] = min(int(accepted[i]), budget)
        if self.res_mgr is not None and (accepted[:len(live)] < k).any():
            keep = torch.from_numpy(accepted.astype(np.int64)).to(self.device)
            tfm.rollback_kv_window(self.pool_state, out["saved"], st["inputs"][rows:2 * rows], k,
                                   keep, page_table=st["pt"])
            self.stats.device_dispatches += 1
            if tr is not None:
                tr.instant("kv_rollback", "kv_pool",
                           args={"accepted": [int(a) for a in accepted[:len(live)]]})
        now = time.perf_counter()
        fed_total = 0
        k_committed = 0
        for i, s in enumerate(live):
            a = int(accepted[i])
            self.lengths[s] += a
            k_committed = max(k_committed, a)
            req = sch.running[s]
            fed = 0
            for j in range(a):
                t = int(draft_np[j, i])
                self.next_token[s] = t
                sch.step_done(s, t, now, self.eos)
                fed += 1
                if tr is not None:
                    tr.instant("token", "request", lane=req.uid, args={"tok": t})
                if req.done:
                    self.active[s] = False
                    self._release_request(req)
                    break
            fed_total += fed
            sch.observe_accept(s, offered[s], fed)
            if k > 1:
                self.stats.drafted_tokens += offered[s]
                self.stats.accepted_tokens += fed
        self.stats.steps += k_committed
        self.stats.tokens += fed_total
        if tel is not None:
            self.res_mgr.rotate_window_from_telemetry(self.predictor, *tel, accepted=accepted)
        self.metrics.histogram("window_ms", "wall ms per serving window").observe(
            (time.perf_counter() - t_tick) * 1e3)

    # ------------------------------------------------------------------
    # the group tick (paged=False; recurrent stacks)
    # ------------------------------------------------------------------
    def _tick_single(self) -> None:
        """One single-step launch over the fixed contiguous batch (the
        reference's ``_tick_single``): every row steps, running or not (a
        free row's state is overwritten whole by the next splice); the host
        ``Sampler`` picks each row's token; rotation from the step's
        telemetry."""
        tr = self._tr
        t_tick = time.perf_counter()
        if tr is not None:
            tr.new_unit("tick")
        self._set_inputs(self.next_token, self.lengths, self._rows)
        if tr is not None:
            t_launch = time.perf_counter()
        out = self._launch(("step",), self._step_body)
        if tr is not None:
            tr.complete("launch", "launch", t_launch, time.perf_counter())
        self.stats.device_dispatches += 1
        self._pull_telemetry(out, None)
        bufs = self._pull_buffers()
        if tr is not None:
            t_pull = time.perf_counter()
        bufs["logits"].copy_(out["logits"])                  # THE queue-draining pull
        if tr is not None:
            tr.complete("pull", "pull", t_pull, time.perf_counter())
        self.stats.sync_pulls += 1
        logits_np = bufs["logits"].numpy().copy()
        self.lengths += self.active
        toks = self.sampler(logits_np)
        now = time.perf_counter()
        sch = self.scheduler
        for slot in list(sch.running):
            self.next_token[slot] = toks[slot]
            sch.step_done(slot, toks[slot], now, self.eos)
            if slot in sch.free_slots:
                self.active[slot] = False
            if self._spec_ok:
                # a plain tick is a size-1 window that accepted its token:
                # feedback that lets a fresh row's spec length grow
                sch.observe_accept(slot, 1, 1)
        self.stats.steps += 1
        self.stats.tokens += int(self.active.sum())
        if self.res_mgr is not None:
            self.res_mgr.rotate_from_telemetry(self.predictor, *self._read_telemetry(None))
        self.metrics.histogram("window_ms", "wall ms per serving window").observe(
            (time.perf_counter() - t_tick) * 1e3)

    def _tick_window(self, k: int) -> None:
        """One speculative group tick (the reference's ``_tick_window``):
        ``k`` self-drafted positions for the whole batch in one launch. A
        row commits up to its first missed position (at least 1, serving
        drops misses); rejected positions' KV slots roll back from the
        window's contiguous snapshot (per-row ``keep``) and re-draft next
        tick, after rotation."""
        tr = self._tr
        t_tick = time.perf_counter()
        if tr is not None:
            tr.new_unit("tick")
        st = self._set_inputs(self.next_token, self.lengths, self._rows)
        if self.res_mgr is not None:
            self.stats.device_dispatches += 1     # the KV snapshot, the window's first op
            if tr is not None:
                tr.instant("kv_snapshot", "kv_pool")
        if tr is not None:
            t_launch = time.perf_counter()
        out = self._window_launch(k)
        if tr is not None:
            tr.complete("launch", "launch", t_launch, time.perf_counter(), args={"k": k})
        self.stats.device_dispatches += 1
        self.stats.spec_windows += 1
        self._pull_telemetry(out, k)
        bufs = self._pull_buffers()
        if tr is not None:
            t_pull = time.perf_counter()
        bufs["draft"][:k].copy_(out["draft"])                # THE queue-draining pull
        if tr is not None:
            tr.complete("pull", "pull", t_pull, time.perf_counter(), args={"k": k})
        self.stats.sync_pulls += 1
        draft_np = bufs["draft"][:k].numpy().copy()          # [K, B]
        accepted = np.where(self.active, k, 0).astype(np.int32)
        tel = None
        if self.res_mgr is not None:
            tel = self._read_telemetry(k)
            step_row_miss = tel[2].any(axis=(1, 3))           # [K, B]
            any_miss = step_row_miss.any(axis=0)
            first = np.where(any_miss, step_row_miss.argmax(axis=0), k)
            accepted = np.where(self.active, np.maximum(first, 1), 0).astype(np.int32)
            if tr is not None and bool((any_miss & self.active).any()):
                tr.instant("miss", "launch", args={"rows": int((any_miss & self.active).sum()),
                                                   "k": k})
        sch = self.scheduler
        offered: Dict[int, int] = {}
        for slot, req in sch.running.items():
            if self.active[slot]:
                budget = req.max_new - len(req.output)
                offered[slot] = min(k, budget)
                accepted[slot] = min(int(accepted[slot]), budget)
        if self.res_mgr is not None and (accepted < k).any():
            keep = torch.from_numpy(accepted.astype(np.int64)).to(self.device)
            tfm.rollback_kv_window(self.state, out["saved"], st["inputs"][self._rows:2 * self._rows],
                                   k, keep)
            self.stats.device_dispatches += 1
            if tr is not None:
                tr.instant("kv_rollback", "kv_pool")
        self.lengths += accepted
        now = time.perf_counter()
        fed_total = 0
        for slot in list(sch.running):
            if not self.active[slot]:
                continue
            fed = 0
            for j in range(int(accepted[slot])):
                t = int(draft_np[j, slot])
                self.next_token[slot] = t
                sch.step_done(slot, t, now, self.eos)
                fed += 1
                if slot in sch.free_slots:
                    self.active[slot] = False
                    break
            fed_total += fed
            sch.observe_accept(slot, offered[slot], fed)
            self.stats.drafted_tokens += offered[slot]
            self.stats.accepted_tokens += fed
        self.stats.steps += int(accepted.max(initial=0))
        self.stats.tokens += fed_total
        if tel is not None:
            self.res_mgr.rotate_window_from_telemetry(self.predictor, *tel, accepted=accepted)
        self.metrics.histogram("window_ms", "wall ms per serving window").observe(
            (time.perf_counter() - t_tick) * 1e3)

    # ------------------------------------------------------------------
    def latency_summary(self) -> Dict[str, float]:
        """TTFT and inter-token latency percentiles over completed requests
        (wall clock, so meaningful when requests arrive at their real
        times), through the registry's ``ttft_ms`` / ``itl_ms`` histograms,
        rebuilt on every call."""
        done = self.scheduler.completed
        ttft = self.metrics.histogram("ttft_ms", "time to first token (ms)")
        itl = self.metrics.histogram("itl_ms", "inter-token latency (ms)")
        ttft.reset()
        itl.reset()
        for r in done:
            if r.first_token_at:
                ttft.observe(1e3 * (r.first_token_at - r.submitted_at))
            ts = r.token_times
            for a, b in zip(ts, ts[1:]):
                itl.observe(1e3 * (b - a))
        return {
            "completed": len(done),
            "ttft_p50_ms": round(ttft.percentile(50), 3),
            "ttft_p99_ms": round(ttft.percentile(99), 3),
            "itl_p50_ms": round(itl.percentile(50), 3),
            "itl_p99_ms": round(itl.percentile(99), 3),
        }

    def summary(self) -> Dict[str, float]:
        """Engine stats and request-latency percentiles in one dict."""
        out = self.stats.summary()
        out.update(self.latency_summary())
        return out

    def metrics_registry(self) -> MetricsRegistry:
        """The registry refreshed: latency histograms rebuilt and the
        ``EngineStats`` counters mirrored into ``engine_*`` gauges."""
        self.latency_summary()
        self.metrics.set_from(self.stats.summary())
        return self.metrics
