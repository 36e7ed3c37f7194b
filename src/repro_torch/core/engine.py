"""RotaryEngine on the card: the paper's decode path with rotary expert
residency.

The counterpart of ``repro/core/engine.py`` for its main path: greedy
decode at ``spec_k=1`` with the legacy prefill walk, synchronous or with
predictive prefetch and the miss relaunch (``prefetch=True``). The full
model weights live in host memory (pinned); only attention / router /
embedding weights, the KV caches and each MoE layer's slot group are
device-resident.

* **Prefill** walks the layers once over the whole prompt (the reference's
  ``_run_layers``): attention (flash-attention kernel), router + top-k gate
  kernel, one sync to pull the routing, LUT resolve on the host, the routed
  experts through the slot stores (grouped-matmul kernel), host correction
  of misses, and pre-gating of the next MoE layer from this layer's hidden.
  It writes the engine's own KV caches in place (allocated once, at start).
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

Greedy tokens do not depend on residency: a miss is corrected exactly on
the host (or relaunched miss-free), so full and rotary residency, with or
without prefetch, emit the same tokens.

Quantized stores (``ResidencyConfig.quantization`` int8 / int4): the
warehouse is quantized once, at start, into packed planes in pinned memory
(on the card, one layer at a time), and the float warehouse is not kept.
Uploads ship packed rows, the grouped-matmul kernel reads them straight from
the slots, and a miss dequantizes only its expert from the packed warehouse
with the plain version's arithmetic, so it adds what a resident slot would
have computed and full and rotary residency still emit the same tokens.

Not ported yet: speculative windows (``spec_k > 1``), chunked prefill, the
per-layer hot walk and the host-routing baseline, LRU (its mid-step loads
need the per-layer sync walk) and sampled decode.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ResidencyConfig
from repro_torch.core.predictor import DemandPredictor
from repro_torch.core.residency import RotaryResidencyManager
from repro_torch.core.stats import EngineStats
from repro_torch.core.transfer import CostModel, TransferClock
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params
from repro_torch.models.transformer import Runtime
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import resolve_tracer
from repro_torch.quant import dequantize_int4


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
        prefetch: bool = False,
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
        the synchronous rotation path, the exactness baseline."""
        if prefetch and rescfg.mode == "lru":
            raise ValueError(
                "prefetch=True requires the fused whole-stack hot path (no LRU): "
                "LRU's reactive loads need the per-layer sync walk, so there is "
                "nothing to overlap")
        if rescfg.mode not in ("full", "rotary", "static"):
            raise NotImplementedError(
                f"residency mode {rescfg.mode!r} needs the per-layer sync walk, not ported yet"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rescfg = rescfg
        self.rt = rt or Runtime(cache_len=1024)
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
        self.layers: List[Params] = []
        experts: List[Dict[str, torch.Tensor]] = []
        routers: List[np.ndarray] = []
        for p_l in params["layers"]:
            hw = dict(p_l["moe"]["experts"])
            if rescfg.quantization is None:         # else the manager packs them
                for n, w in hw.items():
                    if w.device != host or (pin and not w.is_pinned()):
                        hw[n] = torch.empty(w.shape, dtype=w.dtype, pin_memory=pin).copy_(w)
            experts.append(hw)
            routers.append(p_l["moe"]["router"].float().cpu().numpy())
            moe_p = {k: v for k, v in p_l["moe"].items() if k != "experts"}
            self.layers.append(_to_device({**p_l, "moe": moe_p}, dev))
        self.num_moe_layers = len(self.layers)
        self.embed_params = _to_device(
            {k: params[k] for k in ("embed", "final_norm", "lm_head") if k in params}, dev
        )
        self._dparams = {**self.embed_params, "layers": self.layers}

        self.predictor = DemandPredictor(routers, ema=rescfg.predictor_ema)
        self.manager = RotaryResidencyManager(
            cfg, rescfg, experts,
            batch=batch, cache_len=self.rt.cache_len, device=dev,
            cost=self.cost, stats=self.stats, seed=seed,
            tracer=self._tr, metrics=self.metrics,
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
        # stacked next-layer routers [L, D, E] for the on-device demand GEMM
        self._routers_next = torch.as_tensor(self.predictor.next_layer_routers()).to(dev)
        n_l, k = self.num_moe_layers, cfg.moe.top_k
        self._pull = {                       # pinned host buffers for telemetry
            "ids": torch.empty((n_l, batch, k), dtype=torch.int32, pin_memory=pin),
            "weights": torch.empty((n_l, batch, k), dtype=torch.float32, pin_memory=pin),
            "miss": torch.empty((n_l, batch, k), dtype=torch.bool, pin_memory=pin),
            "demand_next": torch.empty((n_l, cfg.moe.num_experts), dtype=torch.float32,
                                       pin_memory=pin),
        }
        self._cost_cache: Dict[str, Tuple[float, float]] = {}
        self._f32_scratch: Dict[str, torch.Tensor] = {}      # host miss GEMM
        # the KV caches, allocated once: prefill rewrites them in place, so a
        # captured step's addresses hold across requests
        self.state = tfm.zero_state(cfg, batch, self.rt.cache_len, dev)
        self.cur_len = 0
        # the step's inputs: [tokens (B), cur_len] in one static device buffer,
        # filled from a pinned host buffer before each launch
        self._inputs_host = torch.empty((batch + 1,), dtype=torch.int64, pin_memory=pin)
        self._inputs = torch.zeros((batch + 1,), dtype=torch.int64, device=dev)
        self._residency: List[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = []
        # the captured step (card only): graph, its outputs, the addresses it
        # reads and the kernel launches one replay makes
        self._capture = dev.type == "cuda"       # False: eager on the card (parity tests)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_out: Dict[str, torch.Tensor] = {}
        self._graph_ptrs: Tuple[int, ...] = ()
        self._graph_launches: Dict[str, Dict[str, int]] = {}
        self.graph_captures = 0
        self.graph_replays = 0
        self._warm_start()

    # ------------------------------------------------------------------
    def _warm_start(self) -> None:
        """Initial residency: rotate every layer once on the uniform prior."""
        for li in range(self.num_moe_layers):
            self.manager.prepare_layer(li, self.predictor.smoothed[li])

    def _embed(self, tokens: np.ndarray) -> torch.Tensor:
        self.stats.device_dispatches += 1
        return tfm.embed_tokens(self.embed_params,
                                torch.as_tensor(tokens).to(self.device))

    def _lm_head(self, h: torch.Tensor) -> torch.Tensor:
        self.stats.device_dispatches += 1
        return tfm.lm_logits(self.cfg, self.embed_params, h)

    # ------------------------------------------------------------------
    def _host_correct(self, x: torch.Tensor, moe_li: int, h2: torch.Tensor,
                      ids: np.ndarray, weights: np.ndarray,
                      miss: np.ndarray) -> torch.Tensor:
        """Exact host GEMM correction for missed experts."""
        h2_host = h2.detach().cpu().float().reshape(ids.shape[0], -1)
        corr = torch.zeros_like(h2_host)
        hw = self.host_experts[moe_li]
        picks = list(zip(*np.nonzero(miss)))
        # one host GEMM per missed expert over all its rows (each expert's
        # weights leave the warehouse's type once), summed in pick order
        by_expert: Dict[int, List[Tuple[int, int]]] = {}
        for t_i, j in picks:
            by_expert.setdefault(int(ids[t_i, j]), []).append((t_i, j))
        outs: Dict[Tuple[int, int], torch.Tensor] = {}
        for e, tj in by_expert.items():
            y, convert_s = _host_ffn(hw, e, h2_host[[t_i for t_i, _ in tj]], self._f32_scratch)
            self.stats.host_dequant_s += convert_s
            self.stats.host_dequant_experts += 1
            outs.update(zip(tj, y))
        for t_i, j in picks:
            corr[t_i] += float(weights[t_i, j]) * outs[(t_i, j)]
        n_host = len(picks)
        x = x + corr.to(device=x.device, dtype=x.dtype).reshape(x.shape)
        self.stats.layer(moe_li).host_computed += n_host
        self.clock.host(self.cost.host_compute_s(self.manager.host_expert_flops(n_host)))
        return x

    def _moe_layer(self, li: int, x_mid: torch.Tensor, h2: torch.Tensor,
                   ids_dev: torch.Tensor, w_dev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        slots, lut = self.manager.layer_residency(li)
        y2, miss = moe_mod.moe_apply_routed(self.layers[li]["moe"], h2, ids_dev, w_dev,
                                            slot_buffer=slots, lut=lut)
        return x_mid + y2.reshape(x_mid.shape), miss

    # ------------------------------------------------------------------
    # per-layer sync walk (prefill)
    # ------------------------------------------------------------------
    def _run_layers(self, x: torch.Tensor) -> torch.Tensor:
        cfg, clock = self.cfg, self.clock
        for li, p_l in enumerate(self.layers):
            x_mid, h2, _ = tfm.attn_half(
                cfg, p_l, x, "prefill", self.state[li], 0, self.rt.cache_len)
            ids_dev, w_dev = moe_mod.route(p_l["moe"], h2, cfg.moe)
            self.stats.sync_pulls += 1
            self.stats.device_dispatches += 1
            ids = ids_dev.cpu().numpy()
            weights = w_dev.cpu().numpy()
            _, miss = self.manager.resolve(li, ids, clock)
            x, _ = self._moe_layer(li, x_mid, h2, ids_dev, w_dev)
            self.stats.device_dispatches += 1
            if miss.any() and self.rescfg.host_compute_misses:
                x = self._host_correct(x, li, h2, ids, weights, miss)
            flops, byts = self._layer_cost("attn_moe", x.shape, 0, hits=int((~miss).sum()))
            clock.compute(self.cost.compute_s(flops, byts))
            # pre-gate the NEXT MoE layer from THIS hidden (cyclic)
            nxt = (li + 1) % self.num_moe_layers
            h2_np = h2.float().cpu().numpy().reshape(ids.shape[0], -1)
            demand = self.predictor.predict(nxt, h2_np)
            self.manager.prepare_layer(nxt, demand, clock)
            self.predictor.observe(li, ids, weights)
        return x

    # ------------------------------------------------------------------
    # fused decode (one step over every layer per token)
    # ------------------------------------------------------------------
    def _step_body(self) -> Dict[str, torch.Tensor]:
        """The decode step on the device, from the static inputs and the
        residency of ``_residency``: logits and the telemetry (the
        counterpart of ``build_fused_decode_step`` with ``_demand_aux_fn``:
        the demand GEMM runs in the step, ``route_h`` stays on the device)."""
        tok = self._inputs[:self.batch]
        cur = self._inputs[self.batch]
        logits, aux = tfm.decode_model(self.cfg, self._dparams, tok, self.state, cur,
                                       self._residency)
        dl = torch.einsum("ltd,lde->lte", aux["route_h"].float(), self._routers_next)
        return {"logits": logits, "ids": aux["route_ids"], "weights": aux["route_weights"],
                "miss": aux["route_miss"],
                "demand_next": torch.softmax(dl, dim=-1).mean(dim=1),       # [L, E]
                "route_x": aux["route_x"]}

    def _set_inputs(self, tok: np.ndarray, cur_len: int) -> None:
        host = self._inputs_host
        host[:self.batch] = torch.from_numpy(np.asarray(tok, np.int64))
        host[self.batch] = cur_len
        self._inputs.copy_(host, non_blocking=True)

    def _graph_inputs(self) -> Tuple[int, ...]:
        """Addresses of everything a replay reads besides the weights: the
        static inputs, every plane and device LUT, every cache."""
        ptrs = [self._inputs.data_ptr()]
        for planes, lut in self._residency:
            ptrs += [t.data_ptr() for t in planes.values()] + [lut.data_ptr()]
        for cache in self.state:
            ptrs += [cache["k"].data_ptr(), cache["v"].data_ptr()]
        return tuple(ptrs)

    def _launch_step(self) -> Dict[str, torch.Tensor]:
        """Run the step once at the inputs set: a replay of the captured
        graph on the card (captured on first use), eager on the CPU."""
        self._residency = self.manager.residency()     # device LUTs rewritten in place
        if not self._capture:
            return self._step_body()
        if self._graph is None:
            return self._capture_step()
        if self._graph_inputs() != self._graph_ptrs:
            raise RuntimeError("decode graph: a plane, LUT, cache or input it reads has moved "
                               "since the capture")
        self._graph.replay()
        ops.add_launches(self._graph_launches)
        self.graph_replays += 1
        return self._graph_out

    def _capture_step(self) -> Dict[str, torch.Tensor]:
        """Capture the step as a CUDA graph. Its warm-up, eager on the compute
        stream (the kernels' first launches set their attributes there), IS
        this step, whose outputs are returned; the capture launches nothing.
        A capture that fails raises (the step has no eager fall back)."""
        out = self._step_body()
        before = ops.symbol_launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graph_out = self._step_body()
        self._graph_launches = ops.launches_since(before)
        ops.add_launches(self._graph_launches, -1)     # recorded, not launched
        self._graph, self._graph_out = graph, graph_out
        self._graph_ptrs = self._graph_inputs()
        self.graph_captures += 1
        return out

    def _queue_telemetry(self, out: Dict[str, torch.Tensor]) -> None:
        """Non-blocking copies of the step's telemetry into the pinned
        buffers, queued on the compute stream after the step: they have
        landed once the logits pull that follows returns."""
        for name, buf in self._pull.items():
            buf.copy_(out[name], non_blocking=True)

    def _read_telemetry(self) -> Tuple[np.ndarray, ...]:
        """(ids, weights, miss [L, T, k], demand_next [L, E]) from the pinned buffers."""
        pull = self._pull
        return tuple(pull[n].numpy().copy() for n in ("ids", "weights", "miss", "demand_next"))

    def _decode_step_fused(self, tok: np.ndarray) -> np.ndarray:
        """One decode step. Returns host logits [B, V] (f32)."""
        cur_len = self.cur_len
        tr = self._tr
        if tr is not None:
            tr.new_unit("decode")
            t_trace = time.perf_counter()
        self._set_inputs(tok, cur_len)
        out = self._launch_step()
        self.stats.device_dispatches += 1
        if tr is not None:
            tr.complete("launch", "launch", t_trace, time.perf_counter(),
                        args={"cur_len": cur_len})
        self._queue_telemetry(out)
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
                             stop_li: int, cur_len: int, start_li: int = 0) -> None:
        """record_routing + modeled clock for layers ``[start_li, stop_li)``
        of one authoritative step (ids/miss [L, T, k]): the step's prefix, or
        a relaunch's suffix."""
        xshape = (self.batch, 1, self.cfg.d_model)
        for li in range(start_li, stop_li):
            self.manager.record_routing(li, ids[li], miss[li])
            flops, byts = self._layer_cost("attn_moe", xshape, cur_len,
                                           hits=int((~miss[li]).sum()))
            self.clock.compute(self.cost.compute_s(flops, byts))

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
            out = self._launch_step()
            self.stats.device_dispatches += 1
            self.stats.relaunched_steps += 1
            if tr is not None:
                tr.complete("launch", "launch", t_trace, time.perf_counter(),
                            args={"kind": "relaunch"})
            self._queue_telemetry(out)
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

    def _replay_fused(self, anchor: torch.Tensor, start: int, cur_len: int) -> np.ndarray:
        """Exact re-execution of a fused-step SUFFIX after an observed miss:
        layers before ``start`` stand; from ``start`` on, the per-layer walk
        re-runs from the step's saved block input ``anchor`` (``route_x`` of
        layer ``start``) against the SAME residency (rotation runs after
        this), host-correcting every miss."""
        tr = self._tr
        t_trace = time.perf_counter() if tr is not None else 0.0
        cfg, clock = self.cfg, self.clock
        x = anchor.reshape(self.batch, 1, -1)
        cur = self._inputs[self.batch]
        self.stats.device_dispatches += 1             # device-side slice
        for li in range(start, self.num_moe_layers):
            p_l = self.layers[li]
            x_mid, h2, _ = tfm.attn_half(cfg, p_l, x, "decode", self.state[li], cur, 0)
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
                        args={"start_li": start, "step": None})
        return logits

    def _layer_cost(self, kind: str, xshape, cur_len: int, hits: int) -> Tuple[float, float]:
        """(flops, bytes) estimate of one layer at current shapes (modeled clock)."""
        cfg = self.cfg
        cached = self._cost_cache.get(kind)
        if cached is None:
            from repro_torch.models.params import _block_params

            n_static = float(_block_params(cfg, active_only=True))
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
    # public API
    # ------------------------------------------------------------------
    def prefill(self, tokens: np.ndarray) -> np.ndarray:
        """tokens [B, S] -> logits [B, V] (f32); builds the decode state."""
        b, s = tokens.shape
        assert b == self.batch
        if s > self.rt.cache_len and self.cfg.attention.window is None:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len {self.rt.cache_len}")
        t0 = time.perf_counter()
        x = self._embed(tokens)
        x = self._run_layers(x)
        logits = self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()
        self.stats.wall_s += time.perf_counter() - t0
        self.cur_len = s
        self.stats.tokens += b * s
        return logits

    def decode(self, last_logits: np.ndarray, steps: int) -> np.ndarray:
        """Generate ``steps`` greedy tokens. Returns [B, steps] int32. A
        windowed (ring) cache decodes past ``cache_len``; a window-free one
        refuses to."""
        if (self.cur_len + steps > self.rt.cache_len
                and self.cfg.attention.window is None):
            raise ValueError(f"{self.cur_len} + {steps} positions exceed cache_len "
                             f"{self.rt.cache_len}")
        out = np.zeros((self.batch, steps), np.int32)
        logits = last_logits
        t0 = time.perf_counter()
        for i in range(steps):
            tok = np.argmax(logits, axis=-1).astype(np.int32)
            out[:, i] = tok
            t_win = time.perf_counter()
            logits = self._decode_step_fused(tok)
            self.cur_len += 1
            self.stats.steps += 1
            self.stats.tokens += self.batch
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

    def generate(self, prompt: np.ndarray, max_new: int) -> np.ndarray:
        logits = self.prefill(prompt)
        return self.decode(logits, max_new)


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
