"""RotaryEngine on the card: the paper's decode path with rotary expert
residency.

The counterpart of ``repro/core/engine.py`` for its main path: greedy
decode at ``spec_k=1`` with the legacy prefill walk. The full model weights
live in host memory (pinned); only attention / router / embedding weights and
each MoE layer's slot group are device-resident.

* **Prefill** walks the layers once over the whole prompt (the reference's
  ``_run_layers``): attention (flash-attention kernel), router + top-k gate
  kernel, one sync to pull the routing, LUT resolve on the host, the routed
  experts through the slot stores (grouped-matmul kernel), host correction
  of misses, and pre-gating of the next MoE layer from this layer's hidden.
* **Decode** runs ONE fused step per token over every layer
  (``tfm.decode_model``: decode-attention kernel, gate kernel, grouped-matmul
  kernel per layer) plus the on-device demand GEMM for the next step's
  rotation. The routing telemetry goes to pinned host buffers with
  non-blocking copies queued before the logits pull, which is the one
  blocking read of a miss-free token (``stats.sync_pulls``).
* **Exactness under misses** is the reference's suffix REPLAY: when the
  step's miss masks show a routed expert was not resident, the layers from
  the first missed one re-run per layer from the step's saved block input
  (``route_x``) against the same residency, host-correcting each miss
  (``_host_correct``). Re-running attention rewrites the same KV slot in
  place, so the post-step cache is a valid replay substrate.
* **Rotation** runs strictly after the step and its replay
  (``rotate_from_telemetry``): the uploads go on the same stream as the
  compute, so a slot is never overwritten while a queued step still reads
  it.

Greedy tokens do not depend on residency: a miss is corrected exactly on
the host, so full and rotary residency emit the same tokens.

Not ported yet: speculative windows (``spec_k > 1``), chunked prefill,
predictive prefetch and the miss relaunch, the per-layer hot walk and the
host-routing baseline, LRU's mid-step loads on the fused path, sampled
decode, and quantized stores.
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
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params
from repro_torch.models.transformer import Runtime
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import resolve_tracer


def _host_ffn(hw: Dict[str, torch.Tensor], e: int, x: torch.Tensor,
              scratch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Host expert GEMM in f32 (the paper's CPU-resident expert execution):
    x [n, D] f32 on the host -> [n, D]. The reference's ``_np_ffn`` in torch
    CPU ops, so the host path runs on one thread pool; only the missed
    expert's weights leave the warehouse's type, converted into ``scratch``
    (one f32 buffer per weight tensor, reused across calls)."""

    def w(name: str) -> torch.Tensor:
        buf = scratch.get(name)
        if buf is None:
            buf = scratch[name] = torch.empty(hw[name].shape[1:], dtype=torch.float32)
        return buf.copy_(hw[name][e])

    if "w_gate" in hw:
        g = x @ w("w_gate")
        h = (g / (1.0 + torch.exp(-g))) * (x @ w("w_up"))
    else:
        u = x @ w("w_up")
        h = 0.5 * u * (1.0 + torch.tanh(math.sqrt(2 / math.pi) * (u + 0.044715 * u**3)))
    return h @ w("w_down")


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
        trace=None,
        device="cuda",
    ):
        """``params`` as ``tfm.init_params`` or ``bridge.from_reference``
        build them. Attention, router and embedding weights move to
        ``device``; the routed experts stay in (or move to) host memory, the
        warehouse. ``cost`` defaults to a link figure measured on the card at
        start, or to an unmeasured model on the CPU."""
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
        self.host_experts: List[Dict[str, torch.Tensor]] = []
        routers: List[np.ndarray] = []
        for p_l in params["layers"]:
            hw = {}
            for n, w in p_l["moe"]["experts"].items():
                if w.device == host and (not pin or w.is_pinned()):
                    hw[n] = w
                else:
                    hw[n] = torch.empty(w.shape, dtype=w.dtype, pin_memory=pin).copy_(w)
            self.host_experts.append(hw)
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
            cfg, rescfg, self.host_experts,
            batch=batch, cache_len=self.rt.cache_len, device=dev,
            cost=self.cost, stats=self.stats, seed=seed,
            tracer=self._tr, metrics=self.metrics,
        )
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
        self.state: Optional[List[Dict[str, torch.Tensor]]] = None
        self.cur_len = 0
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
    def _correction_weights(self, moe_li: int) -> Dict[str, torch.Tensor]:
        """Host weights the miss correction GEMMs against: the warehouse
        itself (unquantized stores)."""
        return self.host_experts[moe_li]

    def _host_correct(self, x: torch.Tensor, moe_li: int, h2: torch.Tensor,
                      ids: np.ndarray, weights: np.ndarray,
                      miss: np.ndarray) -> torch.Tensor:
        """Exact host GEMM correction for missed experts."""
        h2_host = h2.detach().cpu().float().reshape(ids.shape[0], -1)
        corr = torch.zeros_like(h2_host)
        hw = self._correction_weights(moe_li)
        picks = list(zip(*np.nonzero(miss)))
        # one host GEMM per missed expert over all its rows (each expert's
        # weights leave the warehouse's type once), summed in pick order
        by_expert: Dict[int, List[Tuple[int, int]]] = {}
        for t_i, j in picks:
            by_expert.setdefault(int(ids[t_i, j]), []).append((t_i, j))
        outs: Dict[Tuple[int, int], torch.Tensor] = {}
        for e, tj in by_expert.items():
            y = _host_ffn(hw, e, h2_host[[t_i for t_i, _ in tj]], self._f32_scratch)
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
            x_mid, h2, self.state[li] = tfm.attn_half(
                cfg, p_l, x, "prefill", None, 0, self.rt.cache_len)
            ids_dev, w_dev = moe_mod.topk_route(moe_mod.router_logits(p_l["moe"], h2), cfg.moe)
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
    def _decode_step_fused(self, tok: np.ndarray) -> np.ndarray:
        """One decode step. Returns host logits [B, V] (f32)."""
        cur_len = self.cur_len
        tr = self._tr
        if tr is not None:
            tr.new_unit("decode")
            t_trace = time.perf_counter()
        residency = self.manager.residency()
        logits_dev, aux = tfm.decode_model(
            self.cfg, self._dparams, torch.as_tensor(tok).to(self.device),
            self.state, cur_len, residency,
        )
        dl = torch.einsum("ltd,lde->lte", aux["route_h"].float(), self._routers_next)
        demand_dev = torch.softmax(dl, dim=-1).mean(dim=1)           # [L, E]
        self.stats.device_dispatches += 1
        if tr is not None:
            tr.complete("launch", "launch", t_trace, time.perf_counter(),
                        args={"cur_len": cur_len})
        # non-blocking copies into pinned buffers, queued before the logits
        # pull: they have landed once the pull below returns
        pull = self._pull
        pull["ids"].copy_(aux["route_ids"], non_blocking=True)
        pull["weights"].copy_(aux["route_weights"], non_blocking=True)
        pull["miss"].copy_(aux["route_miss"], non_blocking=True)
        pull["demand_next"].copy_(demand_dev, non_blocking=True)
        self.stats.overlapped_pulls += len(pull)
        if tr is not None:
            t_trace = time.perf_counter()
        logits = logits_dev.float().cpu().numpy()          # THE one blocking pull
        self.stats.sync_pulls += 1
        if tr is not None:
            tr.complete("pull", "pull", t_trace, time.perf_counter(),
                        args={"cur_len": cur_len})
        ids = pull["ids"].numpy().copy()                    # [L, T, k]
        weights = pull["weights"].numpy().copy()
        miss = pull["miss"].numpy().copy()
        demand_next = pull["demand_next"].numpy().copy()   # [L, E]
        missed = np.flatnonzero(miss.reshape(miss.shape[0], -1).any(axis=1))
        if tr is not None and missed.size:
            tr.instant("miss", "launch",
                       args={"first_moe": int(missed[0]), "layers": int(missed.size)})
        start = (int(missed[0]) if (missed.size and self.rescfg.host_compute_misses)
                 else self.num_moe_layers)
        self._account_step_prefix(ids, miss, start, cur_len)
        if start < self.num_moe_layers:
            logits = self._replay_fused(aux, start, cur_len)
        # between-step rotation, strictly after the step and its replay
        self.manager.rotate_from_telemetry(
            self.predictor, ids, weights, miss, demand_next,
            clock=self.clock, record=False,
        )
        return logits

    def _account_step_prefix(self, ids: np.ndarray, miss: np.ndarray,
                             stop_li: int, cur_len: int) -> None:
        """record_routing + modeled clock for layers ``[0, stop_li)`` of one
        authoritative step (ids/miss [L, T, k])."""
        xshape = (self.batch, 1, self.cfg.d_model)
        for li in range(stop_li):
            self.manager.record_routing(li, ids[li], miss[li])
            flops, byts = self._layer_cost("attn_moe", xshape, cur_len,
                                           hits=int((~miss[li]).sum()))
            self.clock.compute(self.cost.compute_s(flops, byts))

    def _replay_fused(self, aux: Dict[str, torch.Tensor], start: int,
                      cur_len: int) -> np.ndarray:
        """Exact re-execution of a fused-step SUFFIX after an observed miss:
        layers before ``start`` stand; from ``start`` on, the per-layer walk
        re-runs from the step's saved block input against the SAME residency
        (rotation runs after this), host-correcting every miss."""
        tr = self._tr
        t_trace = time.perf_counter() if tr is not None else 0.0
        cfg, clock = self.cfg, self.clock
        x = aux["route_x"][start].reshape(self.batch, 1, -1)
        self.stats.device_dispatches += 1             # device-side slice
        for li in range(start, self.num_moe_layers):
            p_l = self.layers[li]
            x_mid, h2, _ = tfm.attn_half(cfg, p_l, x, "decode", self.state[li], cur_len, 0)
            ids_dev, w_dev = moe_mod.topk_route(moe_mod.router_logits(p_l["moe"], h2), cfg.moe)
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
        if s > self.rt.cache_len:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len {self.rt.cache_len}")
        t0 = time.perf_counter()
        self.state = [None] * self.num_moe_layers
        x = self._embed(tokens)
        x = self._run_layers(x)
        logits = self._lm_head(x[:, -1:])[:, 0].float().cpu().numpy()
        self.stats.wall_s += time.perf_counter() - t0
        self.cur_len = s
        self.stats.tokens += b * s
        return logits

    def decode(self, last_logits: np.ndarray, steps: int) -> np.ndarray:
        """Generate ``steps`` greedy tokens. Returns [B, steps] int32."""
        if self.cur_len + steps > self.rt.cache_len:
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
