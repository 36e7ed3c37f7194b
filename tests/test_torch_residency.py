"""The port's host-side residency modules against the JAX package's.

``core/{lut,rotation,policies,predictor,stats}.py`` are copies of the
reference's numpy modules: fed identical demand they must give identical
transition and LUT sequences. The manager's feasibility check prices the
same bytes, and its rotation from identical telemetry lands the same experts
in the same slots. Everything here is exact (integers and identical numpy
arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ResidencyConfig as JRes
from repro.config import get_config
from repro.configs import reduce_for_smoke
from repro.core.policies import make_policy as jmake_policy
from repro.core.predictor import DemandPredictor as JPredictor
from repro.core.predictor import host_topk_route as jhost_topk
from repro.core.residency import RotaryResidencyManager as JManager
from repro.core.residency import check_feasibility as jcheck
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.config import get_config as tget
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.policies import make_policy as tmake_policy
from repro_torch.core.predictor import DemandPredictor as TPredictor
from repro_torch.core.predictor import host_topk_route as thost_topk
from repro_torch.core.residency import InitializationError
from repro_torch.core.residency import RotaryResidencyManager as TManager
from repro_torch.core.residency import check_feasibility as tcheck
from repro_torch.core.slots import SlotStore


def _demands(n, e, seed):
    rng = np.random.default_rng(seed)
    d = rng.dirichlet(np.full(e, 0.3), size=n)
    d[n // 2] = d[1]                  # a recurring context: the ring's cyclical return
    return d


@pytest.mark.parametrize("mode,slots", [("rotary", 20), ("rotary", 9), ("static", 12), ("lru", 10)])
def test_policies_give_identical_transitions(mode, slots):
    e = 32
    jres = JRes(mode=mode, num_slots=slots)
    tres = TRes(mode=mode, num_slots=slots)
    jp, tp = jmake_policy(mode, e, slots, jres, seed=3), tmake_policy(mode, e, slots, tres, seed=3)
    for step, d in enumerate(_demands(12, e, 0)):
        assert jp.prepare(d) == tp.prepare(d), step
        ids = np.random.default_rng(step).integers(0, e, 6)
        jp.touch(ids)
        tp.touch(ids)
        assert jp.on_miss(int(ids[0])) == tp.on_miss(int(ids[0]))
        np.testing.assert_array_equal(jp.lut.e2s, tp.lut.e2s)
        np.testing.assert_array_equal(jp.lut.s2e, tp.lut.s2e)


def test_predictor_and_host_router_identical():
    rng = np.random.default_rng(1)
    routers = [rng.standard_normal((16, 24)).astype(np.float32) for _ in range(3)]
    jp, tp = JPredictor(routers, ema=0.7), TPredictor(routers, ema=0.7)
    for step in range(5):
        h = rng.standard_normal((2, 16)).astype(np.float32)
        for l in range(3):
            np.testing.assert_array_equal(jp.predict(l, h), tp.predict(l, h))
            ids = rng.integers(0, 24, (2, 4))
            w = rng.random((2, 4))
            jp.observe(l, ids, w)
            tp.observe(l, ids, w)
    np.testing.assert_array_equal(jp.next_layer_routers(), tp.next_layer_routers())
    logits = rng.standard_normal((5, 24)).astype(np.float32)
    logits[:, 3] = logits[:, 7] = 3.0
    for a, b in zip(jhost_topk(logits, 4), thost_topk(logits, 4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["qwen36-35b-a3b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("slots", [0, 64, 8])
def test_feasibility_prices_the_same_bytes(arch, slots):
    res = dict(mode="rotary", num_slots=slots, hbm_budget_bytes=40 << 30)
    j = jcheck(get_config(arch), JRes(**res), batch=1, cache_len=1024)
    t = tcheck(tget(arch), TRes(**res), batch=1, cache_len=1024)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("arch", ["qwen36-35b-a3b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("quantization,group", [("int8", 64), ("int4", 64), ("int4", 16)])
def test_feasibility_prices_quantized_bytes_the_same(arch, quantization, group):
    res = dict(mode="rotary", num_slots=64, hbm_budget_bytes=40 << 30,
               quantization=quantization, quant_group_size=group)
    j = jcheck(get_config(arch), JRes(**res), batch=1, cache_len=1024)
    t = tcheck(tget(arch), TRes(**res), batch=1, cache_len=1024)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    bf16 = tcheck(tget(arch), TRes(mode="rotary", num_slots=64), batch=1, cache_len=1024)
    assert t.slot_bytes < bf16.slot_bytes


def _host_experts(cfg, rng, layers=2):
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    return [{"w_gate": rng.standard_normal((e, d, f)).astype(np.float32),
             "w_up": rng.standard_normal((e, d, f)).astype(np.float32),
             "w_down": rng.standard_normal((e, f, d)).astype(np.float32)} for _ in range(layers)]


@pytest.mark.parametrize("quantization,group", [("int8", 64), ("int4", 64), ("int4", 16)])
def test_quantized_manager_planes_match_reference(quantization, group):
    """Identical warm start and telemetry under int8/int4: the port's
    manager packs its warehouse once and uploads packed rows; its planes
    equal the reference stores' ``raw_pytree`` byte for byte, with the same
    bytes uploaded."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
    tcfg = dataclasses.replace(treduce(tget("qwen36-35b-a3b")), dtype="float32")
    rng = np.random.default_rng(5)
    host = _host_experts(cfg, rng)
    e = cfg.moe.num_experts
    kw = dict(mode="rotary", num_slots=4, prefetch_margin=1, quantization=quantization,
              quant_group_size=group)
    jm = JManager(cfg, JRes(**kw), host, batch=1, cache_len=32)
    tm = TManager(tcfg, TRes(**kw), [{n: torch.from_numpy(w) for n, w in hw.items()}
                                     for hw in host], batch=1, cache_len=32, device="cpu")
    routers = [rng.standard_normal((cfg.d_model, e)).astype(np.float32) for _ in range(2)]
    jp, tp = JPredictor(routers), TPredictor(routers)
    for l in range(2):
        jm.prepare_layer(l, jp.smoothed[l])
        tm.prepare_layer(l, tp.smoothed[l])
    for step in range(5):
        ids = rng.integers(0, e, (2, 1, 2))
        w = rng.random((2, 1, 2)).astype(np.float32)
        miss = rng.random((2, 1, 2)) < 0.3
        demand = rng.dirichlet(np.ones(e), size=2)
        jm.rotate_from_telemetry(jp, ids, w, miss, demand)
        tm.rotate_from_telemetry(tp, ids, w, miss, demand)
    assert jm.stats.bytes_uploaded == tm.stats.bytes_uploaded > 0
    for l in range(2):
        np.testing.assert_array_equal(jm.policies[l].lut.e2s, tm.policies[l].lut.e2s)
        want = jm.stores[l].raw_pytree()
        got = tm.stores[l].raw_dict()
        assert set(got) == set(want)
        for name, plane in got.items():
            ref = np.asarray(want[name])
            assert plane.numpy().dtype == ref.dtype and plane.numpy().tobytes() == ref.tobytes()
        assert set(tm.host_experts[l]) == set(got)          # only the packed warehouse is kept


def test_manager_rotation_matches_reference_from_identical_telemetry():
    """Identical warm start and per-step telemetry: the same LUTs, the same
    bytes uploaded, and the port's device slots hold exactly the experts the
    LUT names (the MISS slot stays zero). Then again under predictive
    prefetch: the same ``begin_prefetch`` plans, the same commit outcomes
    (prefetch hits, wasted bytes, loads), the same contents of both
    generations, and the port's folded planes equal the reference's live and
    shadow buffers byte for byte."""
    for prefetch in (False, True):
        _rotation_against_reference(prefetch)


def _rotation_against_reference(prefetch):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
    tcfg = dataclasses.replace(treduce(tget("qwen36-35b-a3b")), dtype="float32")
    rng = np.random.default_rng(2)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    host = [{"w_gate": rng.standard_normal((e, d, f)).astype(np.float32),
             "w_up": rng.standard_normal((e, d, f)).astype(np.float32),
             "w_down": rng.standard_normal((e, f, d)).astype(np.float32)} for _ in range(2)]
    kw = dict(mode="rotary", num_slots=4, prefetch_margin=1)
    jm = JManager(cfg, JRes(**kw), host, batch=1, cache_len=32)
    tm = TManager(tcfg, TRes(**kw), [{n: torch.from_numpy(w) for n, w in hw.items()}
                                     for hw in host], batch=1, cache_len=32, device="cpu")
    if prefetch:
        jm.enable_prefetch()
        tm.enable_prefetch()
    routers = [rng.standard_normal((d, e)).astype(np.float32) for _ in range(2)]
    jp, tp = JPredictor(routers), TPredictor(routers)
    for l in range(2):
        jm.prepare_layer(l, jp.smoothed[l])
        tm.prepare_layer(l, tp.smoothed[l])
    for step in range(16 if prefetch else 6):
        ids = rng.integers(0, e, (2, 1, 2))
        w = rng.random((2, 1, 2)).astype(np.float32)
        miss = rng.random((2, 1, 2)) < 0.3
        if prefetch:    # a bump of demand drifting round the experts: forecasts land
            bump = np.exp(-0.5 * ((np.arange(e) - 0.5 * step) % e) ** 2)
            demand = np.stack([bump / bump.sum()] * 2)
        else:
            demand = rng.dirichlet(np.ones(e), size=2)
        if prefetch:
            assert jm.begin_prefetch(jp) == tm.begin_prefetch(tp)
            assert jm._pending == tm._pending
        jm.rotate_from_telemetry(jp, ids, w, miss, demand)
        tm.rotate_from_telemetry(tp, ids, w, miss, demand)
        for l in range(2):
            np.testing.assert_array_equal(jm.policies[l].lut.e2s, tm.policies[l].lut.e2s)
            jlut = np.asarray(jm.device_lut(l))
            store = tm.stores[l]
            want = np.where(jlut == store.num_slots, store.miss_row, jlut + store.base())
            np.testing.assert_array_equal(tm.device_lut(l).numpy(), want)
        if prefetch:
            assert jm._live_contents == tm._live_contents
            assert jm._shadow_contents == tm._shadow_contents
            for l in range(2):
                js, ts = jm.stores[l], tm.stores[l]
                for name in ("w_gate", "w_up", "w_down"):
                    np.testing.assert_array_equal(ts.generation_view()[name].numpy(),
                                                  np.asarray(js.buffers[name]))
                    np.testing.assert_array_equal(
                        ts.generation_view(1 - ts.live)[name].numpy(),
                        np.asarray(js._shadow["buffers"][name]))
    for key in ("bytes_uploaded", "misses", "prefetch_launched", "prefetch_hits",
                "prefetch_wasted_bytes"):
        assert getattr(jm.stats, key) == getattr(tm.stats, key), key
    assert jm.stats.bytes_uploaded > 0
    if prefetch:
        assert tm.stats.prefetch_launched > 0 and tm.stats.prefetch_hits > 0
        assert any(s.live for s in tm.stores)                    # a flip happened
    assert [s.loads for s in jm.stats.layers.values()] == \
        [s.loads for s in tm.stats.layers.values()]
    for l in range(2):
        lut = tm.policies[l].lut
        buf = tm.stores[l].generation_view()["w_up"]
        for s, ex in enumerate(lut.s2e):
            if ex >= 0:
                np.testing.assert_array_equal(buf[s].numpy(), host[l]["w_up"][ex])
        assert not buf[lut.num_slots].any()
        assert not tm.stores[l].buffers["w_up"][tm.stores[l].miss_row].any()


def test_slot_store_write_batch_and_manager_guards():
    rng = np.random.default_rng(4)
    host = torch.from_numpy(rng.standard_normal((6, 8, 12)).astype(np.float32))
    store = SlotStore(3, {"w_up": (8, 12)}, torch.float32, "cpu")
    moved = store.write_batch([2, 0], {"w_up": host[[5, 1]]})
    assert moved == 2 * 8 * 12 * 4
    torch.testing.assert_close(store.buffers["w_up"][2], host[5])
    torch.testing.assert_close(store.buffers["w_up"][0], host[1])
    assert not store.buffers["w_up"][3].any()                 # the MISS slot
    with pytest.raises(ValueError):
        store.write_batch([3], {"w_up": host[[0]]})
    cfg = treduce(tget("qwen36-35b-a3b"))
    hw = [{"w_up": torch.zeros((8, 64, 48))}]
    with pytest.raises(InitializationError):
        TManager(cfg, TRes(mode="rotary", num_slots=2), hw, batch=1, cache_len=8, device="cpu")
    # quantized stores are priced, not refused: the reference's packed bytes
    res = dict(mode="rotary", num_slots=6, quantization="int4", quant_group_size=16)
    assert dataclasses.asdict(tcheck(cfg, TRes(**res), batch=1, cache_len=8)) == \
        dataclasses.asdict(jcheck(reduce_for_smoke(get_config("qwen36-35b-a3b")), JRes(**res),
                                  batch=1, cache_len=8))


class _RankMesh:
    """Rank ``rank`` of a (data 1, model ``tp``) mesh in one process: the
    axis sizes and coordinate that ``shard_params`` and
    ``_sharded_zero_state`` read."""

    mesh_dim_names = ("data", "model")

    def __init__(self, rank, tp):
        self.rank, self.shape = rank, (1, tp)

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, axis):
        return self.rank if axis == "model" else 0


def test_feasibility_under_the_model_axis_counts_a_rank_s_bytes():
    """``check_feasibility(shard=(rank, tp))`` counts what a rank of the
    model axis holds: its F slice of every slot (a sliced ``SlotStore``),
    its slice of every KV cache (``_sharded_zero_state``) and its
    ``shard_params`` share of the non-expert weights, all at 2 bytes an
    element as the whole count. Under a budget between the two totals the
    whole model is refused and a rank of two accepted, by the check and by
    the manager; the unsharded report stays the reference's."""
    from repro_torch.models.transformer import (
        Runtime, _sharded_zero_state, init_params, shard_params,
    )
    from repro_torch.tree import items

    cfg, cache = treduce(tget("qwen36-35b-a3b")), 64
    res = dict(mode="full")
    whole = tcheck(cfg, TRes(**res), batch=1, cache_len=cache)
    assert dataclasses.asdict(whole) == dataclasses.asdict(
        jcheck(reduce_for_smoke(get_config("qwen36-35b-a3b")), JRes(**res), batch=1,
               cache_len=cache))
    rank = tcheck(cfg, TRes(**res), batch=1, cache_len=cache, shard=(1, 2))
    rt = Runtime(cache_len=cache, mesh=_RankMesh(1, 2))

    def static(params):
        return 2 * sum(t.numel() for path, t in items(params) if "/experts/" not in path)

    params = init_params(cfg, 0, "meta")
    assert whole.static_bytes == static(params)
    assert rank.static_bytes == static(shard_params(cfg, params, rt)) < whole.static_bytes
    kv = _sharded_zero_state(cfg, 1, cache, rt, "cpu")
    assert rank.kv_bytes == 2 * sum(t.numel() for layer in kv for t in layer.values())
    assert rank.kv_bytes == whole.kv_bytes // 2
    shapes = {"w_gate": (cfg.d_model, cfg.moe.expert_d_ff), "w_up": (cfg.d_model, cfg.moe.expert_d_ff),
              "w_down": (cfg.moe.expert_d_ff, cfg.d_model)}
    store = SlotStore(cfg.moe.num_experts, shapes, torch.bfloat16, "cpu", shard=(1, 2))
    per_layer = sum(t.numel() * t.element_size() for t in store.buffers.values())
    assert rank.slot_bytes == cfg.num_moe_layers * per_layer == whole.slot_bytes // 2
    assert rank.activation_bytes == whole.activation_bytes

    budget = rank.total_bytes
    assert whole.total_bytes > budget
    res["hbm_budget_bytes"] = budget
    assert not tcheck(cfg, TRes(**res), batch=1, cache_len=cache).ok
    assert tcheck(cfg, TRes(**res), batch=1, cache_len=cache, shard=(0, 2)).ok
    rng = np.random.default_rng(5)
    host = [{n: torch.from_numpy(rng.standard_normal((cfg.moe.num_experts,) + s).astype(np.float32))
             for n, s in shapes.items()} for _ in range(cfg.num_moe_layers)]
    with pytest.raises(InitializationError):
        TManager(cfg, TRes(**res), host, batch=1, cache_len=cache, device="cpu")
    man = TManager(cfg, TRes(**res), host, batch=1, cache_len=cache, device="cpu", shard=(0, 2))
    assert man.report.ok and man.report.total_bytes == budget
