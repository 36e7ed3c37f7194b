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
from repro_torch.core.slots import SlotStore, gather_rows


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


def test_manager_rotation_matches_reference_from_identical_telemetry():
    """Identical warm start and per-step telemetry: the same LUTs, the same
    bytes uploaded, and the port's device slots hold exactly the experts the
    LUT names (the MISS slot stays zero)."""
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
    routers = [rng.standard_normal((d, e)).astype(np.float32) for _ in range(2)]
    jp, tp = JPredictor(routers), TPredictor(routers)
    for l in range(2):
        jm.prepare_layer(l, jp.smoothed[l])
        tm.prepare_layer(l, tp.smoothed[l])
    for step in range(6):
        ids = rng.integers(0, e, (2, 1, 2))
        w = rng.random((2, 1, 2)).astype(np.float32)
        miss = rng.random((2, 1, 2)) < 0.3
        demand = rng.dirichlet(np.ones(e), size=2)
        jm.rotate_from_telemetry(jp, ids, w, miss, demand)
        tm.rotate_from_telemetry(tp, ids, w, miss, demand)
        for l in range(2):
            np.testing.assert_array_equal(jm.policies[l].lut.e2s, tm.policies[l].lut.e2s)
            np.testing.assert_array_equal(np.asarray(jm.device_lut(l)), tm.device_lut(l).numpy())
    assert jm.stats.bytes_uploaded == tm.stats.bytes_uploaded > 0
    assert jm.stats.misses == tm.stats.misses
    for l in range(2):
        lut = tm.policies[l].lut
        buf = tm.stores[l].buffers["w_up"]
        for s, ex in enumerate(lut.s2e):
            if ex >= 0:
                np.testing.assert_array_equal(buf[s].numpy(), host[l]["w_up"][ex])
        assert not buf[lut.num_slots].any()


def test_slot_store_write_batch_and_manager_guards():
    rng = np.random.default_rng(4)
    host = torch.from_numpy(rng.standard_normal((6, 8, 12)).astype(np.float32))
    store = SlotStore(3, {"w_up": (8, 12)}, torch.float32, "cpu")
    moved = store.write_batch([2, 0], {"w_up": gather_rows(host, [5, 1])})
    assert moved == 2 * 8 * 12 * 4
    torch.testing.assert_close(store.buffers["w_up"][2], host[5])
    torch.testing.assert_close(store.buffers["w_up"][0], host[1])
    assert not store.buffers["w_up"][3].any()                 # the MISS slot
    with pytest.raises(ValueError):
        store.write_batch([3], {"w_up": gather_rows(host, [0])})
    cfg = treduce(tget("qwen36-35b-a3b"))
    hw = [{"w_up": torch.zeros((8, 64, 48))}]
    with pytest.raises(InitializationError):
        TManager(cfg, TRes(mode="rotary", num_slots=2), hw, batch=1, cache_len=8, device="cpu")
    with pytest.raises(NotImplementedError):
        tcheck(cfg, TRes(mode="rotary", num_slots=6, quantization="int4"), batch=1, cache_len=8)
