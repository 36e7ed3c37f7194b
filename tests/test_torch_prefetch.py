"""The port's miss relaunch and double-buffered prefetch (``prefetch=True``)
against the JAX engine's, and the pieces the captured decode step needs.

Cross-framework, on reduced f32 ``qwen36-35b-a3b`` with the same weights
(``bridge.from_reference``), batch 2, ``cache_len`` 32: with
``prefetch=True`` the port emits the JAX engine's greedy tokens at full
residency and at 6 and 3 of 8 slots, and with int4 slots in groups of 16;
where the tokens do not diverge its misses, relaunched and replayed steps
and prefetch counters equal JAX's. Logits agree to 1e-4 (XLA and PyTorch
sum in other orders) and a greedy id may differ only at a step whose top-2
margin is below 1e-3. Port-internal: prefetch tokens equal the synchronous
path's. Manager level, exact: ``ensure_resident`` makes the reference's
loads. Model level: a windowed (ring) cache decodes past ``cache_len`` as
the reference does, and a device ``cur_len`` gives the int path's bits.
"""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ResidencyConfig as JRes
from repro.config import get_config
from repro.configs import reduce_for_smoke
from repro.core import RotaryEngine as JEngine
from repro.core.predictor import DemandPredictor as JPredictor
from repro.core.residency import RotaryResidencyManager as JManager
from repro.models import attention as jattn
from repro.models import init_params
from repro.models.transformer import Runtime as JRuntime
from repro_torch.bridge import from_reference
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.config import get_config as tget
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.engine import RotaryEngine as TEngine
from repro_torch.core.predictor import DemandPredictor as TPredictor
from repro_torch.core.residency import RotaryResidencyManager as TManager
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import Runtime as TRuntime

STEPS = 8
_CACHE = {}


def _setup(window=None):
    """(jax cfg, jax params, port cfg, port params as numpy), f32, cached."""
    if window not in _CACHE:
        cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
        tcfg = dataclasses.replace(treduce(tget("qwen36-35b-a3b")), dtype="float32")
        if window is not None:
            cfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention,
                                                                         window=window))
            tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(tcfg.attention,
                                                                           window=window))
        params = jax.jit(init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        _CACHE[window] = (cfg, params, tcfg, jax.tree.map(np.asarray, params))
    return _CACHE[window]


def _steps(engine, prompt, steps=STEPS):
    """Greedy tokens and the logits that chose them, one decode call per token."""
    logits = [np.asarray(engine.prefill(prompt), np.float32)]
    toks = []
    for _ in range(steps):
        toks.append(engine.decode(logits[-1], 1)[:, 0])
        logits.append(np.asarray(engine.last_logits, np.float32))
    return np.stack(toks, 1), np.stack(logits[:-1], 1)


def _agree(jt, jl, tt, tl):
    """Tokens and logits agree up to the first divergence, which only a
    near-tie may cause. Returns whether the tokens diverged."""
    diverged = np.flatnonzero((jt != tt).any(axis=0))
    stop = diverged[0] if diverged.size else jt.shape[1]
    np.testing.assert_allclose(tl[:, :stop], jl[:, :stop], atol=1e-4, rtol=1e-4)
    if diverged.size:
        top2 = np.sort(jl[:, stop], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() < 1e-3, (jt, tt)
    return bool(diverged.size)


COUNTERS = ("misses", "relaunched_steps", "replayed_steps", "prefetch_launched",
            "prefetch_hits", "prefetch_wasted_bytes", "bytes_uploaded")


@pytest.mark.parametrize("slots,quant", [
    (0, {}), (6, {}), (3, {}), (3, dict(quantization="int4", quant_group_size=16)),
])
def test_prefetch_port_equals_jax_and_its_sync_path(slots, quant):
    cfg, params, tcfg, np_params = _setup()
    mode = "full" if slots == 0 else "rotary"
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    kw = dict(mode=mode, num_slots=slots, prefetch_margin=1, **quant)
    je = JEngine(cfg, params, JRes(**kw), rt=JRuntime(cache_len=32), batch=2, prefetch=True)
    engines = {pf: TEngine(tcfg, from_reference(tcfg, np_params), TRes(**kw),
                           rt=TRuntime(cache_len=32), batch=2, device="cpu", prefetch=pf)
               for pf in (True, False)}
    jt, jl = _steps(je, prompt)
    tt, tl = _steps(engines[True], prompt)
    st, _ = _steps(engines[False], prompt)
    np.testing.assert_array_equal(tt, st)                    # prefetch keeps the tokens
    te = engines[True]
    if not _agree(jt, jl, tt, tl):
        for key in COUNTERS:
            assert getattr(te.stats, key) == getattr(je.stats, key), key
    if slots == 3:
        assert te.stats.relaunched_steps > 0
    if slots == 0:
        assert te.stats.misses == 0 and te.stats.relaunched_steps == 0
        assert all(s.generations == 1 for s in te.manager.stores)    # full: no shadow
    else:
        assert all(s.generations == 2 for s in te.manager.stores)
        assert te.stats.overlap_ms > 0


def test_prefetch_flag_validation():
    """As the reference (``tests/test_fused_decode.py``): LRU has no fused
    step to overlap, so prefetch raises, and without prefetch it builds and
    takes the sync walk; full residency accepts the flag and builds no
    shadow."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    rt = TRuntime(cache_len=32)
    with pytest.raises(ValueError, match="fused"):
        TEngine(tcfg, params, TRes(mode="lru", num_slots=5), rt=rt, device="cpu", prefetch=True)
    lru = TEngine(tcfg, params, TRes(mode="lru", num_slots=5), rt=rt, device="cpu")
    assert not lru._hot_decode and not lru._fused_decode
    full = TEngine(tcfg, params, TRes(mode="full"), rt=rt, device="cpu", prefetch=True)
    assert full.prefetch and not full.manager._prefetch_enabled
    assert all(s.generations == 1 for s in full.manager.stores)


def test_ensure_resident_makes_the_reference_loads():
    """From identical warm starts and rotations, the relaunch's correction
    evicts the same occupants (coldest ring EMA first, never a routed
    expert) into the same slots, refuses the same uncoverable sets and
    uploads the same bytes."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
    tcfg = dataclasses.replace(treduce(tget("qwen36-35b-a3b")), dtype="float32")
    rng = np.random.default_rng(7)
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
        demand = rng.dirichlet(np.ones(e), size=2)
        jm.rotate_from_telemetry(jp, ids, w, np.zeros_like(ids, bool), demand)
        tm.rotate_from_telemetry(tp, ids, w, np.zeros_like(ids, bool), demand)
        for l in range(2):
            routed = rng.choice(e, size=int(rng.integers(1, 7)), replace=False)
            assert jm.ensure_resident(l, routed, routed) == tm.ensure_resident(l, routed, routed)
            np.testing.assert_array_equal(jm.policies[l].lut.e2s, tm.policies[l].lut.e2s)
    assert jm.stats.bytes_uploaded == tm.stats.bytes_uploaded
    assert [s.loads for s in jm.stats.layers.values()] == \
        [s.loads for s in tm.stats.layers.values()]
    for l in range(2):
        lut = tm.policies[l].lut
        for s, ex in enumerate(lut.s2e):
            if ex >= 0:
                np.testing.assert_array_equal(tm.stores[l].buffers["w_up"][s].numpy(),
                                              host[l]["w_up"][ex])


def test_windowed_attention_decodes_ring_laps_past_cache_len_like_jax():
    """A ring cache of cap = min(window 4, cache_len 8) = 4 slots: prefill 6
    positions, then 14 decode steps (cur_len 6..19, past cache_len), each
    written at cur_len % cap and scored through ``ops.decode_attention``
    (K2's plain version here) with the row's length clamped to cap."""
    cfg, params, tcfg, np_params = _setup()
    acfg = dataclasses.replace(cfg.attention, window=4, logit_soft_cap=3.0)
    tacfg = dataclasses.replace(tcfg.attention, window=4, logit_soft_cap=3.0)
    pj = jax.tree.map(lambda a: a[0], params["segments"][0][0])["attn"]
    pt = from_reference(tcfg, np_params)["layers"][0]["attn"]
    x = np.random.default_rng(1).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    _, cache_j = jax.jit(jattn.attention_prefill, static_argnums=(1, 3))(
        pj, acfg, jnp.asarray(x), 8)
    _, cache_t = tattn.attention_prefill(pt, tacfg, torch.from_numpy(x), 8)
    decode = jax.jit(jattn.attention_decode, static_argnums=1)
    for step in range(14):
        xd = np.random.default_rng(10 + step).standard_normal((2, 1, cfg.d_model))
        xd = xd.astype(np.float32)
        yj, cache_j = decode(pj, acfg, jnp.asarray(xd), cache_j, jnp.int32(6 + step))
        yt = tattn.attention_decode(pt, tacfg, torch.from_numpy(xd), cache_t,
                                    torch.tensor(6 + step))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache_j["k"]), atol=1e-5,
                                   rtol=1e-5)


def test_windowed_engine_decodes_past_cache_len_like_jax():
    """Engine level: a window of 4 under cache_len 8, a prompt of 10 and 10
    decode steps (the port refused both before it kept the ring), the same
    tokens as the JAX engine, with misses and replays at 3 of 8 slots."""
    cfg, params, tcfg, np_params = _setup(window=4)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    kw = dict(mode="rotary", num_slots=3, prefetch_margin=1)
    je = JEngine(cfg, params, JRes(**kw), rt=JRuntime(cache_len=8), batch=2)
    te = TEngine(tcfg, from_reference(tcfg, np_params), TRes(**kw), rt=TRuntime(cache_len=8),
                 batch=2, device="cpu")
    jt, jl = _steps(je, prompt, 10)
    tt, tl = _steps(te, prompt, 10)
    if not _agree(jt, jl, tt, tl):
        assert te.stats.misses == je.stats.misses
    assert te.stats.replayed_steps > 0
    _, _, pcfg, p_params = _setup()
    plain = TEngine(pcfg, from_reference(pcfg, p_params), TRes(**kw), rt=TRuntime(cache_len=8),
                    batch=2, device="cpu")
    with pytest.raises(ValueError, match="cache_len"):
        plain.prefill(prompt)                       # window-free: still refused


def test_device_cur_len_gives_the_int_path_bits():
    """The decode step over the stack with ``cur_len`` as a 0-d tensor (what
    the captured step reads) against the same step with a Python int:
    identical logits, telemetry and caches, bit for bit."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 200, (2, 7)).astype(np.int64))
    out = []
    for cur in (7, torch.tensor(7)):
        state = ttfm.zero_state(tcfg, 2, 16, "cpu")
        h = ttfm.embed_tokens(params, x)
        for li, p in enumerate(params["layers"]):
            h = ttfm.attn_half(tcfg, p, h, "prefill", state[li], 0, 16)[0]
        logits, aux = ttfm.decode_model(tcfg, params, x[:, -1], state, cur)
        out.append((logits, aux, state))
    (l0, a0, s0), (l1, a1, s1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a0[k], a1[k]) for k in a0)
    assert all(torch.equal(c0[n], c1[n]) for c0, c1 in zip(s0, s1) for n in ("k", "v"))


def test_prefetch_serve_cli_runs_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen36-35b-a3b", "--device", "cpu",
                                      "--requests", "1", "--max-new", "4", "--slots", "4",
                                      "--layers", "2", "--prefetch"])
    serve.main()
    out = capsys.readouterr().out
    assert re.search(r"req 0: \[\d+, \d+, \d+, \d+\]", out) and "relaunched_steps" in out
