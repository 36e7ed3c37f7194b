"""The port's speculative windows (``spec_k > 1``) against the JAX engine's,
and the window's pieces against the reference's.

Cross-framework, on reduced f32 ``qwen36-35b-a3b`` with the same weights
(``bridge.from_reference``), batch 2, ``cache_len`` 32: spec-2 and spec-4
decode, synchronous at 3 of 8 slots (rollbacks and replays) and with
``prefetch=True`` at 6 of 8 (window relaunches), at full residency, and
with int4 slots in groups of 16, emit the JAX engine's greedy tokens; where
the tokens do not diverge the windows, drafted and accepted tokens, pulls,
misses, loads, uploaded bytes, host-computed experts, replayed and
relaunched steps and the prefetch counters equal JAX's. Every committed position's logits agree with
the JAX engine's single-token logits to 1e-4 (XLA and PyTorch sum in other
orders); a greedy id may differ only at a step whose top-2 margin is below
1e-3. Port-internal: spec-K tokens equal single-token tokens (and at full
residency the logits, bitwise), ceil(T/K) pulls and launches when miss-free,
accept rate 1 at full residency. Model and manager level, against JAX: the
KV window snapshot / rollback (with a ring cache) and the window rotation,
which also equals K sequential rotations. Small contracts: the accept rule,
the flag rules, sampled decode accepted, the serve CLI with ``--spec-k``.
"""
import dataclasses
import math
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
from repro.models import init_params
from repro.models import transformer as jtfm
from repro.models.transformer import Runtime as JRuntime
from repro_torch.bridge import from_reference
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.config import get_config as tget
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.engine import RotaryEngine as TEngine
from repro_torch.core.predictor import DemandPredictor as TPredictor
from repro_torch.core.residency import RotaryResidencyManager as TManager
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import Runtime as TRuntime
from repro_torch.serving.sampler import greedy_accept
from test_torch_walk import _agree, _setup, _steps, counters

T = 10


def _spec(engine, prompt, steps=T):
    """Tokens of one decode call of ``steps`` (windows) and the logits that
    chose them (prefill's, then each committed position's), [B, steps, V]."""
    logits = engine.prefill(prompt)
    engine.logit_log = [logits]
    toks = engine.decode(logits, steps)
    return toks, engine.logged_logits()[:-1].transpose(1, 0, 2)


def _kw(slots, quant):
    return dict(mode="full" if slots == 0 else "rotary", num_slots=slots, prefetch_margin=1,
                **quant)


@pytest.mark.parametrize("spec_k,prefetch,slots,quant", [
    (2, False, 3, {}), (4, False, 3, {}), (2, True, 6, {}), (4, True, 6, {}),
    (4, False, 0, {}), (4, False, 3, dict(quantization="int4", quant_group_size=16)),
])
def test_spec_port_equals_jax(spec_k, prefetch, slots, quant):
    cfg, params, tcfg, np_params = _setup()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    kw = _kw(slots, quant)
    rt = JRuntime(cache_len=32)
    je = JEngine(cfg, params, JRes(**kw), rt=rt, batch=2, spec_k=spec_k, prefetch=prefetch)
    single = JEngine(cfg, params, JRes(**kw), rt=rt, batch=2)
    te = TEngine(tcfg, from_reference(tcfg, np_params), TRes(**kw), rt=TRuntime(cache_len=32),
                 batch=2, device="cpu", spec_k=spec_k, prefetch=prefetch)
    jt = je.generate(prompt, T)
    st, sl = _steps(single, prompt, T)
    np.testing.assert_array_equal(jt, st)                  # the reference's own invariant
    tt, tl = _spec(te, prompt)
    if not _agree(jt, sl, tt, tl):
        assert counters(te.stats) == counters(je.stats)
        for key in ("prefetch_launched", "prefetch_hits", "prefetch_wasted_bytes"):
            assert getattr(te.stats, key) == getattr(je.stats, key), key
        np.testing.assert_allclose(te.last_logits, np.asarray(je.last_logits), atol=1e-4,
                                   rtol=1e-4)
    s = te.stats
    assert s.spec_windows > 0 and sum(l.host_computed for l in s.layers.values()) == s.misses
    if slots == 3:
        assert s.replayed_steps > 0 and s.accepted_tokens < s.drafted_tokens
    if prefetch:
        assert s.relaunched_steps > 0


@pytest.mark.parametrize("spec_k", [2, 4])
@pytest.mark.parametrize("slots", [0, 3])
def test_spec_tokens_equal_single_token_tokens(spec_k, slots):
    """Spec-K decode emits single-token decode's tokens, bit for bit, over
    windows that miss, roll back and replay; at full residency (no miss)
    every position's logits are bitwise the single-token step's too."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    res = TRes(**_kw(slots, {}))
    single = TEngine(tcfg, params, res, rt=TRuntime(cache_len=32), batch=2, device="cpu")
    spec = TEngine(tcfg, params, res, rt=TRuntime(cache_len=32), batch=2, device="cpu",
                   spec_k=spec_k)
    st, sl = _steps(single, prompt, 11)
    tt, tl = _spec(spec, prompt, 11)
    np.testing.assert_array_equal(tt, st)
    if slots == 0:
        assert tl.tobytes() == sl.tobytes()
    else:
        np.testing.assert_allclose(tl, sl, atol=1e-5, rtol=1e-5)
        assert spec.stats.replayed_steps > 0
    # chained decodes continue the sequence from ``last_logits``
    chained = TEngine(tcfg, params, res, rt=TRuntime(cache_len=32), batch=2, device="cpu",
                      spec_k=spec_k)
    a = chained.decode(chained.prefill(prompt), 6)
    b = chained.decode(chained.last_logits, 5)
    np.testing.assert_array_equal(np.concatenate([a, b], axis=1), st)


def test_spec_pulls_and_launches_when_miss_free():
    """Full residency: exactly ceil(T/K) blocking pulls and launches for T
    tokens, every drafted token accepted."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    prompt = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    for steps, k in ((12, 4), (10, 4), (12, 2)):
        eng = TEngine(tcfg, params, TRes(mode="full"), rt=TRuntime(cache_len=32), batch=2,
                      device="cpu", spec_k=k)
        logits = eng.prefill(prompt)
        pulls0, disp0 = eng.stats.sync_pulls, eng.stats.device_dispatches
        eng.decode(logits, steps)
        want = math.ceil(steps / k)
        assert eng.stats.sync_pulls - pulls0 == want, (steps, k)
        assert eng.stats.device_dispatches - disp0 == want, (steps, k)
        assert eng.launches == want and eng.stats.misses == 0
        assert eng.stats.accepted_tokens == eng.stats.drafted_tokens == steps
        assert eng.stats.accept_rate == 1.0


@pytest.mark.parametrize("window", [None, 4])
def test_kv_window_snapshot_and_rollback_match_jax(window):
    """Snapshot the K slots a window writes, overwrite them, roll back with
    keep 0..K (scalar and per row): the port's caches equal the reference's
    after each step, for a full cache and for a ring of 4 slots whose window
    wraps (cur_len 6, K 4)."""
    cfg = reduce_for_smoke(get_config("qwen36-35b-a3b"))
    tcfg = treduce(tget("qwen36-35b-a3b"))
    if window is not None:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, window=window))
        tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(tcfg.attention,
                                                                       window=window))
    b, cache_len, c0, k = 2, 16, 6, 4
    rng = np.random.default_rng(4)
    for keep in (0, 1, 3, 4, np.array([1, 3])):
        jstate = jtfm.zero_state(cfg, b, cache_len)
        shape = jstate[0][0]["k"].shape                       # [L, B, cap, Hkv, dh]
        before = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
        after = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
        jstate = (({n: jnp.asarray(before[n]) for n in ("k", "v")},),)
        tstate = [{n: torch.from_numpy(before[n][l].copy()) for n in ("k", "v")}
                  for l in range(shape[0])]
        jsaved = jtfm.snapshot_kv_window(cfg, jstate, jnp.int32(c0), k)
        tsaved = ttfm.snapshot_kv_window(tstate, c0, k)
        for l in range(shape[0]):
            for n in ("k", "v"):
                np.testing.assert_array_equal(tsaved[l][n].numpy(), np.asarray(jsaved[0][0][n][l]))
        # the window's writes: every slot it touches takes the "after" values
        rows, slots = ttfm._kv_window_slots(tstate[0]["k"], c0, k)
        for l, c in enumerate(tstate):
            for n in ("k", "v"):
                c[n][rows, slots] = torch.from_numpy(after[n][l])[rows, slots]
        jstate = (({n: jnp.asarray(np.stack([c[n].numpy() for c in tstate]))
                    for n in ("k", "v")},),)
        jkeep = jnp.asarray(keep, jnp.int32)
        jstate = jtfm.rollback_kv_window(cfg, jstate, jsaved, jnp.int32(c0), k, jkeep)
        ttfm.rollback_kv_window(tstate, tsaved, c0, k, torch.as_tensor(keep))
        for l in range(shape[0]):
            for n in ("k", "v"):
                np.testing.assert_array_equal(tstate[l][n].numpy(), np.asarray(jstate[0][0][n][l]))


def _managers(rng, cfg, tcfg, e, d, f, slots=5):
    host = [{"w_gate": rng.standard_normal((e, d, f)).astype(np.float32),
             "w_up": rng.standard_normal((e, d, f)).astype(np.float32),
             "w_down": rng.standard_normal((e, f, d)).astype(np.float32)} for _ in range(2)]
    routers = [rng.standard_normal((d, e)).astype(np.float32) for _ in range(2)]
    kw = dict(mode="rotary", num_slots=slots, prefetch_margin=1)

    def port():
        m = TManager(tcfg, TRes(**kw), [{n: torch.from_numpy(w) for n, w in hw.items()}
                                         for hw in host], batch=1, cache_len=32, device="cpu")
        return m, TPredictor(routers)

    jm = JManager(cfg, JRes(**kw), host, batch=1, cache_len=32)
    return (jm, JPredictor(routers)), port(), port()


def test_window_rotation_matches_sequential_and_jax():
    """``rotate_window_from_telemetry`` over K steps leaves the LUT, the ring,
    the predictor's EMA, the hit/miss counts and every resident slot's rows
    as K sequential ``rotate_from_telemetry`` calls do, moving no more
    bytes; and it equals the JAX manager's window rotation exactly (LUT,
    ring position, loads, bytes)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
    tcfg = dataclasses.replace(treduce(tget("qwen36-35b-a3b")), dtype="float32")
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    rng = np.random.default_rng(6)
    (jm, jp), (wm, wp), (sm, sp) = _managers(rng, cfg, tcfg, e, d, f)
    for l in range(2):
        for m, p in ((jm, jp), (wm, wp), (sm, sp)):
            m.prepare_layer(l, p.smoothed[l])
    for window in range(3):
        k = 4
        ids = rng.integers(0, e, (k, 2, 3, 2)).astype(np.int32)
        w = rng.random((k, 2, 3, 2)).astype(np.float32)
        miss = rng.random((k, 2, 3, 2)) < 0.2
        dem = rng.dirichlet(np.ones(e), size=(k, 2))
        jm.rotate_window_from_telemetry(jp, ids, w, miss, dem)
        wm.rotate_window_from_telemetry(wp, ids, w, miss, dem)
        for s in range(k):
            sm.rotate_from_telemetry(sp, ids[s], w[s], miss[s], dem[s])
        for l in range(2):
            for m in (jm, sm):
                np.testing.assert_array_equal(wm.policies[l].lut.e2s, m.policies[l].lut.e2s)
                assert wm.policies[l].ring.pos == m.policies[l].ring.pos
            np.testing.assert_array_equal(wp.smoothed[l], sp.smoothed[l])
            np.testing.assert_array_equal(wp.smoothed[l], jp.smoothed[l])
            assert wm.stats.layer(l).hits == sm.stats.layer(l).hits == jm.stats.layer(l).hits
            assert wm.stats.layer(l).loads == jm.stats.layer(l).loads
            for slot, ex in enumerate(wm.policies[l].lut.s2e):
                if ex >= 0:
                    for n, buf in wm.stores[l].buffers.items():
                        assert torch.equal(buf[slot], sm.stores[l].buffers[n][slot])
    assert wm.stats.bytes_uploaded == jm.stats.bytes_uploaded
    assert wm.stats.bytes_uploaded <= sm.stats.bytes_uploaded


def test_greedy_accept_rule():
    """The longest agreeing prefix, per row (the reference's rule)."""
    draft = np.array([[1, 5], [2, 6], [3, 7]], np.int32)          # [K=3, B=2]
    verify = np.array([[1, 5], [2, 9], [3, 7]], np.int32)
    np.testing.assert_array_equal(greedy_accept(draft, verify), [3, 1])
    np.testing.assert_array_equal(greedy_accept(draft, draft), [3, 3])
    verify0 = verify.copy()
    verify0[0, 0] = 99
    np.testing.assert_array_equal(greedy_accept(draft, verify0), [0, 1])


def test_spec_flag_rules_and_sampled_decode_refused():
    """Windows ride the fused step (no LRU, no host routing, no forced walk)
    and fit the cache. Sampled decode is ported now and no longer refused
    (``test_torch_sampling.py`` holds its streams to JAX's): ``greedy=False``
    decodes in windows; only a sampler without a temperature is refused."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    rt = TRuntime(cache_len=32)
    for kw in (dict(res=TRes(mode="lru", num_slots=5)),
               dict(host_routing=True), dict(fused_decode=False)):
        res = kw.pop("res", TRes(mode="rotary", num_slots=5))
        with pytest.raises(ValueError, match="spec_k > 1"):
            TEngine(tcfg, params, res, rt=rt, device="cpu", spec_k=4, **kw)
    with pytest.raises(ValueError, match="capacity"):
        TEngine(tcfg, params, TRes(mode="full"), rt=rt, device="cpu", spec_k=33)
    with pytest.raises(ValueError, match="window size"):
        TEngine(tcfg, params, TRes(mode="full"), rt=rt, device="cpu", spec_k=0)
    eng = TEngine(tcfg, params, TRes(mode="full"), rt=rt, batch=2, device="cpu", spec_k=4)
    logits = eng.prefill(np.zeros((2, 4), np.int32))
    toks = eng.decode(logits, 4, greedy=False)
    assert toks.shape == (2, 4) and eng.stats.spec_windows == 1
    with pytest.raises(AttributeError, match="temperature"):
        eng.decode(eng.last_logits, 4, sampler=object())


def test_serve_cli_runs_spec_windows_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen36-35b-a3b", "--device", "cpu",
                                      "--requests", "1", "--max-new", "6", "--slots", "4",
                                      "--layers", "2", "--spec-k", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert re.search(r"req 0: \[(\d+, ){5}\d+\]", out)
    assert re.search(r"'spec_windows': [1-9]", out)
    assert re.search(r"'drafted_tokens': [1-9]", out)
