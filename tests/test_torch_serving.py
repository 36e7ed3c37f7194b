"""The port's continuous-batching ``ServingEngine`` against the JAX package's.

Pieces, on the same numpy-seeded inputs in both packages: the page pool and
the scheduler driven through one operation sequence (tables, admissions,
``check()``); paged ``attention_decode`` with per-row lengths, bitwise the
port's contiguous decode on the CPU and within 1e-5 of JAX's paged decode
(XLA and PyTorch sum in other orders); the paged KV window snapshot and
rollback with per-row ``keep``, exact; ``prefill_model(last_index=)``
within 1e-4 of JAX's in f32, at full residency and through a rotary
residency manager (slot stores plus the host correction), which it leaves
as it found it; ``rotate_window_from_telemetry(accepted=)``, equal
transitions, counts and predictor EMA.

Engine level, reduced f32 ``qwen36-35b-a3b`` on the reference's weights
(``bridge.from_reference``), three requests of mixed lengths over 3 rows,
``cache_len`` 32, ``spec_cap`` 4: every request's tokens and the
``windows``, ``spec_windows``, ``misses`` and ``kv_pages_*`` counters equal
JAX's ``ServingEngine`` at full residency, rotary with every expert
resident, rotary at 6 of 8 slots (misses dropped), int4 slots at 6 of 8,
sampled (seeded streams) and with ``prefetch=True``. Port-internal:
concurrent == each request alone, prefetch == synchronous, ``warmup``
changes nothing, a pool smaller than the population recycles pages exactly,
the flag rules (prefetch needs the paged pool, as in the reference), and
the serve CLI's ``--engine batch``.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ResidencyConfig as JRes
from repro.config.base import AttentionConfig as JAttn
from repro.core.predictor import DemandPredictor as JPredictor
from repro.core.residency import RotaryResidencyManager as JManager
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.models.transformer import Runtime as JRuntime
from repro.serving import ServingEngine as JServing
from repro.serving.kv_pool import KVPagePool as JPool
from repro.serving.sampler import SamplerConfig as JSampler
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.bridge import from_reference, to_tensor
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.config.base import AttentionConfig as TAttn
from repro_torch.core.predictor import DemandPredictor as TPredictor
from repro_torch.core.residency import RotaryResidencyManager as TManager
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import Runtime as TRuntime
from repro_torch.serving import KVPagePool as TPool
from repro_torch.serving import SamplerConfig as TSampler
from repro_torch.serving import Scheduler as TScheduler
from repro_torch.serving import ServingEngine as TServing
from repro_torch.serving.kv_pool import PagePoolError
from test_torch_walk import _setup

LENS = (5, 8, 11)
SEEDS = [11, 22, 33]
MAX_NEW = 8


# ===========================================================================
# host bookkeeping: pool and scheduler, one operation sequence, both packages
# ===========================================================================
def _pool_ops(pool_cls, seed):
    rng = np.random.default_rng(seed)
    pool = pool_cls(num_pages=12, page_size=4, row_pages=4)
    live, uid, trace = {}, 0, []
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0:
            need = int(rng.integers(1, pool.row_pages + 1))
            ok = pool.reserve(uid, need)
            grew = pool.ensure(uid, int(rng.integers(1, need * pool.page_size + 1))) if ok else 0
            if ok:
                live[uid] = need
            trace.append(("admit", uid, ok, grew))
            uid += 1
        elif op == 1 and live:
            u = int(rng.choice(sorted(live)))
            trace.append(("grow", u, pool.ensure(u, int(rng.integers(1, live[u] * 4 + 1)))))
        elif op == 2 and live:
            u = int(rng.choice(sorted(live)))
            live.pop(u)
            trace.append(("free", u, pool.release(u)))
        pool.check()
        trace.append(tuple(pool.table_array(u).tolist() for u in sorted(live)))
        trace.append((pool.pages_free, pool.pages_reservable, pool.pages_in_use))
    return trace


def _scheduler_ops(sched_cls, pool_cls, seed):
    rng = np.random.default_rng(seed)
    pool = pool_cls(num_pages=10, page_size=4, row_pages=4)
    sch = sched_cls(num_slots=3, spec_cap=4, max_prompt_len=16)
    trace = []
    for t in range(60):
        if rng.random() < 0.5:
            n = int(rng.integers(1, 20))
            r = sch.submit(np.arange(n), int(rng.integers(1, 6)), float(t),
                           deadline_s=float(rng.integers(1, 50)) if rng.random() < 0.3 else None)
            trace.append(("submit", r.uid, r.done, r.reject_reason))
        adm = sch.admit(float(t), pool=pool)
        for r in adm:
            pool.ensure(r.uid, len(r.prompt))
        trace.append(("admit", [(r.uid, r.slot) for r in adm]))
        for slot in sorted(sch.running):
            req = sch.running[slot]
            sch.step_done(slot, int(rng.integers(0, 9)), float(t), eos=7)
            if req.done:
                pool.release(req.uid)
            d = int(rng.integers(1, 5))
            sch.observe_accept(slot, d, int(rng.integers(0, d + 1)))
        trace.append(("spec", [sch.spec_len(s) for s in range(3)], sorted(sch.free_slots)))
        trace.append(sched_cls.prefill_bucket([int(rng.integers(1, 700))], 512))
        pool.check()
    trace.append([(r.uid, r.output, r.truncated) for r in sch.completed])
    return trace


@pytest.mark.parametrize("case", ["pool-0", "pool-1", "scheduler-0", "scheduler-1"])
def test_pool_and_scheduler_equal_jax(case):
    """The same operation sequence through both packages' ``KVPagePool``
    and ``Scheduler`` gives the same tables, admissions, speculative
    lengths, buckets and completions, and ``check()`` holds throughout."""
    kind, seed = case.split("-")
    if kind == "pool":
        assert _pool_ops(TPool, int(seed)) == _pool_ops(JPool, int(seed))
    else:
        assert (_scheduler_ops(TScheduler, TPool, int(seed))
                == _scheduler_ops(JScheduler, JPool, int(seed)))


def test_pool_ensure_past_reservation_raises():
    pool = TPool(num_pages=8, page_size=4, row_pages=4)
    assert pool.reserve(7, 2)
    with pytest.raises(PagePoolError):
        pool.ensure(7, 3 * pool.page_size)
    assert pool.pages_free == 8 and pool.pages_reservable == 6
    assert not pool.reserve(8, 7) and pool.reserve(8, 6)


# ===========================================================================
# paged decode attention and the paged KV window
# ===========================================================================
def test_paged_attention_decode_equals_contiguous_and_jax():
    """Per-row lengths through a permuted page table over shared planes
    whose off-table pages hold large garbage: the port's paged decode is
    bitwise its contiguous decode of the same logical KV (output and the
    new K/V's landing places), and within 1e-5 of JAX's paged decode."""
    rng = np.random.default_rng(0)
    b, cap, ps, P, d = 3, 16, 4, 14, 32
    n_pp = cap // ps
    jac = JAttn(num_heads=4, num_kv_heads=2, head_dim=8)
    tac = TAttn(num_heads=4, num_kv_heads=2, head_dim=8)
    jp = jattn.init_attention(jax.random.PRNGKey(0), d, jac, jnp.float32)
    tp = {k: to_tensor(np.asarray(v)) for k, v in jp.items()}
    cl = np.asarray([5, 9, 0], np.int32)
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    ck = rng.standard_normal((b, cap, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((b, cap, 2, 8)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))[:b * n_pp].reshape(b, n_pp).astype(np.int32)
    pk = rng.standard_normal((P, ps, 2, 8)).astype(np.float32) * 1e3
    pv = rng.standard_normal((P, ps, 2, 8)).astype(np.float32) * 1e3
    for i in range(b):
        for j in range(n_pp):
            pk[perm[i, j]] = ck[i, j * ps:(j + 1) * ps]
            pv[perm[i, j]] = cv[i, j * ps:(j + 1) * ps]
    cont = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    paged = {"k": torch.from_numpy(pk.copy()), "v": torch.from_numpy(pv.copy())}
    y_c = tattn.attention_decode(tp, tac, torch.from_numpy(x), cont, torch.from_numpy(cl))
    y_p = tattn.attention_decode(tp, tac, torch.from_numpy(x), paged, torch.from_numpy(cl),
                                 page_table=torch.from_numpy(perm))
    assert y_p.numpy().tobytes() == y_c.numpy().tobytes()
    for i in range(b):
        s = cl[i] % cap
        pg, off = perm[i, s // ps], s % ps
        for n in ("k", "v"):
            assert torch.equal(cont[n][i, s], paged[n][pg, off])
    y_j, jcache = jattn.attention_decode(
        jp, jac, jnp.asarray(x), {"k": jnp.asarray(pk), "v": jnp.asarray(pv)},
        jnp.asarray(cl), page_table=jnp.asarray(perm))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(paged["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5, rtol=1e-5)


def test_paged_snapshot_rollback_restores_pages_with_per_row_keep():
    """The paged snapshot / rollback, per-row ``keep``: the rejected window
    slots get their pre-window contents back at their page-table
    addresses, the accepted ones stay, exactly; as JAX's does."""
    rng = np.random.default_rng(1)
    b, cap, ps, P, k = 3, 16, 4, 14, 3
    n_pp = cap // ps
    cl = np.asarray([5, 9, 14], np.int32)                 # the last row wraps its window
    keep = np.asarray([1, 0, 3], np.int32)
    perm = rng.permutation(np.arange(1, P))[:b * n_pp].reshape(b, n_pp).astype(np.int32)
    planes = [{n: rng.standard_normal((P, ps, 2, 8)).astype(np.float32) for n in ("k", "v")}
              for _ in range(2)]
    state = [{n: torch.from_numpy(pl[n].copy()) for n in pl} for pl in planes]
    pt = torch.from_numpy(perm)
    saved = ttfm.snapshot_kv_window(state, torch.from_numpy(cl), k, page_table=pt)
    for c in state:
        for n in c:
            c[n].add_(7.0)
    garbled = [{n: c[n].clone() for n in c} for c in state]
    ttfm.rollback_kv_window(state, saved, torch.from_numpy(cl), k, torch.from_numpy(keep),
                            page_table=pt)
    for li in range(2):
        for i in range(b):
            for j in range(k):
                s = (cl[i] + j) % cap
                pg, off = perm[i, s // ps], s % ps
                want = garbled[li]["k"][pg, off] if j < keep[i] else planes[li]["k"][pg, off]
                np.testing.assert_array_equal(state[li]["k"][pg, off].numpy(), np.asarray(want))

    class StubCfg:
        segments = ((("attn_moe",), 2),)

    jstate = ((({n: jnp.stack([jnp.asarray(pl[n]) for pl in planes]) for n in ("k", "v")}),),)
    jsaved = jtfm.snapshot_kv_window(StubCfg, jstate, jnp.asarray(cl), k,
                                     page_table=jnp.asarray(perm))
    jgarbled = jax.tree.map(lambda c: c + 7.0, jstate)
    jrolled = jtfm.rollback_kv_window(StubCfg, jgarbled, jsaved, jnp.asarray(cl), k,
                                      jnp.asarray(keep), page_table=jnp.asarray(perm))
    for li in range(2):
        for n in ("k", "v"):
            np.testing.assert_array_equal(state[li][n].numpy(), np.asarray(jrolled[0][0][n][li]))


# ===========================================================================
# admission prefill and the ragged window rotation
# ===========================================================================
def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


@pytest.mark.parametrize("slots", [0, 6])
def test_prefill_model_last_index_equals_jax(slots):
    """Right-padded rows of one bucket, each row's logits at its
    ``last_index`` and its K/V up to its length, within 1e-4 of JAX's
    ``prefill_model`` (f32): at full residency (the expert store) and
    through a residency manager at 6 of 8 slots (slot stores, misses on the
    host), whose LUTs, counters and predictor EMA it leaves unchanged."""
    cfg, params, tcfg, np_params = _setup()
    prompts = _prompts(cfg.vocab_size)
    bucket = 16
    padded = np.zeros((3, bucket), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    last = np.asarray([len(p) - 1 for p in prompts], np.int32)
    jl, jstate = jax.jit(lambda p, t, li: jtfm.prefill_model(
        cfg, p, t, JRuntime(cache_len=32), last_index=li))(params, jnp.asarray(padded),
                                                           jnp.asarray(last))
    res = TRes(mode="rotary", num_slots=slots) if slots else None
    eng = TServing(tcfg, from_reference(tcfg, np_params), rt=TRuntime(cache_len=32),
                   num_slots=3, residency=res, device="cpu")
    mgr = eng.res_mgr
    before = None
    if mgr is not None:
        before = ([p.lut.s2e.copy() for p in mgr.policies], mgr.stats.summary(),
                  [s.copy() for s in eng.predictor.smoothed])
    rows = eng._prefill_rows(prompts, bucket)
    for i, (logits, state) in enumerate(rows):
        np.testing.assert_allclose(logits[0], np.asarray(jl)[i], atol=1e-4, rtol=1e-4)
        n = len(prompts[i])
        for li in range(tcfg.num_layers):
            np.testing.assert_allclose(state[li]["k"][0, :n].numpy(),
                                       np.asarray(jstate[0][0]["k"][li, i, :n]),
                                       atol=1e-4, rtol=1e-4)
    if mgr is not None:
        assert eng.stats.host_dequant_experts > 0              # misses were corrected
        for l, p in enumerate(mgr.policies):
            np.testing.assert_array_equal(p.lut.s2e, before[0][l])
        after = mgr.stats.summary()
        for key in ("misses", "bytes_loaded_MB", "steps"):
            assert after[key] == before[1][key]
        for a, b in zip(eng.predictor.smoothed, before[2]):
            np.testing.assert_array_equal(a, b)


def test_rotate_window_with_accepted_equals_jax():
    """Ragged commits (``accepted`` per row, pad rows 0): the same
    transitions, LUTs, ring positions, hit/miss counts, loads, bytes and
    predictor EMA as JAX's manager, window after window; rows and steps
    past their accepted count touch neither the counts nor the EMA."""
    cfg, _, tcfg, _ = _setup()
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    rng = np.random.default_rng(6)
    host = [{"w_gate": rng.standard_normal((e, d, f)).astype(np.float32),
             "w_up": rng.standard_normal((e, d, f)).astype(np.float32),
             "w_down": rng.standard_normal((e, f, d)).astype(np.float32)} for _ in range(2)]
    routers = [rng.standard_normal((d, e)).astype(np.float32) for _ in range(2)]
    kw = dict(mode="rotary", num_slots=5, prefetch_margin=1)
    jm, jp = JManager(cfg, JRes(**kw), host, batch=4, cache_len=32), JPredictor(routers)
    tm = TManager(tcfg, TRes(**kw), [{n: torch.from_numpy(w) for n, w in hw.items()}
                                     for hw in host], batch=4, cache_len=32, device="cpu")
    tp = TPredictor(routers)
    for l in range(2):
        jm.prepare_layer(l, jp.smoothed[l])
        tm.prepare_layer(l, tp.smoothed[l])
    for window, accepted in enumerate(([3, 1, 4, 0], [0, 0, 0, 0], [2, 2, 1, 0], [4, 4, 4, 4])):
        k = 4
        ids = rng.integers(0, e, (k, 2, 4, 2)).astype(np.int32)
        w = rng.random((k, 2, 4, 2)).astype(np.float32)
        miss = rng.random((k, 2, 4, 2)) < 0.2
        dem = rng.dirichlet(np.ones(e), size=(k, 2))
        acc = np.asarray(accepted, np.int32)
        jm.rotate_window_from_telemetry(jp, ids, w, miss, dem, accepted=acc)
        tm.rotate_window_from_telemetry(tp, ids, w, miss, dem, accepted=acc)
        for l in range(2):
            np.testing.assert_array_equal(tm.policies[l].lut.e2s, jm.policies[l].lut.e2s)
            assert tm.policies[l].ring.pos == jm.policies[l].ring.pos
            np.testing.assert_array_equal(tp.smoothed[l], jp.smoothed[l])
            for key in ("hits", "misses", "loads", "bytes_loaded", "forward_rotations",
                        "reverse_rotations"):
                assert getattr(tm.stats.layer(l), key) == getattr(jm.stats.layer(l), key), key
    assert tm.stats.bytes_uploaded == jm.stats.bytes_uploaded
    # the all-zero window recorded nothing: 3 windows' accepted positions
    assert tm.stats.hits + tm.stats.misses == 2 * 2 * (8 + 0 + 5 + 16)


# ===========================================================================
# the engine against JAX's ServingEngine
# ===========================================================================
REGIMES = {
    "full": (None, {}),
    "rotary_hi": (dict(mode="rotary", num_slots=8), {}),
    "rotary_3q": (dict(mode="rotary", num_slots=6), {}),
    "int4": (dict(mode="rotary", num_slots=6, quantization="int4", quant_group_size=16), {}),
    "sampled": (None, dict(sampler=dict(temperature=0.8, top_k=20, top_p=0.95, seed=3))),
    "prefetch": (dict(mode="rotary", num_slots=6), dict(prefetch=True)),
}
JAX_REGIMES = list(REGIMES)
REGIMES.update({f"{name}{slots}": (dict(mode="rotary", num_slots=slots), kw)
                for slots in (8, 5) for name, kw in (("sync", {}), ("pf", dict(prefetch=True)))})
COUNTERS = ("windows", "spec_windows", "misses", "kv_pages_allocated", "kv_pages_released",
            "kv_pages_hwm", "steps", "tokens", "drafted_tokens", "accepted_tokens")


def _serve(pkg, regime, prompts, *, num_slots=3, seeds=SEEDS, warm=False, **extra):
    cfg, params, tcfg, np_params = _setup()
    res, kw = REGIMES[regime]
    kw = {**kw, **extra}
    smp = kw.pop("sampler", None)
    if pkg == "jax":
        eng = JServing(cfg, params, rt=JRuntime(cache_len=32), num_slots=num_slots,
                       residency=JRes(**res) if res else None, spec_cap=4,
                       sampler=JSampler(**smp) if smp else None, **kw)
    else:
        eng = TServing(tcfg, _port_params(), rt=TRuntime(cache_len=32), num_slots=num_slots,
                       residency=TRes(**res) if res else None, spec_cap=4,
                       sampler=TSampler(**smp) if smp else None, device="cpu", **kw)
        if warm:
            eng.warmup()
    reqs = [eng.submit(p, max_new=MAX_NEW, seed=s) for p, s in zip(prompts, seeds)]
    eng.run()
    return eng, [r.output for r in reqs]


_PORT = {}


def _port_params():
    if not _PORT:
        _, _, tcfg, np_params = _setup()
        _PORT["p"] = from_reference(tcfg, np_params)
    return _PORT["p"]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ServingEngine in every regime, run once for the module."""
    cfg = _setup()[0]
    prompts = _prompts(cfg.vocab_size)
    return {r: _serve("jax", r, prompts) for r in JAX_REGIMES}


@pytest.mark.parametrize("regime", JAX_REGIMES)
def test_serving_engine_equals_jax(regime, jax_runs):
    cfg = _setup()[0]
    prompts = _prompts(cfg.vocab_size)
    je, jout = jax_runs[regime]
    te, tout = _serve("torch", regime, prompts)
    assert tout == jout
    for key in COUNTERS:
        assert getattr(te.stats, key) == getattr(je.stats, key), key
    assert te.stats.windows > 0 and te.stats.spec_windows > 0
    assert te.stats.kv_pages_released == te.stats.kv_pages_allocated > 0
    if regime in ("rotary_3q", "int4", "prefetch"):
        assert te.stats.misses > 0 and te.stats.accepted_tokens < te.stats.drafted_tokens
    if regime in ("full", "rotary_hi"):
        assert te.stats.misses == 0


@pytest.mark.parametrize("regime", ["full", "rotary_hi", "sampled"])
def test_concurrent_equals_isolated(regime):
    """Concurrent requests over the paged windows emit each request's tokens
    alone (one row): the streams depend on the request, not its neighbours
    (miss-free regimes; the residency trajectory is then request-free)."""
    prompts = _prompts(_setup()[0].vocab_size)
    _, outs = _serve("torch", regime, prompts)
    for i, p in enumerate(prompts):
        _, alone = _serve("torch", regime, [p], num_slots=1, seeds=[SEEDS[i]])
        assert outs[i] == alone[0], (regime, i)
    if regime == "sampled":
        assert _serve("torch", regime, prompts)[1] == outs     # a seed reproduces its stream


@pytest.mark.parametrize("slots", [8, 5])
def test_prefetch_equals_sync(slots):
    """``prefetch=True`` (shadow uploads under the in-flight window, margin
    0) emits the synchronous engine's tokens with the same transitions."""
    prompts = _prompts(_setup()[0].vocab_size)
    se, sync = _serve("torch", f"sync{slots}", prompts)
    pe, pf = _serve("torch", f"pf{slots}", prompts)
    assert pf == sync
    for key in ("misses", "hits", "bytes_loaded"):
        assert getattr(pe.stats, key) == getattr(se.stats, key), key


def test_warmup_and_page_recycling_change_no_output():
    """``warmup()`` captures nothing on the CPU and writes only the scratch
    page; a pool of 10 pages (fewer than the population needs at once)
    queues requests into just-freed pages; neither changes a token."""
    prompts = _prompts(_setup()[0].vocab_size) + [np.arange(3, 17, dtype=np.int32)]
    seeds = SEEDS + [44]
    _, ref = _serve("torch", "rotary_3q", prompts, seeds=seeds)
    te, warm = _serve("torch", "rotary_3q", prompts, seeds=seeds, warm=True)
    assert warm == ref
    small, tight = _serve("torch", "full", prompts, seeds=seeds, kv_pages=10, kv_page_size=4)
    _, roomy = _serve("torch", "full", prompts, seeds=seeds, kv_page_size=4)
    assert tight == roomy
    assert small.stats.kv_pages_hwm <= 10
    assert small.stats.kv_pages_released == small.stats.kv_pages_allocated > 0


def test_summary_and_request_lifecycle():
    te, _ = _serve("torch", "full", _prompts(_setup()[0].vocab_size))
    for r in te.scheduler.completed:
        assert r.submitted_at <= r.admitted_at <= r.first_token_at <= r.finished_at
        assert len(r.token_times) == len(r.output) == MAX_NEW
    summ = te.summary()
    assert summ["completed"] == 3 and summ["ttft_p99_ms"] >= summ["ttft_p50_ms"] >= 0.0
    assert "engine_windows" in te.metrics_registry().exposition()


def test_flag_rules_raise_before_building():
    _, _, tcfg, _ = _setup()
    params = _port_params()
    rt = TRuntime(cache_len=32)
    with pytest.raises(ValueError, match="paged continuous-batching"):
        TServing(tcfg, params, rt=rt, paged=False, prefetch=True,
                 residency=TRes(mode="rotary", num_slots=6), device="cpu")
    with pytest.raises(ValueError, match="rotating"):
        TServing(tcfg, params, rt=rt, prefetch=True, device="cpu")
    with pytest.raises(ValueError, match="reactive"):
        TServing(tcfg, params, rt=rt, residency=TRes(mode="lru", num_slots=8), prefetch=True,
                 device="cpu")
    with pytest.raises(ValueError, match="one full row"):
        TServing(tcfg, params, rt=rt, kv_pages=1, device="cpu")
    eng = TServing(tcfg, params, rt=rt, num_slots=2, device="cpu")
    with pytest.raises(ValueError, match="KV capacity"):
        eng.submit(np.arange(40), max_new=4)
    r = eng.submit(np.arange(8), max_new=10_000, deadline_s=1e-3)
    assert r.done and r.truncated and "infeasible" in r.reject_reason


def test_serve_cli_batch_engine_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen36-35b-a3b", "--engine", "batch",
                                      "--device", "cpu", "--requests", "3", "--max-new", "4",
                                      "--prompt-len", "20", "--cache-len", "64",
                                      "--batch-slots", "2", "--slots", "6", "--warmup"])
    serve.main()
    out = capsys.readouterr().out
    assert len(re.findall(r"req \d: prompt_len=\d+ -> \[(\d+, ){3}\d+\]", out)) == 3
    assert re.search(r"'windows': [1-9]", out) and "ttft_p99_ms" in out
