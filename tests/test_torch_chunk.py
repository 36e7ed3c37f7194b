"""The port's chunked prefill (``prefill_chunk=C``) against the JAX package's.

Model level, on reduced f32 ``qwen36-35b-a3b`` with the reference's weights
(``bridge.from_reference``) and numpy inputs from a seed: the chunk plan,
``attention_prefill_chunk`` (the plain version of K4's chunk-append entry,
and the ring semantics across a wrap), the plain version of K1's ragged
entry against the reference's ``slot_gmm`` oracle in bf16, int8 and int4,
and ``prefill_chunk_model`` over two chunks, to f32 1e-5 (1e-4 for logits
through the stack: XLA and PyTorch sum in other orders), routing ids exact.

Engine level, batch 2, ``cache_len`` 64, a 21-token prompt (plan [8, 8, 4,
1]): the fused chunk path and the chunked walk against the JAX engine's at
full residency and at 6 and 3 of 8 slots (suffix replays), int8 and int4
slots and ``prefetch=True``: the prefill logits to 1e-4, the greedy
continuation (a divergence only at a top-2 margin under 1e-3) and, where
the tokens agree, ``prefill_chunks``, ``prefill_replays``, misses, loads,
pulls and the other counters equal. A 40-token prompt in chunks of 32 runs
the chunk's MoE half through the ragged grouping (T*k > 64). Port-internal:
the fused chunk path and the walk give bitwise-equal logits and KV, and the
flag rules (a chunk length that is not a power of two raises, a prompt over
the capacity takes the legacy walk, a windowed cache takes the walk).
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
from repro.core import RotaryEngine as JEngine
from repro.core.engine import prefill_chunk_plan as jplan
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.models.transformer import Runtime as JRuntime
from repro.quant import quantize_int4_batch as jq4
from repro.core.slots import quantize_int8_batch as jq8
from repro_torch.bridge import from_reference
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.core.engine import RotaryEngine as TEngine
from repro_torch.core.engine import prefill_chunk_plan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import Runtime as TRuntime
from test_torch_walk import _agree, _setup, counters

TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=1e-4)
CACHE = 64


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["segments"][0][0])


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
def test_prefill_chunk_plan_matches_the_reference():
    assert prefill_chunk_plan(21, 8) == [8, 8, 4, 1]
    assert prefill_chunk_plan(64, 16) == [16, 16, 16, 16]
    assert prefill_chunk_plan(1, 64) == [1]
    assert prefill_chunk_plan(509, 128) == [128, 128, 128, 64, 32, 16, 8, 4, 1]
    for s in (1, 7, 16, 21, 100, 257, 512):
        for c in (1, 4, 32, 128):
            plan = prefill_chunk_plan(s, c)
            assert plan == jplan(s, c)
            assert sum(plan) == s and all(p & (p - 1) == 0 and p <= c for p in plan)
    for bad in ((8, 6), (0, 8)):
        with pytest.raises(ValueError):
            prefill_chunk_plan(*bad)


# ---------------------------------------------------------------------------
# attention_prefill_chunk and K4's chunk plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cur_len", [0, 5])
@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("window,soft_cap", [(None, None), (None, 3.0), (8, None), (8, 3.0)])
def test_attention_prefill_chunk_matches_jax(cur_len, c, window, soft_cap):
    """A chunk appended to a cache already holding ``cur_len`` positions
    (random K/V at those slots): output and post-write cache. A window of 8
    makes the cache a ring of 8 slots, and ``cur_len`` 5 with 8 queries
    wraps it (the CPU's ring semantics). Where the chunk does not wrap,
    K4's chunk plain version on the post-write cache gives the same
    output."""
    cfg, params, tcfg, np_params = _setup()
    tparams = from_reference(tcfg, np_params)
    acfg = dataclasses.replace(cfg.attention, window=window, logit_soft_cap=soft_cap)
    tacfg = dataclasses.replace(tcfg.attention, window=window, logit_soft_cap=soft_cap)
    pj, pt = _layer0(params)["attn"], tparams["layers"][0]["attn"]
    cap = 16 if window is None else window
    shape = (2, cap, acfg.num_kv_heads, acfg.head_dim)
    k0, v0 = _x(shape, 1), _x(shape, 2)
    written = np.arange(cap) < cur_len                  # slots 0 .. cur_len - 1 hold positions
    k0[:, ~written] = 0
    v0[:, ~written] = 0
    x = _x((2, c, cfg.d_model), 3)
    yj, cj = jax.jit(jattn.attention_prefill_chunk, static_argnums=1)(
        pj, acfg, jnp.asarray(x), {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.int32(cur_len))
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    yt = tattn.attention_prefill_chunk(pt, tacfg, torch.from_numpy(x), cache, cur_len)
    _close(yt, yj)
    _close(cache["k"], cj["k"])
    _close(cache["v"], cj["v"])
    if cur_len + c <= cap:                              # K4's case: slot == position
        q, _, _ = tattn._project_qkv(pt, tacfg, torch.from_numpy(x),
                                     torch.arange(cur_len, cur_len + c)[None, :])
        ctx = tref.flash_attention_chunk_ref(q, cache["k"], cache["v"], cur_len,
                                             window=window, soft_cap=soft_cap)
        _close(ctx.reshape(2, c, -1) @ pt["wo"], yj)
        ctx_ops = ops.flash_attention_chunk(q, cache["k"], cache["v"], torch.tensor(cur_len),
                                            window=window, soft_cap=soft_cap)
        assert torch.equal(ctx_ops, ctx)


def test_attention_prefill_chunk_refuses_a_chunk_over_capacity():
    _, _, tcfg, np_params = _setup()
    pt = from_reference(tcfg, np_params)["layers"][0]["attn"]
    cache = tattn.zero_cache(tcfg.attention, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="exceeds KV capacity"):
        tattn.attention_prefill_chunk(pt, tcfg.attention, torch.zeros(1, 5, tcfg.d_model),
                                      cache, 0)


# ---------------------------------------------------------------------------
# K1's ragged plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_slot_gmm_ragged_ref_matches_the_reference_oracle(fmt):
    """Rows sorted by slot with per-slot offsets (a slot with no rows, the
    MISS row last) against the reference's ``slot_gmm`` oracle fed the same
    rows one group per slot; MISS rows are zeros, and with ``miss_slot``
    None the last row computes like any other."""
    d, f, s1 = 64, 48, 6
    w = _x((s1, d, f), 4) * 0.1
    w[s1 - 1] = 0
    counts = np.array([3, 0, 5, 1, 4, 2])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    x = _x((int(counts.sum()), d), 5)
    if fmt == "bf16":
        planes_j = (jnp.asarray(w, jnp.bfloat16), None, None)
        planes_t = (torch.from_numpy(w).to(torch.bfloat16), None, None)
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        q = jq8(w) if fmt == "int8" else jq4(w, 16)
        q = tuple(np.asarray(a) for a in q) + (None,) * (3 - len(q))
        planes_j = tuple(None if a is None else jnp.asarray(a) for a in q)
        planes_t = tuple(None if a is None else torch.from_numpy(a) for a in q)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    got = tref.slot_gmm_ragged_ref(xt, planes_t[0], torch.from_numpy(offsets), *planes_t[1:],
                                   miss_slot=s1 - 1)
    got_all = tref.slot_gmm_ragged_ref(xt, planes_t[0], torch.from_numpy(offsets),
                                       *planes_t[1:])
    for s in range(s1):
        a, b = offsets[s], offsets[s + 1]
        if a == b:
            continue
        want = jref.slot_gmm_ref(xj[None, a:b], planes_j[0], jnp.asarray([s], jnp.int32),
                                 *planes_j[1:])[0]
        tol = TOL if fmt != "bf16" else dict(atol=2e-2, rtol=2e-2)
        _close(got_all[a:b], want, tol)
        if s == s1 - 1:
            assert not got[a:b].abs().sum()
        else:
            _close(got[a:b], want, tol)


# ---------------------------------------------------------------------------
# prefill_chunk_model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunks", [(8, 4), (40, 1)])
def test_prefill_chunk_model_matches_jax(chunks):
    """Two chunks appended in turn to a zero state, full expert store: the
    last position's logits, the telemetry and the caches. A 40-token chunk
    (80 picks a row pair) takes the ragged grouping."""
    cfg, params, tcfg, np_params = _setup()
    tparams = from_reference(tcfg, np_params)
    rt = JRuntime(cache_len=CACHE)
    jstate = jtfm.zero_state(cfg, 2, CACHE)
    tstate = ttfm.zero_state(tcfg, 2, CACHE, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, sum(chunks))).astype(np.int32)
    step = jax.jit(jtfm.prefill_chunk_model, static_argnums=(0, 5, 7))
    cur = 0
    for i, c in enumerate(chunks):
        head = i == len(chunks) - 1
        lj, jstate, aux = step(cfg, params, jnp.asarray(toks[:, cur:cur + c]), jstate,
                               jnp.int32(cur), rt, None, head)
        lt, taux = ttfm.prefill_chunk_model(tcfg, tparams, torch.from_numpy(toks[:, cur:cur + c]),
                                            tstate, cur, with_head=head)
        assert (lt is None) == (not head)
        if head:
            _close(lt, lj, LOGITS)
        np.testing.assert_array_equal(taux["route_ids"].numpy(),
                                      np.asarray(aux["route_ids/seg0"]))
        _close(taux["route_weights"], aux["route_weights/seg0"], LOGITS)
        _close(taux["route_x"], aux["route_x/seg0"], LOGITS)
        cur += c
    for li, st in enumerate(tstate):
        _close(st["k"], jstate[0][0]["k"][li], LOGITS)
        _close(st["v"], jstate[0][0]["v"][li], LOGITS)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _kw(slots, quant):
    return dict(mode="full" if slots == 0 else "rotary", num_slots=slots, prefetch_margin=1,
                **quant)


def _generate(engine, prompt, steps=6):
    """Prefill logits, then greedy tokens one decode call each and the
    logits that chose them."""
    logits = [np.asarray(engine.prefill(prompt), np.float32)]
    toks = []
    for _ in range(steps):
        toks.append(engine.decode(logits[-1], 1)[:, 0])
        logits.append(np.asarray(engine.last_logits, np.float32))
    return np.stack(toks, 1), np.stack(logits[:-1], 1)


def _chunk_counters(stats):
    return dict(counters(stats), prefill_chunks=stats.prefill_chunks,
                prefill_replays=stats.prefill_replays)


CASES = [(p, s, q, pf) for p in ("fused", "walk") for s, q, pf in (
    (0, {}, False), (6, {}, False), (3, {}, False), (3, dict(quantization="int8"), False),
    (3, dict(quantization="int4", quant_group_size=16), False))] + [
    ("fused", 6, {}, True), ("fused", 3, {}, True)]


@pytest.mark.parametrize("path,slots,quant,prefetch", CASES)
def test_chunked_engine_port_equals_jax(path, slots, quant, prefetch):
    cfg, params, tcfg, np_params = _setup()
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    kw = _kw(slots, quant)
    flags = dict(fused_decode=False) if path == "walk" else {}
    je = JEngine(cfg, params, JRes(**kw), rt=JRuntime(cache_len=CACHE), batch=2,
                 prefill_chunk=8, prefetch=prefetch, **flags)
    te = TEngine(tcfg, from_reference(tcfg, np_params), TRes(**kw),
                 rt=TRuntime(cache_len=CACHE), batch=2, device="cpu", prefill_chunk=8,
                 prefetch=prefetch, **flags)
    assert te._fused_decode == (path == "fused") == je._fused_decode
    jt, jl = _generate(je, prompt)
    tt, tl = _generate(te, prompt)
    if not _agree(jt, jl, tt, tl):
        assert _chunk_counters(te.stats) == _chunk_counters(je.stats)
        for key in ("prefetch_launched", "prefetch_hits", "prefetch_wasted_bytes"):
            assert getattr(te.stats, key) == getattr(je.stats, key), key
    s = te.stats
    assert s.prefill_chunks == 4 and sum(l.host_computed for l in s.layers.values()) == s.misses
    if slots == 3 and path == "fused":
        assert s.prefill_replays > 0


@pytest.mark.parametrize("slots", [0, 3])
def test_chunked_engine_ragged_chunks_port_equals_jax(slots):
    """Chunks of 32 tokens at batch 2 route 128 picks a layer: the ragged
    grouping inside the fused chunk and the walk."""
    cfg, params, tcfg, np_params = _setup()
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    for flags in ({}, dict(fused_decode=False)):
        je = JEngine(cfg, params, JRes(**_kw(slots, {})), rt=JRuntime(cache_len=CACHE),
                     batch=2, prefill_chunk=32, **flags)
        te = TEngine(tcfg, from_reference(tcfg, np_params), TRes(**_kw(slots, {})),
                     rt=TRuntime(cache_len=CACHE), batch=2, device="cpu", prefill_chunk=32,
                     **flags)
        jt, jl = _generate(je, prompt, 4)
        tt, tl = _generate(te, prompt, 4)
        if not _agree(jt, jl, tt, tl):
            assert _chunk_counters(te.stats) == _chunk_counters(je.stats)
        assert te.stats.prefill_chunks == 2


@pytest.mark.parametrize("slots,quant,prefetch", [
    (0, {}, False), (6, {}, False), (3, {}, False), (3, {}, True),
    (3, dict(quantization="int8"), False),
    (3, dict(quantization="int4", quant_group_size=16), False)])
def test_fused_chunks_equal_the_chunked_walk_bitwise(slots, quant, prefetch):
    """The fused chunk path (one launch per chunk, suffix replays) and the
    chunked layer walk: prefill logits and every post-prefill cache, bit
    for bit, then the same greedy continuation."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    prompt = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 21)).astype(np.int32)

    def mk(**flags):
        return TEngine(tcfg, params, TRes(**_kw(slots, quant)), rt=TRuntime(cache_len=CACHE),
                       batch=2, device="cpu", prefill_chunk=8, **flags)

    fused, walk = mk(prefetch=prefetch), mk(fused_decode=False)
    lf, lw = fused.prefill(prompt), walk.prefill(prompt)
    assert lf.tobytes() == lw.tobytes()
    for a, b in zip(fused.state, walk.state):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    np.testing.assert_array_equal(fused.decode(lf, 5), walk.decode(lw, 5))
    if slots == 3 and not prefetch:
        assert fused.stats.prefill_replays > 0 and fused.stats.misses > 0


def test_chunk_flag_rules():
    """A chunk length that is not a power of two raises; a prompt longer than
    the cache capacity takes the legacy walk; a windowed cache takes the
    chunked walk (the fused chunk path needs a window-free cache), and a
    miss-free fused chunk makes one launch and one blocking pull."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    res = TRes(mode="full")
    for bad in (6, 0, 3):
        with pytest.raises(ValueError, match="power of two"):
            TEngine(tcfg, params, res, rt=TRuntime(cache_len=CACHE), device="cpu",
                    prefill_chunk=bad)
    eng = TEngine(tcfg, params, res, rt=TRuntime(cache_len=16), batch=1, device="cpu",
                  prefill_chunk=8)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.prefill(np.zeros((1, 17), np.int32))
    pulls0 = eng.stats.sync_pulls
    eng.prefill(np.zeros((1, 13), np.int32))        # [8, 4, 1]
    assert eng.stats.prefill_chunks == 3 and eng.launches == 3
    assert eng.stats.sync_pulls - pulls0 == 3 and eng.stats.prefill_replays == 0
    wcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(tcfg.attention, window=8))
    weng = TEngine(wcfg, params, res, rt=TRuntime(cache_len=CACHE), batch=1, device="cpu",
                   prefill_chunk=4)
    assert weng._fused_decode and not weng._chunk_prefill_fused_ok
    weng.prefill(np.zeros((1, 6), np.int32))        # within the ring's 8 slots: the walk
    assert weng.stats.prefill_chunks == 2 and weng.launches == 0
    weng.prefill(np.zeros((1, 12), np.int32))       # past the ring: the legacy walk
    assert weng.stats.prefill_chunks == 2


def test_chunk_graph_refuses_a_wrapping_chunk():
    """The engine checks on the host that no chunk wraps the cache before
    each launch (K4's chunk entry scores slots as positions)."""
    _, _, tcfg, np_params = _setup()
    eng = TEngine(tcfg, from_reference(tcfg, np_params), TRes(mode="full"),
                  rt=TRuntime(cache_len=16), batch=1, device="cpu", prefill_chunk=8)
    with pytest.raises(RuntimeError, match="wrap"):
        eng._check_no_wrap(12, 8)
    eng._check_no_wrap(8, 8)


def test_serve_cli_runs_chunked_prefill_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen36-35b-a3b", "--device", "cpu",
                                      "--requests", "1", "--max-new", "4", "--slots", "4",
                                      "--layers", "2", "--prompt-len", "13",
                                      "--prefill-chunk", "4"])
    serve.main()
    out = capsys.readouterr().out
    assert re.search(r"req 0: \[(\d+, ){3}\d+\]", out)
    assert re.search(r"'prefill_chunks': 4", out)
