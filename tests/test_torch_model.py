"""The port's model math against the JAX package on the same weights:
``_project_qkv``, ``attention_prefill``, ``attention_decode``,
``moe_apply_routed`` (MISS sentinel, shared experts, both groupings) and the
decode step over the whole stack, on reduced f32 ``qwen36-35b-a3b`` (GQA,
qk-norm, renormalized top-k) and ``qwen2-moe-a2.7b`` (MHA, shared experts,
raw top-k mass).

Weights come from ``repro.models.init_params`` through
``repro_torch.bridge.from_reference``; inputs are made with numpy from a
seed. Tolerance: 1e-5 absolute + 1e-5 relative on f32 (XLA and PyTorch sum
in different orders); routing ids exact. The reference functions run under
``jax.jit``: one compiled program each instead of one per primitive.
"""
import dataclasses
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config
from repro.configs import reduce_for_smoke
from repro.models import attention as jattn
from repro.models import init_params
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.bridge import from_reference
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("qwen36-35b-a3b", "qwen2-moe-a2.7b")
_CACHE = {}


def _setup(arch):
    """(jax cfg, jax params, port cfg, port params), f32, cached per module."""
    if arch not in _CACHE:
        from repro_torch.config import get_config as tget
        from repro_torch.configs import reduce_for_smoke as treduce

        cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), dtype="float32")
        tcfg = dataclasses.replace(treduce(tget(arch)), dtype="float32")
        params = jax.jit(init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        tparams = from_reference(tcfg, jax.tree.map(np.asarray, params))
        _CACHE[arch] = (cfg, params, tcfg, tparams)
    return _CACHE[arch]


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["segments"][0][0])


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_project_qkv_matches_jax(arch):
    cfg, params, tcfg, tparams = _setup(arch)
    x = _x((2, 5, cfg.d_model), 0)
    pos = np.arange(3, 8)[None, :]
    want = jax.jit(jattn._project_qkv, static_argnums=1)(
        _layer0(params)["attn"], cfg.attention, jnp.asarray(x), jnp.asarray(pos))
    got = tattn._project_qkv(tparams["layers"][0]["attn"], tcfg.attention,
                             torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch,window,soft_cap", [
    ("qwen36-35b-a3b", None, None), ("qwen2-moe-a2.7b", None, None),
    ("qwen36-35b-a3b", 4, 3.0),            # ring cache (prompt longer than the window)
])
def test_attention_prefill_and_decode_match_jax(arch, window, soft_cap):
    """Prefill (K4 plain path) and three decode steps (KV written at
    ``cur_len % cap`` before scoring, K2 plain path; a windowed cache takes
    the ring masks) against the reference."""
    cfg, params, tcfg, tparams = _setup(arch)
    acfg = dataclasses.replace(cfg.attention, window=window, logit_soft_cap=soft_cap)
    tacfg = dataclasses.replace(tcfg.attention, window=window, logit_soft_cap=soft_cap)
    pj, pt = _layer0(params)["attn"], tparams["layers"][0]["attn"]
    x = _x((2, 6, cfg.d_model), 1)
    yj, cache_j = jax.jit(jattn.attention_prefill, static_argnums=(1, 3))(
        pj, acfg, jnp.asarray(x), 16)
    yt, cache_t = tattn.attention_prefill(pt, tacfg, torch.from_numpy(x), 16)
    _close(yt, yj)
    _close(cache_t["k"], cache_j["k"])
    _close(cache_t["v"], cache_j["v"])
    decode = jax.jit(jattn.attention_decode, static_argnums=1)
    for step in range(3):
        xd = _x((2, 1, cfg.d_model), 10 + step)
        yj, cache_j = decode(pj, acfg, jnp.asarray(xd), cache_j, jnp.int32(6 + step))
        yt = tattn.attention_decode(pt, tacfg, torch.from_numpy(xd), cache_t, 6 + step)
        _close(yt, yj)
        _close(cache_t["k"], cache_j["k"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [3, 40])
def test_moe_apply_routed_matches_jax_with_misses(arch, tokens):
    """Slot store with the zero MISS slot last and half the experts resident;
    3 tokens take the per-pick grouping, 40 the by-slot grouping."""
    cfg, params, tcfg, tparams = _setup(arch)
    pj, pt = _layer0(params)["moe"], tparams["layers"][0]["moe"]
    x = _x((tokens, cfg.d_model), 2)
    logits = jax.jit(jmoe.router_logits)(pj, jnp.asarray(x))
    ids, w, _ = jax.jit(jmoe.topk_route, static_argnums=1)(logits, cfg.moe)
    apply_routed = jax.jit(jmoe.moe_apply_routed)
    tids, tw = tmoe.topk_route(tmoe.router_logits(pt, torch.from_numpy(x)), tcfg.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    _close(tw, w)
    e = cfg.moe.num_experts
    resident = np.arange(0, e, 2)                              # every other expert
    n_slots = len(resident)
    lut = np.full((e,), n_slots, np.int32)
    lut[resident] = np.arange(n_slots)
    slots_np = {
        n: np.concatenate([np.asarray(a)[resident], np.zeros_like(np.asarray(a)[:1])])
        for n, a in pj["experts"].items()
    }
    yj, miss_j = apply_routed(
        pj, jnp.asarray(x), ids, w, slot_buffer={n: jnp.asarray(a) for n, a in slots_np.items()},
        lut=jnp.asarray(lut))
    yt, miss_t = tmoe.moe_apply_routed(
        pt, torch.from_numpy(x), tids, tw,
        slot_buffer={n: torch.from_numpy(a) for n, a in slots_np.items()},
        lut=torch.from_numpy(lut).long())
    assert np.asarray(miss_j).any() and (~np.asarray(miss_j)).any()
    np.testing.assert_array_equal(miss_t.numpy(), np.asarray(miss_j))
    _close(yt, yj, dict(atol=2e-5, rtol=2e-5))
    # full store (no residency): no misses
    yj, _ = apply_routed(pj, jnp.asarray(x), ids, w)
    yt, miss_t = tmoe.moe_apply_routed(pt, torch.from_numpy(x), tids, tw)
    assert not miss_t.any()
    _close(yt, yj, dict(atol=2e-5, rtol=2e-5))
    if "shared" in pt:                                         # qwen2: shared experts
        no_shared, _ = tmoe.moe_apply_routed(pt, torch.from_numpy(x), tids, tw,
                                             include_shared=False)
        assert (yt - no_shared).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Prefill through the reference, then one decode step over the whole
    stack in both packages on the same KV state: logits and telemetry."""
    cfg, params, tcfg, tparams = _setup(arch)
    rt = jtfm.Runtime(cache_len=16)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    _, state = jax.jit(jtfm.prefill_model, static_argnums=(0, 3))(
        cfg, params, jnp.asarray(prompt), rt)
    tstate = []
    for si, (unit, reps) in enumerate(cfg.segments):
        for r in range(reps):
            st = state[si][0]
            tstate.append({n: torch.from_numpy(np.array(st[n][r])) for n in ("k", "v")})
    tok = np.array([7, 11], np.int32)
    lj, _, aux = jax.jit(jtfm.decode_model, static_argnums=(0, 5))(
        cfg, params, jnp.asarray(tok), state, jnp.int32(5), rt)
    lt, taux = ttfm.decode_model(tcfg, tparams, torch.from_numpy(tok), tstate, 5)
    _close(lt, lj, dict(atol=1e-4, rtol=1e-4))
    np.testing.assert_array_equal(taux["route_ids"].numpy(),
                                  np.asarray(aux["route_ids/seg0"]))
    _close(taux["route_x"], aux["route_x/seg0"], dict(atol=1e-4, rtol=1e-4))


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax_router_and_keeps_the_plain_bits(arch):
    """``moe.route`` (the one routing call of every engine site) against the
    reference's ``router_logits`` + ``topk_route`` on layer 0's router; on
    the CPU it gives the bits of ``topk_route(router_logits(...))``."""
    cfg, params, tcfg, tparams = _setup(arch)
    pj, pt = _layer0(params)["moe"], tparams["layers"][0]["moe"]
    x = _x((40, cfg.d_model), 4)
    logits = jax.jit(jmoe.router_logits)(pj, jnp.asarray(x))
    ids, w, _ = jax.jit(jmoe.topk_route, static_argnums=1)(logits, cfg.moe)
    tids, tw = tmoe.route(pt, torch.from_numpy(x), tcfg.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    _close(tw, w)
    pids, pw = tmoe.topk_route(tmoe.router_logits(pt, torch.from_numpy(x)), tcfg.moe)
    assert torch.equal(tids, pids) and torch.equal(tw, pw)


def test_fused_step_walk_and_replay_route_through_ops_router_topk(monkeypatch):
    """On a reduced qwen36 run with 3 of 8 slots (misses, so replays), every
    routing call goes through ``ops.router_topk``: L per prefill walk, L per
    fused decode step (``decode_model``'s layer loop, ``_run_stack``), one
    per replayed layer; the logits-in gate is never called on the engine's
    path."""
    from repro_torch.config import ResidencyConfig
    from repro_torch.core.engine import RotaryEngine
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Runtime

    _, _, tcfg, tparams = _setup("qwen36-35b-a3b")
    sites = Counter()
    plain = ops.router_topk

    def counted(*args, **kwargs):
        sites[sys._getframe(2).f_code.co_name] += 1        # the caller of moe.route
        return plain(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the engine called the logits-in gate")

    monkeypatch.setattr(ops, "router_topk", counted)
    monkeypatch.setattr(ops, "topk_gate", refused)
    eng = RotaryEngine(tcfg, tparams, ResidencyConfig(mode="rotary", num_slots=3,
                                                      prefetch_margin=1),
                       rt=Runtime(cache_len=32), batch=1, device="cpu")
    steps = 6
    eng.generate(np.arange(6, dtype=np.int32)[None], steps)
    n_layers = len(tparams["layers"])
    assert eng.stats.replayed_steps > 0
    assert sites["_run_layers"] == n_layers
    assert sites["_run_stack"] == n_layers * steps
    assert eng.stats.replayed_steps <= sites["_replay_fused"] <= eng.stats.replayed_steps * n_layers
    assert set(sites) == {"_run_layers", "_run_stack", "_replay_fused"}
