"""The port's per-layer decode walks against the JAX engine's: the hot walk
(``fused_decode=False``), the sync walk with host routing
(``host_routing=True``) and LRU residency (the sync walk with blocking
loads).

Cross-framework, on reduced f32 ``qwen36-35b-a3b`` with the same weights
(``bridge.from_reference``), batch 2, ``cache_len`` 32: each walk emits the
JAX engine's greedy tokens at full residency (LRU: all 8 slots) and at 6
and 3 of 8 slots, and with int4 slots in groups of 16; where the tokens do
not diverge, the pulls, misses, loads, uploaded bytes, host-computed
experts and replayed steps equal JAX's. Logits agree to 1e-4 (XLA and
PyTorch sum in other orders) and a greedy id may differ only at a step
whose top-2 margin is below 1e-3. Port-internal: every walk gives the fused
step's tokens (and full residency's); a hot-walk step that replays from
layer 0 gathers layer 0 from the residency the walk read, with the
reference's counters; the flag rules; the serve CLI with the new flags.
"""
import dataclasses
import re
import sys

import jax
import numpy as np
import pytest

from repro.config import ResidencyConfig as JRes
from repro.config import get_config
from repro.configs import reduce_for_smoke
from repro.core import RotaryEngine as JEngine
from repro.models import init_params
from repro.models.transformer import Runtime as JRuntime
from repro_torch.bridge import from_reference
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.config import get_config as tget
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.engine import RotaryEngine as TEngine
from repro_torch.models.transformer import Runtime as TRuntime

STEPS = 8
_CACHE = {}


def _setup():
    """(jax cfg, jax params, port cfg, port params as numpy), f32, cached."""
    if not _CACHE:
        cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
        tcfg = dataclasses.replace(treduce(tget("qwen36-35b-a3b")), dtype="float32")
        params = jax.jit(init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        _CACHE["qwen36"] = (cfg, params, tcfg, jax.tree.map(np.asarray, params))
    return _CACHE["qwen36"]


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


def counters(stats):
    """The counters held equal to the reference's."""
    layers = stats.layers.values()
    return dict(
        sync_pulls=stats.sync_pulls, overlapped_pulls=stats.overlapped_pulls,
        misses=stats.misses, loads=sum(l.loads for l in layers),
        bytes_uploaded=stats.bytes_uploaded,
        host_computed=sum(l.host_computed for l in layers),
        replayed_steps=stats.replayed_steps, relaunched_steps=stats.relaunched_steps,
        spec_windows=stats.spec_windows, drafted_tokens=stats.drafted_tokens,
        accepted_tokens=stats.accepted_tokens)


PATHS = {"hot": dict(fused_decode=False), "hostroute": dict(host_routing=True), "lru": {}}


def _rescfg(path, slots, quant):
    if path == "lru":
        return dict(mode="lru", num_slots=slots or 8, prefetch_margin=1, **quant)
    return dict(mode="full" if slots == 0 else "rotary", num_slots=slots, prefetch_margin=1,
                **quant)


@pytest.mark.parametrize("path,slots,quant", [
    (p, s, {}) for p in PATHS for s in (0, 6, 3)
] + [("hot", 3, dict(quantization="int4", quant_group_size=16))])
def test_walk_port_equals_jax(path, slots, quant):
    cfg, params, tcfg, np_params = _setup()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    kw = _rescfg(path, slots, quant)
    je = JEngine(cfg, params, JRes(**kw), rt=JRuntime(cache_len=32), batch=2, **PATHS[path])
    te = TEngine(tcfg, from_reference(tcfg, np_params), TRes(**kw), rt=TRuntime(cache_len=32),
                 batch=2, device="cpu", **PATHS[path])
    assert not te._fused_decode and te._hot_decode == (path == "hot") == je._hot_decode
    jt, jl = _steps(je, prompt)
    tt, tl = _steps(te, prompt)
    if not _agree(jt, jl, tt, tl):
        assert counters(te.stats) == counters(je.stats)
    s = te.stats
    assert sum(l.host_computed for l in s.layers.values()) == s.misses
    if path == "hot":
        assert s.overlapped_pulls == 4 * tcfg.num_layers * STEPS
        if slots == 3:
            assert s.misses > 0
    if path == "lru" and slots:
        assert sum(l.loads for l in s.layers.values()) > 0


def test_every_walk_gives_the_fused_steps_tokens():
    """Hot walk == fused step == host routing == LRU == full residency,
    token for token, at 3 of 8 slots (misses everywhere)."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    rt = TRuntime(cache_len=32)
    rot = TRes(mode="rotary", num_slots=3, prefetch_margin=1)
    engines = {
        "full": TEngine(tcfg, params, TRes(mode="full"), rt=rt, batch=2, device="cpu"),
        "fused": TEngine(tcfg, params, rot, rt=rt, batch=2, device="cpu"),
        "hot": TEngine(tcfg, params, rot, rt=rt, batch=2, device="cpu", fused_decode=False),
        "hostroute": TEngine(tcfg, params, rot, rt=rt, batch=2, device="cpu",
                             host_routing=True),
        "lru": TEngine(tcfg, params, TRes(mode="lru", num_slots=3, prefetch_margin=1), rt=rt,
                       batch=2, device="cpu"),
    }
    toks = {name: eng.generate(prompt, 10) for name, eng in engines.items()}
    for name, t in toks.items():
        np.testing.assert_array_equal(t, toks["full"], err_msg=name)
    assert engines["fused"]._fused_decode and not engines["hot"]._fused_decode
    assert engines["hot"].stats.misses > 0 and engines["hostroute"].stats.misses > 0
    # LRU answers misses with loads; host routing and the hot walk correct them
    assert sum(l.loads for l in engines["lru"].stats.layers.values()) > 0


def test_hot_walk_replay_from_layer_0_gathers_what_the_walk_read():
    """At 3 of 8 slots some hot-walk step misses in layer 0 and replays from
    it; the replay must gather layer 0 from the residency the walk read,
    not from the last layer's pre-gating of layer 0 (which runs after the
    pull and any replay). Tokens, logits and counters equal the reference's
    (which gathers from per-layer snapshots), and layer 0's residency still
    rotates as the reference's does."""
    cfg, params, tcfg, np_params = _setup()
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    kw = dict(mode="rotary", num_slots=3, prefetch_margin=1)
    je = JEngine(cfg, params, JRes(**kw), rt=JRuntime(cache_len=32), batch=2,
                 fused_decode=False)
    te = TEngine(tcfg, from_reference(tcfg, np_params), TRes(**kw), rt=TRuntime(cache_len=32),
                 batch=2, device="cpu", fused_decode=False)
    starts = []
    replay = te._replay_step

    def spy(x0, start, *a):
        starts.append(start)
        return replay(x0, start, *a)

    te._replay_step = spy
    jt, jl = _steps(je, prompt, 10)
    tt, tl = _steps(te, prompt, 10)
    assert 0 in starts
    assert not _agree(jt, jl, tt, tl)
    assert counters(te.stats) == counters(je.stats)
    for jp, tp in zip(je.manager.policies, te.manager.policies):
        np.testing.assert_array_equal(jp.lut.e2s, tp.lut.e2s)


def test_walk_flag_rules():
    """The reference's rules (``tests/test_fused_decode.py``): fused decode
    needs device routing and a policy that resolves no miss mid-step;
    prefetch needs the fused step; host routing and LRU take the sync walk,
    ``fused_decode=False`` the hot walk."""
    _, _, tcfg, np_params = _setup()
    params = from_reference(tcfg, np_params)
    rt = TRuntime(cache_len=32)
    rot, lru = TRes(mode="rotary", num_slots=5), TRes(mode="lru", num_slots=5)
    with pytest.raises(ValueError, match="fused decode requires device routing"):
        TEngine(tcfg, params, lru, rt=rt, device="cpu", fused_decode=True)
    with pytest.raises(ValueError, match="fused decode requires device routing"):
        TEngine(tcfg, params, rot, rt=rt, device="cpu", host_routing=True, fused_decode=True)
    with pytest.raises(ValueError, match="host_routing"):
        TEngine(tcfg, params, rot, rt=rt, device="cpu", host_routing=True, prefetch=True)
    with pytest.raises(ValueError, match="fused"):
        TEngine(tcfg, params, rot, rt=rt, device="cpu", fused_decode=False, prefetch=True)
    hot = TEngine(tcfg, params, rot, rt=rt, device="cpu", fused_decode=False)
    sync = TEngine(tcfg, params, rot, rt=rt, device="cpu", host_routing=True)
    assert hot._hot_decode and not hot._fused_decode
    assert not sync._hot_decode and not sync._fused_decode


@pytest.mark.parametrize("flags,want", [
    (["--host-routing"], "overlapped_pulls': 0"),
    (["--residency", "lru"], "overlapped_pulls': 0"),
    (["--no-fused-decode"], "overlapped_pulls': 32"),      # 4 a layer, 2 layers, 4 steps
])
def test_serve_cli_runs_each_walk_on_the_cpu(capsys, monkeypatch, flags, want):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen36-35b-a3b", "--device", "cpu",
                                      "--requests", "1", "--max-new", "4", "--slots", "4",
                                      "--layers", "2"] + flags)
    serve.main()
    out = capsys.readouterr().out
    assert re.search(r"req 0: \[\d+, \d+, \d+, \d+\]", out) and want in out
