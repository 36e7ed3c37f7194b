"""The port's group tick (``ServingEngine(paged=False)``) and ``RotaryEngine``
over mixed stacks, against the JAX package.

Reduced f32 configs on the reference's weights (``bridge.from_reference``),
prompts made with numpy from a seed:

* ``recurrentgemma-2b`` (RG-LRU + local attention, window 16): the engine
  takes the group tick itself; three requests over two rows (the third
  queues), one prompt longer than the window: every request's tokens and
  the counters equal JAX's ``ServingEngine``, and each request served alone
  gives its concurrent tokens;
* ``qwen2-moe-a2.7b`` with ``paged=False`` at rotary residency (5 of 8
  slots, so steps miss and drop), greedy single steps and windows of up to
  4: tokens, counters and each layer's residency transitions and final LUT
  equal JAX's group tick;
* the flag rules: ``paged=True`` on a recurrent stack, ``prefetch`` without
  the paged pool, and a stack without attention raise before anything is
  built;
* ``RotaryEngine`` over a stack that mixes ``attn_mlp`` and ``attn_moe``
  layers, fused and walked, at full residency and at 5 of 8 slots: tokens,
  logits (1e-4) and misses equal JAX's.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.config import ResidencyConfig as JRes
from repro.config import get_config as jget
from repro.configs import reduce_for_smoke as jreduce
from repro.core import RotaryEngine as JEngine
from repro.models import init_params as jinit
from repro.models.transformer import Runtime as JRuntime
from repro.serving import ServingEngine as JServing
from repro_torch.bridge import from_reference
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.config import get_config as tget
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.engine import RotaryEngine as TEngine
from repro_torch.models.transformer import Runtime as TRuntime
from repro_torch.serving import ServingEngine as TServing

MAX_NEW = 8
COUNTERS = ("steps", "tokens", "windows", "spec_windows", "misses", "hits", "drafted_tokens",
            "accepted_tokens", "sync_pulls", "overlapped_pulls")
_CACHE = {}


def _setup(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _CACHE:
        cfg = dataclasses.replace(jreduce(jget(arch)), dtype="float32", **over)
        tcfg = dataclasses.replace(treduce(tget(arch)), dtype="float32", **over)
        params = jax.jit(jinit, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        _CACHE[key] = (cfg, params, tcfg, from_reference(tcfg, jax.tree.map(np.asarray, params)))
    return _CACHE[key]


def _prompts(vocab, lens):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(pkg, arch, prompts, *, num_slots=2, residency=None, **kw):
    cfg, params, tcfg, tparams = _setup(arch)
    if pkg == "jax":
        eng = JServing(cfg, params, rt=JRuntime(cache_len=32), num_slots=num_slots,
                       residency=JRes(**residency) if residency else None, **kw)
    else:
        eng = TServing(tcfg, tparams, rt=TRuntime(cache_len=32), num_slots=num_slots,
                       residency=TRes(**residency) if residency else None, device="cpu", **kw)
    reqs = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    eng.run()
    return eng, [r.output for r in reqs]


def _transitions(eng):
    mgr = eng.res_mgr
    return ([(s.loads, s.forward_rotations, s.reverse_rotations, s.bytes_loaded)
             for _, s in sorted(mgr.stats.layers.items())],
            [p.lut.s2e.tolist() for p in mgr.policies])


RG_LENS = (5, 20, 11)


@pytest.fixture(scope="module")
def jax_recurrent():
    cfg = _setup("recurrentgemma-2b")[0]
    return _serve("jax", "recurrentgemma-2b", _prompts(cfg.vocab_size, RG_LENS))


def test_recurrent_serving_equals_jax_and_alone(jax_recurrent):
    """recurrentgemma through the group tick (chosen by the engine): the
    same tokens and counters as JAX's ServingEngine; each request alone
    gives its concurrent tokens."""
    je, jout = jax_recurrent
    prompts = _prompts(je.cfg.vocab_size, RG_LENS)
    te, tout = _serve("torch", "recurrentgemma-2b", prompts)
    assert not te._paged and te.pool is None and not je._paged
    assert tout == jout
    for key in COUNTERS:
        assert getattr(te.stats, key) == getattr(je.stats, key), key
    for i, p in enumerate(prompts):
        assert _serve("torch", "recurrentgemma-2b", [p], num_slots=1)[1][0] == tout[i]


MOE_LENS = (5, 9, 12, 7)


@pytest.mark.parametrize("spec_cap", [1, 4])
def test_moe_group_tick_equals_jax(spec_cap):
    """qwen2-moe at 5 of 8 rotary slots through ``paged=False``: steps and
    windows miss (dropped in-step), windows roll back their rejected
    suffixes; tokens, counters, per-layer transitions and the final LUTs
    equal JAX's group tick."""
    cfg = _setup("qwen2-moe-a2.7b")[0]
    prompts = _prompts(cfg.vocab_size, MOE_LENS)
    res = dict(mode="rotary", num_slots=5)
    je, jout = _serve("jax", "qwen2-moe-a2.7b", prompts, residency=res, paged=False,
                      spec_cap=spec_cap)
    te, tout = _serve("torch", "qwen2-moe-a2.7b", prompts, residency=res, paged=False,
                      spec_cap=spec_cap)
    assert tout == jout
    for key in COUNTERS:
        assert getattr(te.stats, key) == getattr(je.stats, key), key
    assert _transitions(te) == _transitions(je)
    assert te.stats.misses > 0
    assert (te.stats.spec_windows > 0) == (spec_cap > 1)


def test_group_tick_flag_rules():
    """The reference's rules, before anything is built: no paged pool for a
    recurrent stack, no prefetch without the paged pool; and a stack
    without attention (xLSTM) raises where the reference fails too."""
    _, _, tcfg, tparams = _setup("recurrentgemma-2b")
    rt = TRuntime(cache_len=32)
    with pytest.raises(ValueError, match="KV-cache-only"):
        TServing(tcfg, tparams, rt=rt, paged=True, device="cpu")
    _, _, qcfg, qparams = _setup("qwen2-moe-a2.7b")
    with pytest.raises(ValueError, match="paged continuous-batching"):
        TServing(qcfg, qparams, rt=rt, paged=False, prefetch=True,
                 residency=TRes(mode="rotary", num_slots=5), device="cpu")
    _, _, xcfg, xparams = _setup("xlstm-350m")
    with pytest.raises(ValueError, match="attention"):
        TServing(xcfg, xparams, rt=rt, device="cpu")


MIXED = dict(segments=((("attn_mlp", "attn_moe"), 2),), d_ff=128)


@pytest.mark.parametrize("fused,slots,spec_k,chunk", [
    (None, 0, 1, None), (None, 5, 4, 4), (False, 5, 1, None)])
def test_mixed_stack_rotary_engine_equals_jax(fused, slots, spec_k, chunk):
    """RotaryEngine over attn_mlp + attn_moe layers (qwen2-moe's reduced
    widths, d_ff 128): the fused step at full residency, windows of 4 with
    chunked prefill at 5 of 8 slots (misses replayed from a MoE layer's
    saved input through the dense layer after it), and the per-layer hot
    walk at 5 of 8: the same greedy tokens, last logits within 1e-4 and
    misses as JAX's."""
    cfg, params, tcfg, tparams = _setup("qwen2-moe-a2.7b", **MIXED)
    mode = "rotary" if slots else "full"
    res = dict(mode=mode, num_slots=slots, prefetch_margin=1)
    kw = dict(batch=1, fused_decode=fused, spec_k=spec_k, prefill_chunk=chunk)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 10)).astype(np.int32)
    je = JEngine(cfg, params, JRes(**res), rt=JRuntime(cache_len=32), **kw)
    te = TEngine(tcfg, tparams, TRes(**res), rt=TRuntime(cache_len=32), device="cpu", **kw)
    np.testing.assert_array_equal(te.generate(prompt, 6), je.generate(prompt, 6))
    np.testing.assert_allclose(np.asarray(te.last_logits, np.float32),
                               np.asarray(je.last_logits, np.float32), atol=1e-4, rtol=1e-4)
    assert te.stats.misses == je.stats.misses
    assert te.num_moe_layers == 2 and len(te.layers) == 4
    if slots:
        assert te.stats.misses > 0
