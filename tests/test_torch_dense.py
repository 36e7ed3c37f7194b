"""The port's dense model families and dbrx against the JAX package.

Reduced f32 configs (``reduce_for_smoke``: two layers, width 64, d_ff 128,
frontends of 8 embeddings) on the reference's weights
(``bridge.from_reference``), inputs made with numpy from a seed:

* ``prefill_model`` (``frontend=`` for ``pixtral-12b`` and
  ``musicgen-large``) and three ``decode_model`` steps against JAX's, for
  the six ``attn_mlp`` archs and ``dbrx-132b``; decode against teacher
  forcing in the port (``prefill_model`` over the longer prompt);
* ``apply_mlp`` (``swiglu``, ``gelu_mlp``) against JAX's;
* ``analytic_params`` equal to the reference's for all eleven archs at
  their published widths (no allocation), and every published value equal;
* ``ServingEngine`` on ``starcoder2-3b``: tokens and counters equal JAX's
  ``ServingEngine`` with and without windows, concurrent == each request
  alone, and windows == sequential decode with every draft accepted and
  fewer blocking pulls;
* ``RotaryEngine`` on ``dbrx-132b`` (LayerNorm, 16 experts top-4; reduced:
  8 experts top-2): the same tokens and misses as JAX's at full residency
  and at 4 of 8 slots;
* ``local_attn``, ``rglru``, ``mlstm`` and ``slstm`` layers beside an
  ``attn_mlp`` one: prefill and a decode step equal JAX's.

Tolerance: 1e-4 absolute + 1e-4 relative on f32 logits (XLA and PyTorch sum
in other orders, through two layers and the head); tokens exact. The JAX
references run under ``jax.jit``, each shared through a module cache.
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
from repro.config.base import AttentionConfig as JAttn
from repro.config.base import ModelConfig as JModel
from repro.config.base import RecurrentConfig as JRec
from repro.config import get_config as jget
from repro.configs import reduce_for_smoke as jreduce
from repro.core import RotaryEngine as JEngine
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro.serving import ServingEngine as JServing
from repro_torch.bridge import from_reference
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.config import get_config as tget
from repro_torch.config.base import AttentionConfig as TAttn
from repro_torch.config.base import ModelConfig as TModel
from repro_torch.config.base import RecurrentConfig as TRec
from repro_torch.configs import ALL_ARCHS, DENSE_ARCHS
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.engine import RotaryEngine as TEngine
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams_mod
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import Runtime as TRuntime
from repro_torch.serving import ServingEngine as TServing

TOL = dict(atol=1e-4, rtol=1e-4)
NEW_ARCHS = DENSE_ARCHS + ("dbrx-132b",)
CACHE = 32
PROMPT = 6
_CACHE = {}


def _setup(arch):
    """(jax cfg, jax params, port cfg, port params), f32, cached per module."""
    if arch not in _CACHE:
        cfg = dataclasses.replace(jreduce(jget(arch)), dtype="float32")
        tcfg = dataclasses.replace(treduce(tget(arch)), dtype="float32")
        params = jax.jit(jinit, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        _CACHE[arch] = (cfg, params, tcfg, from_reference(tcfg, jax.tree.map(np.asarray, params)))
    return _CACHE[arch]


def _inputs(cfg, b=2, s=PROMPT, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 3)).astype(np.int32)
    fe = None
    if cfg.frontend:
        fe = rng.standard_normal((b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return tokens, fe


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Prefill (frontend embeddings first where the arch has a frontend),
    then three decode steps fed the same tokens: logits within 1e-4 of
    JAX's at every step."""
    cfg, params, tcfg, tparams = _setup(arch)
    tokens, fe = _inputs(cfg)
    rt = jtfm.Runtime(cache_len=CACHE)
    jl, state = jax.jit(jtfm.prefill_model, static_argnums=(0, 3))(
        cfg, params, jnp.asarray(tokens[:, :PROMPT]), rt,
        None if fe is None else jnp.asarray(fe))
    tl, tstate = ttfm.prefill_model(tcfg, tparams, torch.from_numpy(tokens[:, :PROMPT]), CACHE,
                                    frontend=None if fe is None else torch.from_numpy(fe))
    _close(tl, jl)
    for name in ("k", "v"):               # the caches too, frontend positions first
        _close(tstate[0][name], state[0][0][name][0])
    decode = jax.jit(jtfm.decode_model, static_argnums=(0, 5))
    cur = PROMPT + (cfg.frontend_len if cfg.frontend else 0)
    for t in range(3):
        tok = tokens[:, PROMPT + t]
        jl, state, aux = decode(cfg, params, jnp.asarray(tok), state, jnp.int32(cur + t), rt)
        tl, taux = ttfm.decode_model(tcfg, tparams, torch.from_numpy(tok), tstate, cur + t)
        _close(tl, jl)
    if tcfg.has_moe:
        np.testing.assert_array_equal(taux["route_ids"].numpy(), np.asarray(aux["route_ids/seg0"]))
    else:
        assert taux == {} and not any(k.startswith("route_") for k in aux)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_equals_teacher_forcing(arch):
    """In the port: decode logits at positions PROMPT .. PROMPT + 2 equal a
    prefill over the prompt extended to that position (its last logits)."""
    _, _, tcfg, tparams = _setup(arch)
    tokens, fe = _inputs(tcfg, seed=1)
    front = None if fe is None else torch.from_numpy(fe)
    _, state = ttfm.prefill_model(tcfg, tparams, torch.from_numpy(tokens[:, :PROMPT]), CACHE,
                                  frontend=front)
    cur = PROMPT + (tcfg.frontend_len if tcfg.frontend else 0)
    for t in range(3):
        got, _ = ttfm.decode_model(tcfg, tparams, torch.from_numpy(tokens[:, PROMPT + t]), state,
                                   cur + t)
        want, _ = ttfm.prefill_model(tcfg, tparams, torch.from_numpy(tokens[:, :PROMPT + t + 1]),
                                     CACHE, frontend=front)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["swiglu", "gelu_mlp"])
def test_apply_mlp_matches_jax(kind):
    p = jlayers.init_mlp(kind, jax.random.PRNGKey(3), 64, 128, jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    want = jax.jit(jlayers.apply_mlp, static_argnums=0)(kind, p, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    _close(tlayers.apply_mlp(kind, tp, torch.from_numpy(x)), want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_published_config_and_analytic_params_equal_jax(arch):
    """Every field the port shares with the reference's config is equal,
    and ``analytic_params`` (total and active) equals the reference's at
    the published widths."""
    jc, tc = jget(arch), tget(arch)
    for f in dataclasses.fields(tc):
        want, got = getattr(jc, f.name), getattr(tc, f.name)
        if dataclasses.is_dataclass(got):          # attention, moe: the port's fields
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), (f.name, g.name)
        else:
            assert got == want, f.name
    assert tc.layer_kinds == jc.layer_kinds and tc.has_moe == jc.has_moe
    for active in (False, True):
        assert (tparams_mod.analytic_params(tc, active_only=active)
                == jparams.analytic_params(jc, active_only=active))


def test_init_params_shapes_follow_the_block_kinds():
    """The port's own init builds the reference's layout: ``mlp`` on a
    dense layer, ``moe`` on an MoE one, ``frontend_proj`` only where the
    frontend's width is not d_model, no ``lm_head`` on a tied config."""
    for arch, has in (("qwen3-4b", "mlp"), ("dbrx-132b", "moe")):
        tcfg = treduce(tget(arch))
        p = ttfm.init_params(tcfg, 0, "cpu")
        assert all(has in layer and set(layer) == {"ln1", "attn", "ln2", has}
                   for layer in p["layers"])
        assert ("lm_head" in p) == (not tcfg.tie_embeddings)
    tcfg = dataclasses.replace(treduce(tget("pixtral-12b")), frontend_dim=48)
    p = ttfm.init_params(tcfg, 0, "cpu")
    assert tuple(p["frontend_proj"].shape) == (48, tcfg.d_model)
    assert sum(t.numel() for t in _leaves(p)) == tparams_mod.analytic_params(tcfg)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def test_frontend_arch_without_frontend_raises():
    _, _, tcfg, tparams = _setup("musicgen-large")
    with pytest.raises(ValueError, match="frontend"):
        ttfm.prefill_model(tcfg, tparams, torch.zeros((1, 4), dtype=torch.int64), CACHE)


# ===========================================================================
# serving (starcoder2-3b) and RotaryEngine (dbrx-132b)
# ===========================================================================
SERVE_LENS = (5, 9, 12)


def _serve(pkg, spec_cap, prompts, num_slots=2, **kw):
    cfg, params, tcfg, tparams = _setup("starcoder2-3b")
    if pkg == "jax":
        eng = JServing(cfg, params, rt=jtfm.Runtime(cache_len=64), num_slots=num_slots,
                       spec_cap=spec_cap, **kw)
    else:
        eng = TServing(tcfg, tparams, rt=TRuntime(cache_len=64), num_slots=num_slots,
                       spec_cap=spec_cap, device="cpu", **kw)
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    eng.run()
    return eng, [r.output for r in reqs]


def _serve_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, n).astype(np.int32) for n in SERVE_LENS]


@pytest.fixture(scope="module")
def jax_serving():
    return {k: _serve("jax", k, _serve_prompts()) for k in (1, 4)}


@pytest.mark.parametrize("spec_cap", [1, 4])
def test_dense_serving_engine_equals_jax(spec_cap, jax_serving):
    """The same tokens and counters as JAX's ServingEngine on a dense arch;
    windows (spec_cap 4) accept every draft (nothing misses)."""
    je, jout = jax_serving[spec_cap]
    te, tout = _serve("torch", spec_cap, _serve_prompts())
    assert tout == jout
    for key in ("windows", "spec_windows", "misses", "steps", "tokens", "drafted_tokens",
                "accepted_tokens", "kv_pages_allocated", "kv_pages_released", "kv_pages_hwm",
                "sync_pulls"):
        assert getattr(te.stats, key) == getattr(je.stats, key), key
    assert te.res_mgr is None and te.stats.misses == 0
    assert te.stats.accepted_tokens == te.stats.drafted_tokens


def test_dense_serving_windows_equal_sequential_and_alone():
    """Windows emit the tick-by-tick engine's tokens with fewer blocking
    pulls; each request alone emits its concurrent tokens; a rotating
    ResidencyConfig on a dense arch is ignored (the same tokens, no
    residency manager)."""
    prompts = _serve_prompts()
    seq, seq_out = _serve("torch", 1, prompts)
    spec, spec_out = _serve("torch", 4, prompts,
                            residency=TRes(mode="rotary", num_slots=4))
    assert spec_out == seq_out and spec.res_mgr is None
    assert spec.stats.spec_windows > 0 and spec.stats.sync_pulls < seq.stats.sync_pulls
    for i, p in enumerate(prompts):
        assert _serve("torch", 4, [p], num_slots=1)[1][0] == spec_out[i]


@pytest.mark.parametrize("slots", [0, 4])
def test_dbrx_rotary_engine_equals_jax(slots):
    """RotaryEngine on dbrx (LayerNorm, top-k of 8 reduced experts): the
    same greedy tokens, logits within 1e-4 and the same misses as JAX's."""
    cfg, params, tcfg, tparams = _setup("dbrx-132b")
    mode = "full" if slots == 0 else "rotary"
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    je = JEngine(cfg, params, JRes(mode=mode, num_slots=slots, prefetch_margin=1),
                 rt=jtfm.Runtime(cache_len=CACHE), batch=1)
    te = TEngine(tcfg, tparams, TRes(mode=mode, num_slots=slots, prefetch_margin=1),
                 rt=TRuntime(cache_len=CACHE), batch=1, device="cpu")
    jt = je.generate(prompt, 6)
    tt = te.generate(prompt, 6)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(np.asarray(te.last_logits, np.float32),
                               np.asarray(je.last_logits, np.float32), **TOL)
    assert te.stats.misses == je.stats.misses
    if slots:
        assert te.stats.misses > 0


def test_rotary_engine_and_cli_refuse_a_dense_arch(capsys, monkeypatch):
    from repro_torch.launch import serve

    _, _, tcfg, tparams = _setup("qwen3-4b")
    with pytest.raises(ValueError, match="MoE"):
        TEngine(tcfg, tparams, TRes(mode="rotary", num_slots=4), device="cpu")
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen3-4b", "--device", "cpu"])
    with pytest.raises(ValueError, match="MoE"):
        serve.main()


def test_serve_cli_serves_a_dense_arch_on_the_cpu(capsys, monkeypatch):
    """``--engine batch`` on starcoder2-3b: every request completes, windows
    accept every draft, ``--layers`` keeps the config's own unit."""
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "starcoder2-3b", "--engine", "batch",
                                      "--device", "cpu", "--requests", "3", "--max-new", "5",
                                      "--prompt-len", "20", "--cache-len", "64",
                                      "--batch-slots", "2", "--layers", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert len(re.findall(r"req \d: prompt_len=\d+ -> \[(\d+, ){4}\d+\]", out)) == 3
    assert re.search(r"'accept_rate': 1\.0", out) and re.search(r"'misses': 0", out)


@pytest.mark.parametrize("kind", ["local_attn", "rglru", "mlstm", "slstm"])
def test_ported_block_kinds_decode_like_jax(kind):
    """Each block kind the port took last (beside an ``attn_mlp`` layer,
    f32, a window of 4 under a 6-token prompt): prefill and one decode step
    on JAX's weights, logits within 1e-4 of JAX's."""
    kw = dict(name="x", family="hybrid", d_model=64, vocab_size=256,
              segments=(((kind, "attn_mlp"), 2),), d_ff=128, dtype="float32")
    window = 4 if kind == "local_attn" else None
    cfg = JModel(**kw, attention=JAttn(num_heads=4, num_kv_heads=1, head_dim=16, window=window),
                 recurrent=JRec(num_heads=2))
    tcfg = TModel(**kw, attention=TAttn(num_heads=4, num_kv_heads=1, head_dim=16, window=window),
                  recurrent=TRec(num_heads=2))
    params = jax.jit(jinit, static_argnums=0)(cfg, jax.random.PRNGKey(1))
    tparams = from_reference(tcfg, jax.tree.map(np.asarray, params))
    tokens, _ = _inputs(tcfg, seed=3)
    rt = jtfm.Runtime(cache_len=CACHE)
    jl, state = jax.jit(jtfm.prefill_model, static_argnums=(0, 3))(
        cfg, params, jnp.asarray(tokens[:, :PROMPT]), rt)
    tl, tstate = ttfm.prefill_model(tcfg, tparams, torch.from_numpy(tokens[:, :PROMPT]), CACHE)
    _close(tl, jl)
    tok = tokens[:, PROMPT]
    jl, _, _ = jax.jit(jtfm.decode_model, static_argnums=(0, 5))(
        cfg, params, jnp.asarray(tok), state, jnp.int32(PROMPT), rt)
    tl, _ = ttfm.decode_model(tcfg, tparams, torch.from_numpy(tok), tstate, PROMPT)
    _close(tl, jl)
