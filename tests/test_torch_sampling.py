"""The port's sampled decode against the JAX package's.

``repro_torch.models.sampling`` writes JAX's threefry2x32 (partitionable
bits), ``fold_in`` and ``categorical``'s Gumbel draw as torch integer ops:
base keys (``row_keys``, ``request_key``), position keys and raw bits equal
JAX's bit for bit, the uniforms too; the Gumbel noise goes through ``log``
twice and may differ by an ulp, so drawn tokens are held equal to JAX's
wherever the winning score leads the runner-up by more than 1e-5 (and
nowhere else may they differ). ``warp_probs`` keeps JAX's support exactly
and its values to 1e-6 (softmax sums in another order). The host
``stochastic_accept`` and ``Sampler`` are numpy copies: equal to the
reference's under the same generator, and the leftover rule emits the
target distribution (a chi-squared test; a one-hot target has no degree of
freedom and every emitted token must be its one supported token).

Engine level, reduced f32 ``qwen36-35b-a3b`` on the reference's weights,
batch 2, ``cache_len`` 32: the sampled token stream equals the JAX
engine's at spec 1 and spec 4, with every expert resident and at 3 of 8
slots, with and without prefetch, and for ``greedy=False``; the spec-4 and
spec-1 streams are equal; a seed reproduces its stream bit for bit; the
walks draw between their steps.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ResidencyConfig as JRes
from repro.core import RotaryEngine as JEngine
from repro.models import sampling as J
from repro.models.transformer import Runtime as JRuntime
from repro.serving import sampler as jsampler
from repro_torch.bridge import from_reference
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.core.engine import RotaryEngine as TEngine
from repro_torch.models import sampling as T
from repro_torch.models.transformer import Runtime as TRuntime
from repro_torch.serving import sampler as tsampler
from test_torch_walk import _setup, counters

SEEDS = [0, 7, 123456789, 2**31 - 1, -1]
PARAMS = [(1.0, 0, 1.0), (0.8, 50, 0.95), (0.7, 0, 0.9), (1.3, 5, 1.0), (1.0, 1, 1.0)]


def _u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax_bitwise(seed):
    np.testing.assert_array_equal(T.row_keys(seed, 5).numpy(), _u32(J.row_keys(seed, 5)))
    np.testing.assert_array_equal(T.request_key(seed).numpy(), _u32(J.request_key(seed)))
    keys = J.row_keys(seed, 3)
    for pos in (0, 1, 511, 2**31 - 1):
        np.testing.assert_array_equal(T.position_keys(T.row_keys(seed, 3), pos).numpy(),
                                      _u32(J.position_keys(keys, jnp.int32(pos))))
    per_row = np.array([3, 40, 1000], np.int32)
    np.testing.assert_array_equal(
        T.position_keys(T.row_keys(seed, 3), torch.from_numpy(per_row)).numpy(),
        _u32(J.position_keys(keys, jnp.asarray(per_row))))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniforms_and_gumbel_equal_jax(seed):
    """Raw bits and uniforms bit for bit; the Gumbel noise to an ulp."""
    keys = T.position_keys(T.row_keys(seed, 2), 77)
    for row in range(2):
        k = jax.random.wrap_key_data(jnp.asarray(keys[row].numpy(), jnp.uint32))
        np.testing.assert_array_equal(T.random_bits(keys[row:row + 1], 1001).numpy()[0],
                                      _u32(jax.random.bits(k, (1001,), jnp.uint32)))
        tiny = float(np.finfo(np.float32).tiny)
        want_u = np.asarray(jax.random.uniform(k, (1001,), minval=tiny, maxval=1.0))
        assert T.uniform(keys[row:row + 1], 1001, tiny, 1.0).numpy()[0].tobytes() == \
            want_u.tobytes()
        np.testing.assert_allclose(T.gumbel(keys[row:row + 1], 1001).numpy()[0],
                                   np.asarray(jax.random.gumbel(k, (1001,))),
                                   rtol=1e-6, atol=1e-6)


def _logits(seed, b=2, v=300, ties=False):
    x = np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32) * 3
    if ties:
        x[:, 10:20] = x.max() + 1.0                 # a tie block at the top
    return x


@pytest.mark.parametrize("sp", PARAMS)
@pytest.mark.parametrize("ties", [False, True])
def test_warp_probs_matches_jax(sp, ties):
    x = _logits(1, ties=ties)
    want = np.asarray(J.warp_probs(jnp.asarray(x), J.SampleParams(*sp)))
    got = T.warp_probs(torch.from_numpy(x), T.SampleParams(*sp)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    host = tsampler.Sampler(tsampler.SamplerConfig(*sp)).warp(x)
    np.testing.assert_array_equal(host > 0, got > 0)


@pytest.mark.parametrize("sp", PARAMS)
def test_draws_equal_jax_outside_near_ties(sp):
    x = _logits(2)
    keys_j, keys_t = J.row_keys(11, 2), T.row_keys(11, 2)
    diffs = 0
    for pos in range(64):
        tj, pj, ptj = J.sample_step(jnp.asarray(x), keys_j, jnp.int32(pos), J.SampleParams(*sp))
        tt, pt, ptt = T.sample_step(torch.from_numpy(x), keys_t, pos, T.SampleParams(*sp))
        np.testing.assert_allclose(ptt.numpy(), np.asarray(ptj), atol=1e-6, rtol=0)
        for row in np.flatnonzero(tt.numpy() != np.asarray(tj)):
            # the two winners' Gumbel scores must nearly tie
            p = pt.numpy()[row]
            logp = np.where(p > 0, np.log(np.maximum(p, 1e-38)), -np.inf)
            g = T.gumbel(T.position_keys(keys_t, pos)[row:row + 1], x.shape[1]).numpy()[0]
            score = g + logp
            top2 = np.sort(score)[-2:]
            assert top2[1] - top2[0] < 1e-5, (pos, row)
            diffs += 1
    assert diffs <= 2


@pytest.mark.parametrize("seed", [0, 3])
def test_stochastic_accept_and_sampler_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    k, b, v = 4, 3, 12
    p = rng.dirichlet(np.ones(v), size=(k, b))
    q = rng.dirichlet(np.ones(v), size=(k, b))
    draft = np.stack([[rng.choice(v, p=p[i, j]) for j in range(b)] for i in range(k)])
    for pq in ((p, q), (p, p)):
        got = tsampler.stochastic_accept(draft, *pq, np.random.default_rng(seed + 1))
        want = jsampler.stochastic_accept(draft, *pq, np.random.default_rng(seed + 1))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tsampler.greedy_accept(draft, draft),
                                  jsampler.greedy_accept(draft, draft))
    x = _logits(seed, b=3)
    for sp in PARAMS:
        cfg_t, cfg_j = tsampler.SamplerConfig(*sp, seed), jsampler.SamplerConfig(*sp, seed)
        ts, js = tsampler.Sampler(cfg_t), jsampler.Sampler(cfg_j)
        np.testing.assert_array_equal(ts.warp(x), js.warp(x))
        for _ in range(3):
            np.testing.assert_array_equal(ts(x), js(x))
    greedy = tsampler.Sampler(tsampler.SamplerConfig(temperature=0.0))
    np.testing.assert_array_equal(greedy(x), x.argmax(-1))


@pytest.mark.parametrize("q_raw", [
    [1, 2, 3, 4, 5, 6], [0, 0, 7, 0, 1, 0], [0, 0, 0, 1, 0, 0]])
def test_stochastic_accept_emits_the_target(q_raw):
    """Accept-or-resample emits q whatever p: a chi-squared test on the
    emitted tokens (Wilson-Hilferty bound), never a token outside q. A
    one-hot q leaves no degree of freedom: every emitted token is its one
    supported token."""
    v = len(q_raw)
    p = np.arange(1, v + 1, dtype=np.float64)[::-1].copy()
    p /= p.sum()
    q = np.asarray(q_raw, np.float64) / sum(q_raw)
    r = np.random.default_rng(5)
    n = 15_000
    draft = r.choice(v, size=(1, n), p=p).astype(np.int32)
    acc, res = tsampler.stochastic_accept(draft, np.broadcast_to(p, (1, n, v)),
                                          np.broadcast_to(q, (1, n, v)), r)
    emitted = np.where(acc == 1, draft[0], res)
    counts = np.bincount(emitted, minlength=v)
    keep = q > 0
    assert counts[~keep].sum() == 0
    df = int(keep.sum()) - 1
    if df == 0:
        assert (emitted == np.flatnonzero(keep)[0]).all()
    else:
        exp = n * q
        stat = ((counts[keep] - exp[keep]) ** 2 / exp[keep]).sum()
        crit = df * (1 - 2 / (9 * df) + 3.1 * np.sqrt(2 / (9 * df))) ** 3
        assert stat < crit, (stat, crit)
    analytic = np.minimum(p, q).sum()
    assert abs(acc.mean() - analytic) < 5 * np.sqrt(max(analytic * (1 - analytic), 1e-4) / n)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
STEPS = 10


def _kw(slots):
    return dict(mode="full" if slots == 0 else "rotary", num_slots=slots, prefetch_margin=1)


def _stream(engine, prompt, steps=STEPS, **kw):
    return engine.decode(engine.prefill(prompt), steps, **kw)


@pytest.mark.parametrize("spec_k,slots,prefetch", [
    (1, 0, False), (4, 0, False), (1, 3, False), (4, 3, False), (1, 6, True), (4, 6, True)])
def test_sampled_stream_port_equals_jax(spec_k, slots, prefetch):
    cfg, params, tcfg, np_params = _setup()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    kw = dict(batch=2, spec_k=spec_k, prefetch=prefetch)
    je = JEngine(cfg, params, JRes(**_kw(slots)), rt=JRuntime(cache_len=32), **kw)
    te = TEngine(tcfg, from_reference(tcfg, np_params), TRes(**_kw(slots)),
                 rt=TRuntime(cache_len=32), device="cpu", **kw)
    sj = jsampler.SamplerConfig(temperature=0.8, top_k=50, top_p=0.95, seed=7)
    st = tsampler.SamplerConfig(temperature=0.8, top_k=50, top_p=0.95, seed=7)
    jt = _stream(je, prompt, sampler=sj)
    tt = _stream(te, prompt, sampler=st)
    np.testing.assert_array_equal(tt, jt)
    assert counters(te.stats) == counters(je.stats)
    assert te.stats.spec_windows > 0                # sampled fused decode runs windows
    if slots == 3:
        assert te.stats.replayed_steps > 0
    if prefetch:
        assert te.stats.relaunched_steps > 0


def test_greedy_false_stream_equals_jax_and_reproduces():
    cfg, params, tcfg, np_params = _setup()
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    tparams = from_reference(tcfg, np_params)
    je = JEngine(cfg, params, JRes(**_kw(3)), rt=JRuntime(cache_len=32), batch=2)
    jt = _stream(je, prompt, greedy=False, seed=5)
    runs = []
    for spec_k in (1, 4, 1):
        te = TEngine(tcfg, tparams, TRes(**_kw(3)), rt=TRuntime(cache_len=32), batch=2,
                     device="cpu", spec_k=spec_k)
        runs.append(_stream(te, prompt, greedy=False, seed=5))
    for tt in runs:
        np.testing.assert_array_equal(tt, jt)
    other = TEngine(tcfg, tparams, TRes(**_kw(3)), rt=TRuntime(cache_len=32), batch=2,
                    device="cpu")
    assert not np.array_equal(_stream(other, prompt, greedy=False, seed=6), jt)


@pytest.mark.parametrize("flags", [dict(fused_decode=False), dict(host_routing=True)])
def test_sampled_walks_draw_between_steps(flags):
    """The walks draw each token between steps with the same position keys:
    their stream equals the fused window family's (f32, 6 of 8 slots)."""
    _, _, tcfg, np_params = _setup()
    tparams = from_reference(tcfg, np_params)
    prompt = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    sc = tsampler.SamplerConfig(temperature=1.0, top_p=0.9, seed=3)
    fused = TEngine(tcfg, tparams, TRes(**_kw(6)), rt=TRuntime(cache_len=32), batch=2,
                    device="cpu")
    walk = TEngine(tcfg, tparams, TRes(**_kw(6)), rt=TRuntime(cache_len=32), batch=2,
                   device="cpu", **flags)
    np.testing.assert_array_equal(_stream(walk, prompt, sampler=sc),
                                  _stream(fused, prompt, sampler=sc))
    assert walk.stats.spec_windows == 0 and fused.stats.spec_windows == STEPS


def test_serve_cli_samples_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    argv = ["serve", "--arch", "qwen36-35b-a3b", "--device", "cpu", "--requests", "1",
            "--max-new", "5", "--slots", "4", "--layers", "2", "--temperature", "0.8",
            "--top-k", "20", "--top-p", "0.9", "--sample-seed", "4", "--spec-k", "2"]
    outs = []
    for _ in range(2):
        monkeypatch.setattr(sys, "argv", argv)
        serve.main()
        outs.append(re.search(r"req 0: (\[[\d, ]+\])", capsys.readouterr().out).group(1))
    assert outs[0] == outs[1]
