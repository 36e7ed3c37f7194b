"""The port's training path against the JAX package.

On reduced f32 configs (``reduce_for_smoke``: two layers, width 64, vocab
256) with the reference's weights (``bridge.from_reference``) and tokens
made with numpy from a seed:

* one train step: ``lm_loss`` and its aux terms, every gradient (JAX's
  through ``bridge.from_reference``), and after one AdamW step the
  parameters and both moments, against JAX's ``lm_loss`` /
  ``jax.value_and_grad`` / ``adamw_update``: qwen36 with sorted and dense
  dispatch, dropless (the reduced capacity factor 8) and at its published
  capacity factor 1.25 (assignments dropped), qwen2-moe (shared experts,
  and 10 stored experts for 8 routed: padded), starcoder2-3b,
  recurrentgemma-2b, xlstm-350m and pixtral-12b (a frontend);
* every remat policy gives the same loss and gradients, bit for bit;
* mirrors of the reference's ``tests/test_training.py``: the schedule,
  an AdamW step, clipping, microbatch equivalence, the loss going down;
* the synthetic data bit for bit the reference's ``batch_at_step``, and the
  prefetching loader in step order;
* the two repairs: at capacity factor 1.25 ``prefill_model(moe_capacity=)``
  equals the reference's ``prefill_model`` (which drops) and the dropless
  ``prefill_model`` that the engines run equals the reference run dropless
  (and not the dropping one); a row alone in a batch's allocation gives the
  bits it gives in that batch through eager ``decode_model``;
* ``python -m repro_torch.launch.train`` on the CPU, and its resume.

Tolerances (f32): loss and aux 1e-5 relative; gradients 2e-5 absolute +
1e-4 relative (XLA and PyTorch sum in other orders through two layers, the
head and the loss); AdamW alone on JAX's gradients: parameters and moments
1e-6 + 1e-6; after the whole step the moments within the gradients'
tolerance scaled by the clip and the betas (m 2e-6 + 1e-4, v 1e-9 + 2e-4)
and the parameters 1e-6 + 1e-6 wherever JAX's gradient exceeds 1e-4 (the
first AdamW step moves a weight by lr * g / (|g| + 1e-8), whose sign is
rounding noise for a gradient inside its tolerance); prefill logits 1e-4 +
1e-4. The JAX references run under ``jax.jit``.
"""
import dataclasses
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JRun
from repro.config import ShardingConfig as JSharding
from repro.config import get_config as jget
from repro.configs import reduce_for_smoke as jreduce
from repro.data import SyntheticSpec as JSpec
from repro.data import batch_at_step as jbatch
from repro.models import init_params as jinit
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.training.optimizer import adamw_init as jadamw_init
from repro.training.optimizer import adamw_update as jadamw_update
from repro_torch.bridge import from_reference
from repro_torch.config import RunConfig, ShardingConfig
from repro_torch.config import get_config as tget
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.data import Loader, SyntheticSpec, batch_at_step
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.params import analytic_params, count_params, model_flops, param_summary
from repro_torch.training import (adamw_init, adamw_update, global_norm, init_train_state,
                                  lr_at, make_train_step)
from repro_torch.tree import leaves, map_tree

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-6, rtol=1e-6)
M_TOL = dict(atol=2e-6, rtol=1e-4)
V_TOL = dict(atol=1e-9, rtol=2e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16
RUN = dict(learning_rate=1e-3, warmup_steps=0)
_JPARAMS = {}

# (case id, arch, moe dispatch, capacity factor, stored experts)
CASES = [
    ("qwen36-sorted", "qwen36-35b-a3b", "sorted", None, None),
    ("qwen36-dense", "qwen36-35b-a3b", "dense", None, None),
    ("qwen36-sorted-cf1.25", "qwen36-35b-a3b", "sorted", 1.25, None),
    ("qwen36-dense-cf1.25", "qwen36-35b-a3b", "dense", 1.25, None),
    ("qwen2-moe-padded", "qwen2-moe-a2.7b", "sorted", None, 10),
    ("starcoder2-3b", "starcoder2-3b", "sorted", None, None),
    ("recurrentgemma-2b", "recurrentgemma-2b", "sorted", None, None),
    ("xlstm-350m", "xlstm-350m", "sorted", None, None),
    ("pixtral-12b", "pixtral-12b", "sorted", None, None),
]


def _moe_over(cfg, cf, padded):
    if cfg.moe is None:
        return cfg
    over = {}
    if cf is not None:
        over["capacity_factor"] = cf
    if padded is not None:
        over["padded_experts"] = padded
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))


def _configs(arch, cf=None, padded=None, dtype="float32"):
    jc = _moe_over(dataclasses.replace(jreduce(jget(arch)), dtype=dtype), cf, padded)
    tc = _moe_over(dataclasses.replace(treduce(tget(arch)), dtype=dtype), cf, padded)
    return jc, tc


def _jparams(jc):
    """The reference's f32 weights, one init per (arch, stored experts)."""
    key = (jc.name, jc.moe.storage_experts if jc.moe else 0)
    if key not in _JPARAMS:
        _JPARAMS[key] = jinit(jc, jax.random.PRNGKey(0))
    return _JPARAMS[key]


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    n_tok = s - (cfg.frontend_len if cfg.frontend else 0)
    tokens = rng.integers(0, cfg.vocab_size, (b, n_tok)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    fe = (rng.standard_normal((b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
          if cfg.frontend else None)
    return tokens, labels, fe


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


def _trees_close(ttree, jtree, tcfg, **tol):
    want = from_reference(tcfg, jax.tree.map(np.asarray, jtree))
    got_leaves, want_leaves = leaves(ttree), leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.detach().float().numpy(), w.float().numpy(), **tol)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_train_step_matches_jax(case):
    """Loss, aux, gradients, and after one AdamW step the parameters and
    moments, against JAX; at capacity factor 1.25 assignments really drop."""
    _, arch, impl, cf, padded = case
    jc, tc = _configs(arch, cf, padded)
    jparams = _jparams(jc)
    tokens, labels, fe = _batch(tc)
    jrt = jtfm.Runtime(sharding=JSharding(moe_impl=impl))
    trt = ttfm.Runtime(sharding=ShardingConfig(moe_impl=impl))

    def jloss(p):
        return jtfm.lm_loss(jc, p, jnp.asarray(tokens), jnp.asarray(labels), jrt,
                            None if fe is None else jnp.asarray(fe))

    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    jrun = JRun(**RUN)
    jnew, jopt, jm = jax.jit(lambda p, g: jadamw_update(p, g, jadamw_init(p), jrun))(
        jparams, jgrads)

    tparams = from_reference(tc, jax.tree.map(np.asarray, jparams))
    state = init_train_state(tc, tparams)
    tl, taux = ttfm.lm_loss(tc, tparams, _t(tokens), _t(labels), trt, _t(fe))
    tgrads = torch.autograd.grad(tl, leaves(tparams))
    _close(tl, jl, **LOSS_TOL)
    for name in ("moe_load_balance", "moe_router_z", "moe_dropped_frac"):
        assert (name in taux) == (name in jaux), name
        if name in taux:
            _close(taux[name], jaux[name], rtol=1e-5, atol=1e-7)
    if cf is not None and impl == "sorted":
        assert float(taux["moe_dropped_frac"]) > 0.0          # the capacity really drops
    want_g = leaves(from_reference(tc, jax.tree.map(np.asarray, jgrads)))
    for g, w in zip(tgrads, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)

    # the optimizer alone, on JAX's gradients: JAX's parameters and moments
    alone = map_tree(lambda t: t.detach().clone(), tparams)
    got, opt, _ = adamw_update(alone, want_g, adamw_init(alone), RunConfig(**RUN))
    _trees_close(got, jnew, tc, **PARAM_TOL)
    _trees_close(opt["m"], jopt["m"], tc, **PARAM_TOL)
    _trees_close(opt["v"], jopt["v"], tc, **PARAM_TOL)

    # the train step end to end: its gradients' moments within the gradients'
    # tolerance, its parameters JAX's wherever JAX's gradient is above that
    # tolerance (elsewhere AdamW's first step, lr * g / (|g| + 1e-8), takes
    # its sign from rounding noise)
    step = make_train_step(tc, trt, RunConfig(**RUN))
    state, metrics = step(state, _t(tokens), _t(labels), _t(fe))
    _close(metrics["loss"], jl, **LOSS_TOL)
    _close(metrics["grad_norm"], jm["grad_norm"], rtol=1e-5, atol=0)
    _trees_close(state["opt"]["m"], jopt["m"], tc, **M_TOL)
    _trees_close(state["opt"]["v"], jopt["v"], tc, **V_TOL)
    for p, w, g in zip(leaves(state["params"]), leaves(from_reference(
            tc, jax.tree.map(np.asarray, jnew))), want_g):
        sure = g.abs() > GRAD_TOL["atol"] * 5
        np.testing.assert_allclose(p.detach()[sure].numpy(), w[sure].numpy(), **PARAM_TOL)
    assert int(state["opt"]["step"]) == int(jopt["step"]) == 1


@pytest.mark.parametrize("impl", ["sorted", "dense"])
def test_remat_policies_give_the_same_bits(impl):
    """none, full and dots_saveable: the same loss and gradients, bit for bit
    (a recomputed forward is the same forward)."""
    _, tc = _configs("qwen36-35b-a3b", cf=1.25)
    params = ttfm.init_params(tc, 0, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    tokens, labels, _ = _batch(tc, seed=1)
    got = []
    for policy in ("none", "full", "dots_saveable"):
        rt = ttfm.Runtime(sharding=ShardingConfig(remat_policy=policy, moe_impl=impl))
        loss, _ = ttfm.lm_loss(tc, params, _t(tokens), _t(labels), rt)
        got.append((loss, torch.autograd.grad(loss, leaves(params))))
    for loss, grads in got[1:]:
        assert torch.equal(loss, got[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, got[0][1]))


def test_routing_replay_drops_the_same_assignments():
    """A forward that replays another's top-k ids (``moe.Routing``) drops the
    same assignments, in f32 as in bf16: the loss of the replay in the
    recording's own type is the recording's."""
    _, tc = _configs("qwen36-35b-a3b", cf=1.25, dtype="bfloat16")
    params = ttfm.init_params(tc, 0, "cpu")
    tokens, labels, _ = _batch(tc, seed=2)
    rt = ttfm.Runtime()
    routes = [tmoe.Routing() for _ in range(tc.num_moe_layers)]
    loss, aux = ttfm.lm_loss(tc, params, _t(tokens), _t(labels), rt, routes=routes)
    assert all(r.ids is not None for r in routes) and float(aux["moe_dropped_frac"]) > 0
    replay = [tmoe.Routing(r.ids, replay=True) for r in routes]
    again, aux2 = ttfm.lm_loss(tc, params, _t(tokens), _t(labels), rt, routes=replay)
    assert torch.equal(loss, again) and torch.equal(aux["moe_dropped_frac"],
                                                    aux2["moe_dropped_frac"])
    f32cfg = dataclasses.replace(tc, dtype="float32")
    f32 = map_tree(lambda t: t.float(), params)
    _, auxf = ttfm.lm_loss(f32cfg, f32, _t(tokens), _t(labels), rt,
                           routes=[tmoe.Routing(r.ids, replay=True) for r in routes])
    assert torch.equal(auxf["moe_dropped_frac"], aux["moe_dropped_frac"])


# ---------------------------------------------------------------------------
# mirrors of tests/test_training.py
# ---------------------------------------------------------------------------
def test_lr_schedule():
    run = RunConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    assert lr_at(run, 0) == 0.0
    assert abs(lr_at(run, 10) - 1e-3) < 1e-9
    assert lr_at(run, 100) < 2e-4                          # cosine floor 10%
    assert lr_at(run, 50) < 1e-3
    jrun = JRun(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    from repro.training.optimizer import lr_at as jlr_at
    for step in (0, 3, 10, 37, 99, 100, 120):
        assert lr_at(run, step) == pytest.approx(float(jlr_at(jrun, jnp.int32(step))), rel=1e-6)


def test_adamw_step_moves_params():
    run = RunConfig(learning_rate=1e-2, warmup_steps=0)
    params = {"w": torch.ones((4, 4))}
    opt = adamw_init(params)
    new_p, new_opt, m = adamw_update(params, {"w": torch.ones((4, 4))}, opt, run)
    assert int(new_opt["step"]) == 1
    assert not torch.allclose(new_p["w"], torch.ones((4, 4)))
    assert float(m["grad_norm"]) == pytest.approx(4.0)


def test_grad_clip_applied():
    run = RunConfig(learning_rate=1e-2, grad_clip=0.1, warmup_steps=0, weight_decay=0.0)
    big = {"w": torch.full((2,), 100.0)}
    small = {"w": torch.full((2,), 100.0) * 0.1 / global_norm(big)}
    p1, _, _ = adamw_update({"w": torch.zeros((2,))}, big, adamw_init({"w": torch.zeros(2)}),
                            run)
    p2, _, _ = adamw_update({"w": torch.zeros((2,))}, small,
                            adamw_init({"w": torch.zeros(2)}), run)
    torch.testing.assert_close(p1["w"], p2["w"], atol=1e-6, rtol=0)


def test_microbatch_equivalence():
    """num_micro=1 and num_micro=2 give (nearly) the same updated params."""
    _, tc = _configs("starcoder2-3b", dtype="bfloat16")
    rt = ttfm.Runtime()
    run = RunConfig(learning_rate=1e-3, warmup_steps=0)
    tokens = _t(np.random.default_rng(0).integers(0, tc.vocab_size, (4, 16)).astype(np.int32))
    s1 = init_train_state(tc, ttfm.init_params(tc, 0, "cpu"))
    s2 = init_train_state(tc, ttfm.init_params(tc, 0, "cpu"))
    s1, m1 = make_train_step(tc, rt, run, num_micro=1)(s1, tokens, tokens)
    s2, m2 = make_train_step(tc, rt, run, num_micro=2)(s2, tokens, tokens)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-2     # bf16 model, as in the reference
    for a, b in zip(leaves(s1["params"]), leaves(s2["params"])):
        torch.testing.assert_close(a.detach().float(), b.detach().float(), atol=2e-3, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m"])
def test_loss_decreases(arch):
    tc = treduce(tget(arch))
    rt = ttfm.Runtime()
    run = RunConfig(learning_rate=3e-3, warmup_steps=1)
    spec = SyntheticSpec(vocab_size=tc.vocab_size, seq_len=24, global_batch=4,
                         kind="topic", num_topics=2, topic_len=8)
    state = init_train_state(tc, ttfm.init_params(tc, 0, "cpu"))
    step_fn = make_train_step(tc, rt, run)
    losses = []
    for i in range(5):
        t, l = batch_at_step(spec, i)
        state, m = step_fn(state, _t(t), _t(l))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_distributed_compression_raises():
    """``int8_ef`` adds this rank's [1, *shape] bf16 residual slice of zeros
    beside every parameter; the pod-compressed step raises before anything
    is built without a mesh that has a "pod" axis (the multi-rank step is
    ``tests/test_torch_distributed.py``)."""
    _, tc = _configs("starcoder2-3b")
    params = ttfm.init_params(tc, 0, "cpu")
    state = init_train_state(tc, params, ShardingConfig(grad_compression="int8_ef"))
    ef = leaves(state["ef"])
    assert len(ef) == len(leaves(params))
    for e, p in zip(ef, leaves(params)):
        assert e.shape == (1,) + tuple(p.shape) and e.dtype == torch.bfloat16
        assert not e.any()
    with pytest.raises(ValueError, match="'pod' axis"):
        make_train_step(tc, ttfm.Runtime(), RunConfig(), pod_compression=True)


def test_param_accounting():
    """``count_params`` of a real tree equals ``analytic_params``;
    ``model_flops`` is 6 x active x tokens; ``param_summary`` as the
    reference's."""
    from repro.models import params as jparams
    for arch in ("qwen36-35b-a3b", "recurrentgemma-2b", "pixtral-12b"):
        _, tc = _configs(arch)
        jc = jget(arch)
        assert count_params(ttfm.init_params(tc, 0, "cpu")) == analytic_params(tc)
        assert model_flops(tget(arch), 1000) == jparams.model_flops(jc, 1000)
        assert param_summary(tget(arch)) == pytest.approx(jparams.param_summary(jc))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["topic", "uniform"])
def test_batches_equal_the_reference_bit_for_bit(kind):
    for spec_kw in (dict(vocab_size=256, seq_len=24, global_batch=4, topic_len=8, num_topics=3),
                    dict(vocab_size=151936, seq_len=100, global_batch=2, seed=5)):
        spec, jspec = SyntheticSpec(kind=kind, **spec_kw), JSpec(kind=kind, **spec_kw)
        for step in (0, 1, 7):
            for got, want in zip(batch_at_step(spec, step), jbatch(jspec, step)):
                assert got.dtype == want.dtype and np.array_equal(got, want)


def test_loader_yields_steps_in_order_and_stops():
    spec = SyntheticSpec(vocab_size=256, seq_len=16, global_batch=2)
    with Loader(spec, "cpu", depth=2, start_step=3) as loader:
        for want in (3, 4, 5):
            step, tokens, labels = next(loader)
            assert step == want and tokens.device.type == "cpu"
            t, l = batch_at_step(spec, want)
            assert np.array_equal(tokens.numpy(), t) and np.array_equal(labels.numpy(), l)
    assert not loader._thread.is_alive()


def test_loader_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Loader(SyntheticSpec(vocab_size=256, seq_len=16, global_batch=2))


# ---------------------------------------------------------------------------
# the two repairs
# ---------------------------------------------------------------------------
def test_prefill_capacity_reproduces_the_reference_drops():
    """At the published capacity factor 1.25 the reference's prefill (a row
    at its power-of-two bucket, sorted dispatch) drops assignments, and
    ``prefill_model(moe_capacity=capacity(bucket))`` gives its logits; the
    dropless ``prefill_model`` (what ServingEngine and RotaryEngine run)
    gives the reference's logits at a dropless capacity instead."""
    jc, tc = _configs("qwen36-35b-a3b", cf=1.25)
    jparams = _jparams(jc)
    tparams = from_reference(tc, jax.tree.map(np.asarray, jparams))
    s, bucket = 27, 32
    prompt = np.random.default_rng(3).integers(0, tc.vocab_size, (1, s)).astype(np.int32)
    padded = np.zeros((1, bucket), np.int32)
    padded[:, :s] = prompt
    rt = jtfm.Runtime(cache_len=64)

    def jprefill(cfg):
        return np.asarray(jax.jit(lambda p, t: jtfm.prefill_model(
            cfg, p, t, rt, last_index=jnp.asarray([s - 1]))[0])(jparams, jnp.asarray(padded)))

    drops = jprefill(jc)
    dropless = jprefill(dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                                        capacity_factor=8.0)))
    assert np.abs(drops - dropless).max() > 1e-2            # the drops change the logits
    cap = tmoe.capacity(tc.moe, bucket)
    assert cap == max(jc.moe.top_k, int(np.ceil(bucket * 2 / 8 * 1.25)))
    got, _ = ttfm.prefill_model(tc, tparams, _t(prompt), 64, moe_capacity=cap)
    _close(got, drops, **LOGIT_TOL)
    served, _ = ttfm.prefill_model(tc, tparams, _t(prompt), 64)
    _close(served, dropless, **LOGIT_TOL)


def test_sorted_dispatch_and_capacity_keep_match_the_reference():
    """``sorted_dispatch`` gives the reference's buffer and destinations
    (token-major drops), and ``capacity_keep`` its kept assignments, on ids
    with heavy collisions."""
    rng = np.random.default_rng(4)
    ids = np.stack([rng.permutation(6)[:3] for _ in range(40)]).astype(np.int32)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    for cap in (3, 7, 40):
        jbuf, jdest, jtok = jmoe.sorted_dispatch(jnp.asarray(x), jnp.asarray(ids), 6, cap)
        buf, dest, tok = tmoe.sorted_dispatch(_t(x), _t(ids).long(), 6, cap)
        assert np.array_equal(buf.numpy(), np.asarray(jbuf))
        assert np.array_equal(dest.numpy(), np.asarray(jdest))
        assert np.array_equal(tok.numpy(), np.asarray(jtok))
        assert np.array_equal(tmoe.capacity_keep(_t(ids).long(), cap).numpy(),
                              (np.asarray(jdest) >= 0).reshape(40, 3))


@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen36-35b-a3b"])
def test_eager_decode_row_alone_equals_the_batch(arch):
    """A row alone inside the batch's allocation (``prefill_model(rows=4)``,
    the other rows empty; ``decode_model`` pads them) gives, at every
    step, the bits it gives in the batch of 4."""
    tc = treduce(tget(arch))
    params = ttfm.init_params(tc, 0, "cpu")
    prompt = _t(np.random.default_rng(5).integers(0, tc.vocab_size, (4, 10)).astype(np.int32))

    def greedy(tokens, rows):
        logits, state = ttfm.prefill_model(tc, params, tokens, 32, rows=rows)
        out = [logits]
        for j in range(3):
            logits, _ = ttfm.decode_model(tc, params, torch.argmax(logits, -1), state, 10 + j)
            out.append(logits)
        return torch.stack(out, 1)

    batch = greedy(prompt, 4)
    for i in range(4):
        assert torch.equal(greedy(prompt[i:i + 1], 4)[0], batch[i])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train

    argv = ["train", "--arch", "qwen36-35b-a3b", "--device", "cpu", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", argv + ["--steps", "4"])
    train.main()
    out = capsys.readouterr().out
    assert re.search(r"step +3 loss [\d.]+ gnorm [\d.]+ lr", out)
    assert "tokens/s" in out and "MFU not measured" in out
    assert "first step" in out and "checkpoint write finished" in out
    monkeypatch.setattr(sys, "argv", argv + ["--steps", "6"])
    train.main()
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 2 steps" in out
