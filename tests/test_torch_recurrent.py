"""The port's recurrent families against the JAX package.

On the same numpy-seeded inputs and the reference's weights
(``bridge.from_reference``), f32:

* the RG-LRU, mLSTM and sLSTM blocks (``models/rglru.py``,
  ``models/xlstm.py``): prefill from the zero state and three decode steps
  against ``repro.models.rglru`` / ``xlstm``, outputs and states; in the
  port, decode after a prefill equals a prefill over the longer sequence,
  and the state's shapes do not grow with the sequence;
* reduced ``recurrentgemma-2b`` (window 16 under a 20-token prompt, so the
  ring cache wraps) and ``xlstm-350m``: ``prefill_model`` and three
  ``decode_model`` steps against JAX's, logits and greedy tokens;
* ``bridge.from_reference`` carries the recurrent subtrees (``ln`` /
  ``cell``, ``ln1`` / ``rec`` / ``ln2`` / ``mlp``) with their f32 leaves in
  a bf16 config; the port's own init has the reference's layout and
  ``analytic_params`` counts it.

Tolerance: 1e-4 absolute + 1e-4 relative on f32 outputs and logits (the
RG-LRU scan groups its sums otherwise than ``lax.associative_scan``, and XLA
and PyTorch sum matmuls in other orders); tokens exact. The JAX references
run under ``jax.jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget
from repro.config.base import RecurrentConfig as JRec
from repro.configs import reduce_for_smoke as jreduce
from repro.models import init_params as jinit
from repro.models import params as jparams
from repro.models import rglru as jrglru
from repro.models import transformer as jtfm
from repro.models import xlstm as jxlstm
from repro_torch.bridge import from_reference, to_tensor
from repro_torch.config import get_config as tget
from repro_torch.config.base import RecurrentConfig as TRec
from repro_torch.configs import RECURRENT_ARCHS
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.models import params as tparams_mod
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm

TOL = dict(atol=1e-4, rtol=1e-4)
D, S, STEPS = 64, 9, 3
KINDS = ("rglru", "mlstm", "slstm")
JAX_FNS = {"rglru": (jrglru.init_rglru, jrglru.rglru_prefill, jrglru.rglru_decode),
           "mlstm": (jxlstm.init_mlstm, jxlstm.mlstm_prefill, jxlstm.mlstm_decode),
           "slstm": (jxlstm.init_slstm, jxlstm.slstm_prefill, jxlstm.slstm_decode)}
PORT_FNS = {"rglru": (trglru.rglru_prefill, trglru.rglru_decode, trglru.rglru_zero_state),
            "mlstm": (txlstm.mlstm_prefill, txlstm.mlstm_decode, txlstm.mlstm_zero_state),
            "slstm": (txlstm.slstm_prefill, txlstm.slstm_decode, txlstm.slstm_zero_state)}
_CACHE = {}


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **TOL)


def _cell(kind):
    """(jax params, port params, jax cfg, port cfg) of one block at width D."""
    jcfg, tcfg = JRec(lru_width=D, num_heads=2), TRec(lru_width=D, num_heads=2)
    p = JAX_FNS[kind][0](jax.random.PRNGKey(0), D, jcfg, jnp.float32)
    return p, {k: to_tensor(np.asarray(v)) for k, v in p.items()}, jcfg, tcfg


def _x(seed=0, s=S + STEPS):
    return np.random.default_rng(seed).standard_normal((2, s, D)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_block_prefill_and_decode_match_jax(kind):
    """Prefill from the zero state, then three decode steps: outputs and
    every state leaf within 1e-4 of JAX's."""
    p, tp, jcfg, tcfg = _cell(kind)
    _, prefill, decode = JAX_FNS[kind]
    tprefill, tdecode, _ = PORT_FNS[kind]
    x = _x()
    jy, jst = jax.jit(prefill, static_argnums=2)(p, jnp.asarray(x[:, :S]), jcfg)
    ty, tst = tprefill(tp, torch.from_numpy(x[:, :S]), tcfg)
    _close(ty, jy)
    jdec = jax.jit(decode)
    for t in range(S, S + STEPS):
        jy, jst = jdec(p, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tdecode(tp, torch.from_numpy(x[:, t:t + 1]), tst)
        _close(ty, jy)
    assert set(tst) == set(jst)
    for name in tst:
        _close(tst[name], jst[name])


@pytest.mark.parametrize("kind", KINDS)
def test_decode_after_prefill_equals_the_longer_prefill(kind):
    """In the port: decode steps after a prefill give the outputs a prefill
    over the longer sequence gives at those positions, and its state."""
    _, tp, _, tcfg = _cell(kind)
    tprefill, tdecode, _ = PORT_FNS[kind]
    x = torch.from_numpy(_x(1))
    want, want_state = tprefill(tp, x, tcfg)
    _, st = tprefill(tp, x[:, :S], tcfg)
    for t in range(S, S + STEPS):
        y, st = tdecode(tp, x[:, t:t + 1], st)
        torch.testing.assert_close(y, want[:, t:t + 1], **TOL)
    for name in st:
        torch.testing.assert_close(st[name], want_state[name], **TOL)


def test_state_is_constant_in_sequence_length():
    """Each block's state after 4 and after 40 positions has the zero
    state's shapes: nothing grows with the sequence."""
    for kind in KINDS:
        _, tp, _, tcfg = _cell(kind)
        tprefill, _, zero = PORT_FNS[kind]
        shapes = {n: t.shape for n, t in zero(2, D, tcfg, "cpu").items()}
        for s in (4, 40):
            _, st = tprefill(tp, torch.from_numpy(_x(2, s)), tcfg)
            assert {n: t.shape for n, t in st.items()} == shapes, (kind, s)


def _setup(arch, dtype="float32"):
    key = (arch, dtype)
    if key not in _CACHE:
        cfg = dataclasses.replace(jreduce(jget(arch)), dtype=dtype)
        tcfg = dataclasses.replace(treduce(tget(arch)), dtype=dtype)
        params = jax.jit(jinit, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        _CACHE[key] = (cfg, params, tcfg, from_reference(tcfg, jax.tree.map(np.asarray, params)))
    return _CACHE[key]


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_prefill_and_decode_model_match_jax(arch):
    """``prefill_model`` over 20 tokens (recurrentgemma's reduced window is
    16: the ring wraps) and three ``decode_model`` steps: logits within
    1e-4 of JAX's at every step and the same greedy tokens."""
    cfg, params, tcfg, tparams = _setup(arch)
    prompt = 20
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt + STEPS))
    tokens = tokens.astype(np.int32)
    rt = jtfm.Runtime(cache_len=32)
    jl, state = jax.jit(jtfm.prefill_model, static_argnums=(0, 3))(
        cfg, params, jnp.asarray(tokens[:, :prompt]), rt)
    tl, tstate = ttfm.prefill_model(tcfg, tparams, torch.from_numpy(tokens[:, :prompt]), 32)
    _close(tl, jl)
    decode = jax.jit(jtfm.decode_model, static_argnums=(0, 5))
    for t in range(STEPS):
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
        tok = tokens[:, prompt + t]
        jl, state, _ = decode(cfg, params, jnp.asarray(tok), state, jnp.int32(prompt + t), rt)
        tl, aux = ttfm.decode_model(tcfg, tparams, torch.from_numpy(tok), tstate, prompt + t)
        _close(tl, jl)
        assert aux == {}


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_bridge_carries_the_recurrent_subtrees(arch):
    """A bf16 config: every layer keeps the reference's subtree (``ln`` /
    ``cell`` for xLSTM, ``ln1`` / ``rec`` / ``ln2`` / ``mlp`` for RG-LRU,
    the attention layout for local attention) with each leaf's type, the
    f32 gate weights included; the port's own init builds the same layout,
    and ``analytic_params`` counts it."""
    cfg, params, tcfg, tparams = _setup(arch, "bfloat16")
    layouts = {"mlstm": {"ln", "cell"}, "slstm": {"ln", "cell"},
               "rglru": {"ln1", "rec", "ln2", "mlp"}, "local_attn": {"ln1", "attn", "ln2", "mlp"}}
    mine = ttfm.init_params(tcfg, 0, "cpu")
    j = 0
    for si, (unit, reps) in enumerate(cfg.segments):
        for r in range(reps):
            for pi, kind in enumerate(unit):
                ref_layer = jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                                         params["segments"][si][pi])
                got, own = tparams["layers"][j], mine["layers"][j]
                assert set(got) == set(own) == layouts[kind]
                flat_ref = jax.tree_util.tree_leaves_with_path(ref_layer)
                for path, leaf in flat_ref:
                    t = got
                    for k in path:
                        t = t[k.key]
                    assert t.dtype == to_tensor(leaf).dtype and tuple(t.shape) == leaf.shape
                j += 1
    sub = tparams["layers"][0]["rec" if "rglru" in tcfg.layer_kinds else "cell"]
    assert any(t.dtype == torch.float32 for t in sub.values())
    n = sum(t.numel() for layer in mine["layers"] for sub in layer.values()
            for t in sub.values())
    n += mine["embed"].numel() + mine["final_norm"]["scale"].numel()
    assert n == tparams_mod.analytic_params(tcfg) == jparams.analytic_params(cfg)
