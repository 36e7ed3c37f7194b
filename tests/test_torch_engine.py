"""The port's RotaryEngine against the JAX RotaryEngine, and the port's own
invariants and boundaries.

Cross-framework: on reduced f32 ``qwen36-35b-a3b`` with the same weights
(``bridge.from_reference``), greedy tokens equal the reference's across full
residency, rotary with 6 of 8 slots, and slot-starved rotary (misses and
suffix replays exercised). Logits are stepped one token at a time; they
agree to 1e-4 (XLA and PyTorch sum in other orders) and the greedy id may
differ only at a step whose top-2 margin is below 1e-3 (the margin guard).

The same under int8 and int4 slot stores (``ResidencyConfig.quantization``),
with the same miss counts as the reference.

Port-internal: full == rotary tokens (also quantized), every miss
host-corrected, one blocking pull per miss-free token. Boundaries: no JAX and nothing of
``repro`` imported by the port, a missing card is an error.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

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
from repro_torch.core.slots import quantized_expert_bytes
from repro_torch.kernels import ops
from repro_torch.models.transformer import Runtime as TRuntime
from repro_torch.models.transformer import init_params as tinit

ROOT = Path(__file__).resolve().parent.parent
STEPS = 8
_CACHE = {}


def _setup():
    if "qwen36" not in _CACHE:
        cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
        tcfg = dataclasses.replace(treduce(tget("qwen36-35b-a3b")), dtype="float32")
        params = jax.jit(init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        _CACHE["qwen36"] = (cfg, params, tcfg, jax.tree.map(np.asarray, params))
    return _CACHE["qwen36"]


def _steps(engine, prompt):
    """Greedy tokens and the logits that chose them, one decode call per token."""
    logits = [np.asarray(engine.prefill(prompt), np.float32)]
    toks = []
    for _ in range(STEPS):
        toks.append(engine.decode(logits[-1], 1)[:, 0])
        logits.append(np.asarray(engine.last_logits, np.float32))
    return np.stack(toks, 1), np.stack(logits[:-1], 1)


def _tokens_equal_jax_tokens(slots, **quant):
    cfg, params, tcfg, np_params = _setup()
    mode = "full" if slots == 0 else "rotary"
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    je = JEngine(cfg, params, JRes(mode=mode, num_slots=slots, prefetch_margin=1, **quant),
                 rt=JRuntime(cache_len=32), batch=2)
    te = TEngine(tcfg, from_reference(tcfg, np_params),
                 TRes(mode=mode, num_slots=slots, prefetch_margin=1, **quant),
                 rt=TRuntime(cache_len=32), batch=2, device="cpu")
    jt, jl = _steps(je, prompt)
    tt, tl = _steps(te, prompt)
    diverged = np.flatnonzero((jt != tt).any(axis=0))
    stop = diverged[0] if diverged.size else STEPS
    np.testing.assert_allclose(tl[:, :stop], jl[:, :stop], atol=1e-4, rtol=1e-4)
    if diverged.size:                     # only a near-tie may flip a greedy id
        top2 = np.sort(jl[:, stop], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() < 1e-3, (jt, tt)
    else:
        assert te.stats.misses == je.stats.misses
    if slots == 3:                        # slot-starved: misses and replays exercised
        assert te.stats.misses > 0 and te.stats.replayed_steps > 0
        assert te.stats.misses == je.stats.misses
    if slots == 0:
        assert te.stats.misses == 0
    return te


@pytest.mark.parametrize("slots", [0, 6, 3])
def test_port_tokens_equal_jax_tokens(slots):
    _tokens_equal_jax_tokens(slots)


@pytest.mark.parametrize("quantization,group", [("int8", 64), ("int4", 16)])
@pytest.mark.parametrize("slots", [0, 6, 3])
def test_quantized_port_tokens_equal_jax_tokens(slots, quantization, group):
    """int8 and int4 slot stores (int4 in groups of 16: four groups per
    gate/up column, three per down column): the same tokens and misses as
    the JAX engine, whose slots dequantize to f32 and whose misses GEMM
    against dequant(quant(w))."""
    te = _tokens_equal_jax_tokens(slots, quantization=quantization, quant_group_size=group)
    if slots == 3:
        assert te.stats.host_dequant_experts > 0
        assert all("scale_w_up" in hw for hw in te.host_experts)     # packed warehouse only


def test_full_equals_rotary_and_misses_are_host_corrected():
    _, _, tcfg, np_params = _setup()
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 10)).astype(np.int32)
    out = {}
    for mode, slots in (("full", 0), ("rotary", 3)):
        eng = TEngine(tcfg, from_reference(tcfg, np_params),
                      TRes(mode=mode, num_slots=slots, prefetch_margin=1),
                      rt=TRuntime(cache_len=32), batch=1, device="cpu")
        out[mode] = (eng.generate(prompt, 12), eng.stats)
    np.testing.assert_array_equal(out["full"][0], out["rotary"][0])
    s = out["rotary"][1]
    assert s.misses > 0
    assert sum(l.host_computed for l in s.layers.values()) == s.misses


@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_quantized_full_equals_rotary(quantization):
    """A miss dequantizes its expert from the packed warehouse and adds what
    a resident slot computes: full and slot-starved rotary give one token
    stream, and every upload ships one packed expert's bytes."""
    _, _, tcfg, np_params = _setup()
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 10)).astype(np.int32)
    out = {}
    for mode, slots in (("full", 0), ("rotary", 3)):
        eng = TEngine(tcfg, from_reference(tcfg, np_params),
                      TRes(mode=mode, num_slots=slots, prefetch_margin=1,
                           quantization=quantization, quant_group_size=16),
                      rt=TRuntime(cache_len=32), batch=1, device="cpu")
        out[mode] = (eng.generate(prompt, 12), eng.stats)
    np.testing.assert_array_equal(out["full"][0], out["rotary"][0])
    s = out["rotary"][1]
    assert s.misses > 0
    assert sum(l.host_computed for l in s.layers.values()) == s.misses
    shapes = {"w_gate": (tcfg.d_model, tcfg.moe.expert_d_ff),
              "w_up": (tcfg.d_model, tcfg.moe.expert_d_ff),
              "w_down": (tcfg.moe.expert_d_ff, tcfg.d_model)}
    loads = sum(l.loads for l in s.layers.values())
    assert s.bytes_uploaded == loads * quantized_expert_bytes(shapes, quantization, 4, 16)


def test_one_blocking_pull_per_miss_free_token():
    cfg = dataclasses.replace(treduce(tget("qwen2-moe-a2.7b")), dtype="float32")
    eng = TEngine(cfg, tinit(cfg, 0, "cpu"), TRes(mode="full"), rt=TRuntime(cache_len=32),
                  batch=2, device="cpu")
    logits = eng.prefill(np.zeros((2, 5), np.int32))
    pulls, disp = eng.stats.sync_pulls, eng.stats.device_dispatches
    ops.reset_launch_counts()
    eng.decode(logits, 6)
    assert eng.stats.sync_pulls - pulls == 6
    assert eng.stats.device_dispatches - disp == 6
    assert eng.stats.misses == 0 and eng.stats.replayed_steps == 0
    assert eng.stats.overlapped_pulls == 4 * 6
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}   # CPU: plain path only


def test_traced_engine_records_launch_pull_and_rotation_spans():
    from repro_torch.obs import Tracer

    cfg = dataclasses.replace(treduce(tget("qwen36-35b-a3b")), dtype="float32")
    tr = Tracer()
    eng = TEngine(cfg, tinit(cfg, 0, "cpu"), TRes(mode="rotary", num_slots=3, prefetch_margin=1),
                  rt=TRuntime(cache_len=32), batch=1, device="cpu", trace=tr)
    eng.generate(np.arange(6, dtype=np.int32)[None], 4)
    names = {rec[1] for rec in tr.records()}
    assert {"launch", "pull", "rotation", "upload"} <= names
    if eng.stats.replayed_steps:
        assert {"miss", "replay"} <= names


def test_missing_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = treduce(tget("qwen36-35b-a3b"))
    params = tinit(cfg, 0, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(cfg, params, TRes(mode="full"), device="cuda")
    with pytest.raises(RuntimeError):
        TEngine(cfg, params, TRes(mode="full"))               # the default device is cuda


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.bridge, repro_torch.core.engine, "
        "repro_torch.launch.serve, repro_torch.kernels.ops, repro_torch.configs, "
        "repro_torch.quant, repro_torch.training, repro_torch.data, repro_torch.checkpoint, "
        "repro_torch.launch.train\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:\.|\s|$)", re.M)
    hits = [str(p) for p in (ROOT / "src" / "repro_torch").rglob("*.py")
            if pat.search(p.read_text())]
    assert not hits, hits


def test_serve_cli_runs_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen36-35b-a3b", "--device", "cpu",
                                      "--requests", "1", "--max-new", "3", "--slots", "4",
                                      "--layers", "1"])
    serve.main()
    out = capsys.readouterr().out
    assert re.search(r"req 0: \[\d+, \d+, \d+\]", out) and "hit_rate" in out


def test_serve_cli_runs_quantized_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen36-35b-a3b", "--device", "cpu",
                                      "--requests", "1", "--max-new", "3", "--slots", "4",
                                      "--layers", "1", "--quantization", "int4",
                                      "--quant-group", "16"])
    serve.main()
    out = capsys.readouterr().out
    assert re.search(r"req 0: \[\d+, \d+, \d+\]", out) and "hit_rate" in out
