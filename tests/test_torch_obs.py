"""The port's trace surface against the JAX package's: the contract auditor
(``repro_torch.obs.audit``), the engines' spans, and the serve CLI's
``--trace-out`` / ``--metrics-port``.

* The auditors: the reference's hand-built traces (a clean pair of units,
  a double pull, a rotation inside a window, a prefetch ship before the
  launch and past the pull, a KV page used after release and released
  twice, a missed unit with a relaunch) give the same ``summary()`` and the
  same violations through both packages' auditors.
* ``RotaryEngine`` on reduced f32 ``qwen36-35b-a3b`` (the reference's
  weights through ``bridge.from_reference``), rotary at 6 of 8 slots, one
  8-token prompt and 4 new tokens, in the reference's four traced modes
  (fused steps, windows of 2, chunks of 8, prefetch with windows of 2):
  the port's trace passes both auditors, and unit by unit it has JAX's unit
  kinds and JAX's counts of each contract event.
* ``ServingEngine``: paged, rotary at 6 of 8 slots, windows up to 2, 16
  pages of 8, three requests over 2 rows; and the group tick on reduced
  ``recurrentgemma-2b``: both auditors pass, tick by tick the counts equal
  JAX's, and each request's lane holds JAX's events (the paged lanes
  ``queued``, ``prefill`` and ``finish``).
* A traced run and an untraced one give the same tokens and counters (both
  engines), and a disabled tracer is no tracer; the span-derived prefetch
  overlap equals ``stats.overlap_ms``.
* ``serve.main`` with ``--trace-out`` and ``--metrics-port``: its trace
  audits with exit code 0 through ``repro_torch.obs``'s ``main`` (and 1 with
  a planted violation, also as ``python -m repro_torch.obs``), a loopback
  scrape shows the latency histograms, and ``tools/trace_view.py`` reads
  the trace.
"""
import copy
import dataclasses
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from urllib.request import urlopen

import numpy as np
import pytest

from repro.config import ResidencyConfig as JRes
from repro.core import RotaryEngine as JEngine
from repro.models.transformer import Runtime as JRuntime
from repro.obs import Tracer as JTracer
from repro.obs import audit as jaudit
from repro.serving import ServingEngine as JServing
from repro_torch.config import ResidencyConfig as TRes
from repro_torch.core.engine import RotaryEngine as TEngine
from repro_torch.models.transformer import Runtime as TRuntime
from repro_torch.obs import AuditError, Tracer, audit, resolve_tracer, serve_metrics
from repro_torch.obs.audit import main as audit_main
from repro_torch.serving import ServingEngine as TServing
from test_torch_group_tick import _setup as _group_setup
from test_torch_serving import _port_params
from test_torch_walk import _setup

ROOT = Path(__file__).resolve().parents[1]
# the events the contract units are made of, counted per unit
UNIT_EVENTS = ("launch", "pull", "rotation", "miss", "replay", "kv_snapshot", "kv_rollback",
               "prefetch_ship", "kv_use", "kv_reserve", "kv_ensure", "kv_release")


# ===========================================================================
# the auditors on the reference's hand-built traces
# ===========================================================================
def _ev(name, ts, dur=None, unit=1, cat="launch", **args):
    e = {"ph": "X" if dur is not None else "i", "name": name, "pid": 1,
         "tid": 0, "ts": ts, "cat": cat, "args": {"unit": unit, **args}}
    if dur is not None:
        e["dur"] = dur
    return e


def _clean_unit(unit=1, t0=0.0):
    return [
        _ev("launch", t0, 100.0, unit),
        _ev("prefetch_ship", t0 + 10, 20.0, unit, cat="prefetch"),
        _ev("pull", t0 + 110, 50.0, unit, cat="pull"),
        _ev("rotation", t0 + 170, 30.0, unit, cat="rotation"),
    ]


_KV = [
    _ev("kv_ensure", 0.0, None, cat="kv_pool", uid=1, pages=[3, 4]),
    _ev("kv_use", 10.0, None, cat="kv_pool", pages=[3, 4]),
    _ev("kv_release", 20.0, None, cat="kv_pool", uid=1, pages=[3, 4]),
]
SYNTHETIC = {
    "clean": (_clean_unit(1) + _clean_unit(2, 1000.0), None),
    "double_pull": (_clean_unit() + [_ev("pull", 200.0, 10.0, cat="pull")], "2 primary pulls"),
    "rotation_mid_window": ([_ev("launch", 0.0, 100.0), _ev("rotation", 50.0, 30.0,
                                                            cat="rotation"),
                             _ev("pull", 110.0, 50.0, cat="pull")], "mid-window"),
    "prefetch_before_launch": ([_ev("prefetch_ship", 0.0, 5.0, cat="prefetch"),
                                _ev("launch", 10.0, 100.0), _ev("pull", 120.0, 50.0, cat="pull")],
                               "before the launch"),
    "prefetch_past_pull": ([_ev("launch", 0.0, 100.0),
                            _ev("prefetch_ship", 90.0, 200.0, cat="prefetch"),
                            _ev("pull", 110.0, 50.0, cat="pull")], "overruns the pull"),
    "kv_use_after_free": (_KV + [_ev("kv_use", 30.0, None, cat="kv_pool", pages=[4])],
                          "after release"),
    "kv_double_release": (_KV + [_ev("kv_release", 40.0, None, cat="kv_pool", uid=1,
                                     pages=[3])], "double release"),
    "exempt_relaunch": ([_ev("launch", 0.0, 100.0), _ev("miss", 105.0, None),
                         _ev("pull", 110.0, 50.0, cat="pull"),
                         _ev("launch", 200.0, 40.0, kind="relaunch"),
                         _ev("pull", 250.0, 10.0, cat="pull", kind="relaunch"),
                         _ev("rotation", 270.0, 30.0, cat="rotation")], None),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_auditors_agree_on_synthetic_traces(case):
    """Each of the reference's hand-built traces: the port's auditor gives
    JAX's ``summary()`` and violations, and flags what JAX's flags."""
    events, flagged = SYNTHETIC[case]
    got, want = audit(copy.deepcopy(events)), jaudit(copy.deepcopy(events))
    assert got.summary() == want.summary()
    assert got.violations == want.violations
    assert got.overlap_ms == want.overlap_ms
    if flagged is None:
        assert got.ok and got.units_checked >= 1
        got.raise_for_violations()
    else:
        assert any(flagged in v for v in got.violations), got.violations
        with pytest.raises(AuditError):
            got.raise_for_violations()


# ===========================================================================
# RotaryEngine: the four traced modes against JAX's traces of the same run
# ===========================================================================
def _events(trace):
    out = trace.chrome_trace() if hasattr(trace, "chrome_trace") else trace
    return [e for e in out["traceEvents"] if e["ph"] != "M"]


def units(trace):
    """Per unit, in order: (its kind, the counts of its contract events)."""
    per = {}
    for e in _events(trace):
        u = e["args"]["unit"]
        if u <= 0:
            continue
        kind, counts = per.setdefault(u, [None, Counter()])
        if e["name"] == "unit":
            per[u][0] = e["args"]["kind"]
        elif e["name"] in UNIT_EVENTS:
            counts[e["name"]] += 1
    return [(kind, dict(counts)) for _, (kind, counts) in sorted(per.items())]


def lanes(trace):
    """Per request lane: the counts of its events."""
    per = {}
    for e in _events(trace):
        if e["pid"] == 2:
            per.setdefault(e["tid"], Counter())[e["name"]] += 1
    return {uid: dict(c) for uid, c in per.items()}


def _both_audit(trace):
    """Both auditors pass the trace with equal reports; returns the port's."""
    out = trace.chrome_trace()
    rep, jrep = audit(copy.deepcopy(out)), jaudit(copy.deepcopy(out))
    rep.raise_for_violations()
    jrep.raise_for_violations()
    assert rep.summary() == jrep.summary()
    return rep


MODES = {
    "fused": {},
    "spec2": {"spec_k": 2},
    "chunk8": {"prefill_chunk": 8},
    "prefetch_spec2": {"prefetch": True, "spec_k": 2},
}
STEPS = 4
_RUNS = {}


def _rotary(pkg, mode, trace=True, steps=STEPS):
    """The mode's engine at rotary 6/8 slots after one 8-token prompt and
    ``steps`` greedy tokens: (engine, tokens, tracer)."""
    cfg, params, tcfg, _ = _setup()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    kw = MODES[mode]
    if pkg == "jax":
        tr = JTracer()
        eng = JEngine(cfg, params, JRes(mode="rotary", num_slots=6), rt=JRuntime(cache_len=64),
                      batch=1, trace=tr, **kw)
    else:
        tr = Tracer() if trace else None
        eng = TEngine(tcfg, _port_params(), TRes(mode="rotary", num_slots=6),
                      rt=TRuntime(cache_len=64), batch=1, trace=tr, device="cpu", **kw)
    return eng, np.asarray(eng.generate(prompt, steps)), tr


def _rotary_runs(mode):
    if mode not in _RUNS:
        _RUNS[mode] = (_rotary("jax", mode), _rotary("torch", mode))
    return _RUNS[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_rotary_traces_pass_both_auditors_with_jax_units(mode):
    (je, jtok, jtr), (te, ttok, ttr) = _rotary_runs(mode)
    np.testing.assert_array_equal(ttok, jtok)
    rep = _both_audit(ttr)
    assert rep.units_checked > 0 and rep.launches > 0 and rep.pulls > 0 and rep.rotations > 0
    assert units(ttr) == units(jtr)
    kinds = {k for k, _ in units(ttr)}
    assert {"window" if "spec" in mode else "decode"} <= kinds
    if mode == "chunk8":
        assert "chunk" in kinds
    if "spec" in mode:
        assert sum(c.get("kv_snapshot", 0) for _, c in units(ttr)) > 0
    if mode == "prefetch_spec2":
        assert rep.prefetch_spans > 0


def test_span_overlap_equals_stats_overlap_ms():
    """The prefetch_ship spans cover the interval the residency manager's
    wall-clock ``overlap_ms`` adds up."""
    _, (te, _, ttr) = _rotary_runs("prefetch_spec2")
    assert te.stats.overlap_ms > 0
    assert ttr.overlap_ms() == pytest.approx(te.stats.overlap_ms, rel=0.01, abs=1e-3)
    assert audit(ttr).overlap_ms == pytest.approx(ttr.overlap_ms(), abs=0.01)


def _counters(stats):
    """Every count of an ``EngineStats`` (its ints, per layer too; the
    floats are times)."""
    out = {k: v for k, v in dataclasses.asdict(stats).items() if isinstance(v, int)}
    out["layers"] = {l: dataclasses.asdict(ls) for l, ls in stats.layers.items()}
    return out


def test_rotary_traced_equals_untraced_and_disabled_is_no_tracer():
    _, (te, ttok, _) = _rotary_runs("prefetch_spec2")
    off, otok, _ = _rotary("torch", "prefetch_spec2", trace=False)
    assert off._tr is None and off.tracer is None
    np.testing.assert_array_equal(otok, ttok)
    assert _counters(off.stats) == _counters(te.stats)
    dis = Tracer(enabled=False)
    assert resolve_tracer(dis) is None
    eng = TEngine(_setup()[2], _port_params(), TRes(mode="full"), rt=TRuntime(cache_len=64),
                  batch=1, trace=dis, device="cpu")
    assert eng._tr is None and eng.tracer is None and eng.manager.tracer is None


# ===========================================================================
# ServingEngine: the paged ticks and the group tick against JAX's traces
# ===========================================================================
def _serve(pkg, kind, trace=True):
    """(engine, tokens per request, uids, tracer) of the serving case."""
    if kind == "paged":
        cfg, params, tcfg, _ = _setup()
        tparams = _port_params()
        lens, kw = (6, 6, 6), dict(residency=dict(mode="rotary", num_slots=6), spec_cap=2,
                                   kv_pages=16, kv_page_size=8)
    else:
        cfg, params, tcfg, tparams = _group_setup("recurrentgemma-2b")
        lens, kw = (5, 20, 9), {}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    res = kw.pop("residency", None)
    if pkg == "jax":
        tr = JTracer()
        eng = JServing(cfg, params, rt=JRuntime(cache_len=64), num_slots=2,
                       residency=JRes(**res) if res else None, trace=tr, **kw)
    else:
        tr = Tracer() if trace else None
        eng = TServing(tcfg, tparams, rt=TRuntime(cache_len=64), num_slots=2,
                       residency=TRes(**res) if res else None, trace=tr, device="cpu", **kw)
    reqs = [eng.submit(p, max_new=4) for p in prompts]
    eng.run()
    return eng, [r.output for r in reqs], [r.uid for r in reqs], tr


_SERVES = {}


def _serve_runs(kind):
    if kind not in _SERVES:
        _SERVES[kind] = (_serve("jax", kind), _serve("torch", kind))
    return _SERVES[kind]


@pytest.mark.parametrize("kind", ["paged", "group"])
def test_serving_traces_pass_both_auditors_with_jax_ticks_and_lanes(kind):
    (je, jout, _, jtr), (te, tout, uids, ttr) = _serve_runs(kind)
    assert tout == jout
    assert te._paged == (kind == "paged")
    rep = _both_audit(ttr)
    assert rep.units_checked == te.stats.sync_pulls > 0
    assert rep.launches == rep.pulls == rep.units_checked
    assert units(ttr) == units(jtr)
    assert {k for k, _ in units(ttr)} == {"tick"}
    got = lanes(ttr)
    assert set(got) == set(uids)
    assert got == lanes(jtr)
    if kind == "paged":
        assert rep.kv_events > 0 and rep.rotations > 0
        assert te.stats.misses > 0 and any("miss" in c for _, c in units(ttr))
        for uid in uids:
            assert {"queued", "prefill", "finish"} <= set(got[uid])
    else:
        for uid in uids:
            assert {"queued", "prefill"} <= set(got[uid])


def test_serving_traced_equals_untraced_and_disabled_is_no_tracer():
    _, (te, tout, _, _) = _serve_runs("paged")
    off, oout, _, _ = _serve("torch", "paged", trace=False)
    assert off._tr is None and off.tracer is None and off.pool.tracer is None
    assert oout == tout
    assert _counters(off.stats) == _counters(te.stats)
    dis = TServing(_setup()[2], _port_params(), rt=TRuntime(cache_len=64), num_slots=2,
                   residency=TRes(mode="rotary", num_slots=6), trace=Tracer(enabled=False),
                   device="cpu")
    assert dis._tr is None and dis.tracer is None
    assert dis.pool.tracer is None and dis.res_mgr.tracer is None


# ===========================================================================
# the serve CLI, python -m repro_torch.obs, the metrics scrape, trace_view
# ===========================================================================
def test_serve_cli_trace_audits_and_metrics_scrape(tmp_path, capsys):
    from repro_torch.launch import serve

    path = tmp_path / "cli.json"
    serve.main(["--arch", "qwen36-35b-a3b", "--engine", "batch", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--prompt-len", "16", "--cache-len", "32",
                "--batch-slots", "2", "--slots", "8", "--trace-out", str(path),
                "--metrics-port", str(_free_port())])
    out = capsys.readouterr().out
    assert re.search(r"trace: \d+ events -> ", out)
    assert re.search(r"histograms .*itl_ms.*ttft_ms", out), out
    assert audit_main([str(path)]) == 0
    assert "audit:" in capsys.readouterr().out
    trace = json.loads(path.read_text())
    missed = {e["args"]["unit"] for e in trace["traceEvents"] if e.get("name") == "miss"}
    pulls = [e for e in trace["traceEvents"]
             if e.get("name") == "pull" and e["args"]["unit"] not in missed]
    bad = dict(trace, traceEvents=trace["traceEvents"] + [dict(pulls[0])])   # a second pull
    planted = tmp_path / "planted.json"
    planted.write_text(json.dumps(bad))
    assert audit_main([str(planted)]) == 1
    assert "VIOLATION" in capsys.readouterr().out
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs", str(planted)], env=env,
                         capture_output=True, text=True)
    assert res.returncode == 1 and "primary pulls" in res.stdout, res.stderr
    view = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_view.py"), str(path),
                           "--top", "3", "--track", "launch"], capture_output=True, text=True)
    assert view.returncode == 0 and "launch" in view.stdout, view.stderr


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_loopback_scrape_shows_latency_histograms():
    _, (te, _, _, _) = _serve_runs("paged")
    server = serve_metrics(te.metrics_registry, 0)
    try:
        body = urlopen(f"http://127.0.0.1:{server.server_address[1]}/metrics").read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert "# TYPE ttft_ms histogram" in body and "ttft_ms_count 3\n" in body
    assert "# TYPE itl_ms histogram" in body and "itl_ms_count 9\n" in body   # 3 x 3 gaps
    assert "engine_windows" in body
