"""Elastic restore, fault tolerance and the world harness.

* Fault tolerance: the reference's cases (``tests/test_fault_tolerance.py``)
  and one scripted event sequence (heartbeats, step times, checks and
  resumes drawn from a seed), each run on the reference's coordinator and
  on the port's: the same states, restart logs, live workers and backoff.
* Elastic restore: a checkpoint saved by this process (no mesh) restored
  by ``restore_elastic`` in one world of four ``gloo`` ranks onto a
  2-rank ("data",) mesh (each shard its slice), onto a (2, 2) mesh with a
  leaf split over ("data", "model") (gathered back whole by
  ``gather_tensor``), and replicated (every leaf whole on every rank).
* ``distributed/world.py``: a rank that raises ends the world at once with
  its traceback; a world that outlives its timeout is killed and named;
  the backend choice.
"""
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch.distributed.world import WorldError, choose_backend, run_world

WORLD, TIMEOUT = 4, 120


# ---------------------------------------------------------------------------
# Fault tolerance: the same scripts on both coordinators
# ---------------------------------------------------------------------------
def _timeout_script(C, S):
    c = C(4, timeout_s=10.0, min_workers=3)
    for w in range(4):
        c.heartbeat(w, now=0.0)
    out = [c.check(5.0).value]
    for w in range(3):
        c.heartbeat(w, now=20.0)
    out += [c.check(25.0).value, c.alive_workers(), c.try_resume(26.0), c.state.value]
    return out, c


def _straggler_script(C, S):
    c = C(4, timeout_s=1e9, straggler_factor=3.0, straggler_patience=2, min_workers=3)
    out = []
    for t in range(6):
        for w in range(4):
            c.heartbeat(w, float(t), step_time=1.0 if w != 3 else 10.0)
        out.append(c.check(float(t)).value)
        if c.state is S.RESTARTING:
            break
    return out, c


def _max_restarts_script(C, S):
    c = C(2, timeout_s=1.0, max_restarts=1, min_workers=1)
    c.heartbeat(0, 0.0)
    c.heartbeat(1, 0.0)
    first = c.check(10.0).value
    c2 = C(2, timeout_s=1.0, max_restarts=0, min_workers=1)
    c2.heartbeat(0, 0.0)
    c2.heartbeat(1, 0.0)
    return [first, c2.check(10.0).value], c2


def _backoff_script(C, S):
    c = C(2, timeout_s=1.0, max_restarts=5, min_workers=1)
    out = []
    for r in range(8):
        c.restarts = r
        out.append(c.backoff_s())
    return out, c


def _random_script(C, S):
    """A seeded run of 200 ticks over 6 workers: heartbeats with step times
    (some slow, some missing), a check a tick, a resume when restarting."""
    rng = np.random.default_rng(7)
    c = C(6, timeout_s=3.0, min_workers=3, max_restarts=4, straggler_factor=2.5,
          straggler_patience=2)
    out = []
    for tick in range(200):
        now = float(tick)
        for w in range(6):
            if rng.random() < 0.9:
                c.heartbeat(w, now, step_time=float(rng.choice([1.0, 1.1, 4.0], p=[.7, .25, .05])))
        out.append((c.check(now).value, c.try_resume(now), tuple(c.alive_workers())))
    return out, c


SCRIPTS = {"heartbeat-timeout": _timeout_script, "straggler": _straggler_script,
           "max-restarts": _max_restarts_script, "backoff": _backoff_script,
           "scripted-events": _random_script}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_coordinator_matches_the_reference(name):
    from repro.distributed import fault_tolerance as jft
    from repro_torch.distributed import FaultTolerantCoordinator, JobState
    want, jc = SCRIPTS[name](jft.FaultTolerantCoordinator, jft.JobState)
    got, tc = SCRIPTS[name](FaultTolerantCoordinator, JobState)
    assert got == want
    assert tc.restart_log == jc.restart_log
    assert (tc.state.value, tc.restarts, tc.alive_workers()) == (
        jc.state.value, jc.restarts, jc.alive_workers())
    # the reference's own expectations, on the port
    if name == "heartbeat-timeout":
        assert got[1:] == ["restarting", [0, 1, 2], True, "running"]
    if name == "straggler":
        assert got[-1] == "restarting"
        assert any("straggler" in r["reason"] for r in tc.restart_log)
    if name == "max-restarts":
        assert got[-1] == "failed"
    if name == "backoff":
        assert got[3] > got[1]
    if name == "scripted-events":
        assert tc.restart_log                      # the sequence exercised restarts


# ---------------------------------------------------------------------------
# Elastic restore (one world)
# ---------------------------------------------------------------------------
def _tree():
    return {"w": torch.arange(48, dtype=torch.float32).reshape(8, 6),
            "layers": [{"b": torch.arange(4, dtype=torch.float32) + 10 * i} for i in range(2)],
            "step": torch.tensor(3, dtype=torch.int32)}


def _template():
    return {"w": torch.zeros(8, 6), "layers": [{"b": torch.zeros(4)} for _ in range(2)],
            "step": torch.zeros((), dtype=torch.int32)}


def _elastic_ranks(rank, nprocs, directory):
    from repro_torch.checkpoint import CheckpointManager, restore_elastic
    from repro_torch.distributed.sharding import gather_tensor
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh
    mgr = CheckpointManager(directory, async_save=False)
    out = {}
    two = make_mesh((2,), ("data",), device="cpu")
    if two.get_coordinate() is not None:
        specs = {"w": ("data", None)}
        step, state, _ = restore_elastic(mgr, _template(), two,
                                         lambda path, leaf: specs.get(path, ()))
        out["two"] = (step, two.get_local_rank("data"), state["w"].numpy(),
                      [layer["b"].numpy() for layer in state["layers"]])
    grid = make_debug_mesh(2, 2, device="cpu")
    spec = (("data", "model"), None)
    _, state, _ = restore_elastic(mgr, _template(), grid,
                                  lambda path, leaf: spec if path == "w" else ())
    out["grid"] = (grid.get_local_rank("data"), grid.get_local_rank("model"),
                   state["w"].numpy(), gather_tensor(state["w"], spec, grid).numpy())
    _, state, _ = restore_elastic(mgr, _template(), grid)
    out["replicated"] = {k: v.numpy() for k, v in
                         (("w", state["w"]), ("b1", state["layers"][1]["b"]),
                          ("step", state["step"]))}
    return out


@pytest.fixture(scope="module")
def elastic():
    from repro_torch.checkpoint import CheckpointManager
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d, async_save=False).save(3, _tree())
        yield run_world(_elastic_ranks, WORLD, args=(d,), device="cpu", timeout=TIMEOUT)


def test_restore_onto_two_ranks_cuts_each_shard(elastic):
    full = _tree()
    got = [r["two"] for r in elastic[:2]]
    assert [g[1] for g in got] == [0, 1]
    for step, coord, w, bs in got:
        assert step == 3
        np.testing.assert_array_equal(w, full["w"][coord * 4:(coord + 1) * 4].numpy())
        for b, layer in zip(bs, full["layers"]):
            np.testing.assert_array_equal(b, layer["b"].numpy())      # replicated
    assert all("two" not in r for r in elastic[2:])


def test_restore_onto_a_grid_and_gather_back(elastic):
    full = _tree()["w"].numpy()
    seen = set()
    for data, model, shard, whole in (r["grid"] for r in elastic):
        i = data * 2 + model                       # ("data", "model"): model fastest
        seen.add(i)
        np.testing.assert_array_equal(shard, full[i * 2:(i + 1) * 2])
        np.testing.assert_array_equal(whole, full)
    assert seen == {0, 1, 2, 3}


def test_restore_replicated(elastic):
    full = _tree()
    for r in elastic:
        rep = r["replicated"]
        np.testing.assert_array_equal(rep["w"], full["w"].numpy())
        np.testing.assert_array_equal(rep["b1"], full["layers"][1]["b"].numpy())
        assert int(rep["step"]) == 3


def test_restore_without_a_mesh_or_checkpoint(tmp_path):
    from repro_torch.checkpoint import CheckpointManager, reshard_tree, restore_elastic
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert restore_elastic(mgr, _template(), None) is None
    mgr.save(5, _tree())
    step, state, _ = restore_elastic(mgr, _template(), None)
    assert step == 5 and torch.equal(state["w"], _tree()["w"])
    leaf = reshard_tree({"a": np.ones(3, np.float32)}, None)["a"]
    assert isinstance(leaf, torch.Tensor)


# ---------------------------------------------------------------------------
# The world harness
# ---------------------------------------------------------------------------
def _one_raises(rank, nprocs):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank one gives up")
    dist.barrier()                                 # rank 0 would wait forever


def _sleeps(rank, nprocs):
    time.sleep(600)


def test_a_failing_rank_ends_the_world():
    start = time.monotonic()
    with pytest.raises(WorldError, match="rank 1 of 2 failed") as err:
        run_world(_one_raises, 2, device="cpu", timeout=60)
    assert "ValueError: rank one gives up" in str(err.value)
    assert time.monotonic() - start < 45


def test_a_world_past_its_timeout_is_killed():
    start = time.monotonic()
    with pytest.raises(WorldError, match="outlived its 5 s timeout"):
        run_world(_sleeps, 2, device="cpu", timeout=5)
    assert time.monotonic() - start < 30


def test_backend_choice():
    assert choose_backend("cpu", 4)[0] == "gloo"
    with pytest.raises(ValueError):
        choose_backend("mps", 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            choose_backend("cuda", 2)
