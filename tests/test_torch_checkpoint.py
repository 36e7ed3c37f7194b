"""The port's checkpoints: the reference's format, async save, retention,
crash-safe commit and a bitwise resume.

* mirrors of the reference's ``tests/test_checkpoint.py`` (all but its
  elastic test, which belongs to the distributed slice): round trip with
  dtypes kept, bf16 kept, a shape mismatch refused, retention and latest,
  an uncommitted directory skipped, the async save's snapshot immune to a
  later change of the live tree;
* the format across packages: a tree the reference's ``save_tree`` wrote
  loads with the port's ``load_tree``, and the other way round, every leaf
  bit for bit (bf16 through its uint16 tag);
* restoring fills a template's tensors in place (device and
  ``requires_grad`` kept);
* the reference's ``tests/test_fault_tolerance.py`` crash / resume on the
  port: 6 straight steps of reduced ``xlstm-350m`` equal 3 steps, a save,
  a restore into a fresh state and 3 more, bit for bit; and on reduced
  ``qwen36-35b-a3b`` at capacity factor 1.25 (sorted dispatch with drops).
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_tree as jload_tree
from repro.checkpoint import save_tree as jsave_tree
from repro_torch.checkpoint import CheckpointManager, load_tree, save_tree
from repro_torch.checkpoint.serializer import tree_to_arrays
from repro_torch.config import RunConfig
from repro_torch.config import get_config as tget
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.data import SyntheticSpec, batch_at_step
from repro_torch.models import transformer as ttfm
from repro_torch.training import init_train_state, make_train_step
from repro_torch.tree import leaves


def _tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones((4,), dtype=torch.bfloat16),
                   "c": torch.tensor(7, dtype=torch.int32)},
        "list": [torch.zeros((2, 2)), torch.full((3,), 2.5)],
    }


def _zeros_like(tree):
    return {"a": torch.zeros(2, 3), "nested": {"b": torch.zeros(4, dtype=torch.bfloat16),
                                               "c": torch.tensor(0, dtype=torch.int32)},
            "list": [torch.ones(2, 2), torch.zeros(3)]}


def test_serializer_roundtrip(tmp_path):
    t = _tree()
    save_tree(str(tmp_path / "ck"), t, {"step": 3})
    t2, meta = load_tree(str(tmp_path / "ck"), _zeros_like(t))
    assert meta["step"] == 3
    for a, b in zip(leaves(t), leaves(t2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_preserved(tmp_path):
    t = {"w": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    save_tree(str(tmp_path / "ck"), t, {})
    t2, _ = load_tree(str(tmp_path / "ck"), {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert t2["w"].dtype == torch.bfloat16 and torch.equal(t2["w"], t["w"])
    with np.load(str(tmp_path / "ck" / "arrays.npz")) as z:
        assert z.files == ["w__bf16__"] and z["w__bf16__"].dtype == np.uint16


def test_shape_mismatch_rejected(tmp_path):
    t = _tree()
    save_tree(str(tmp_path / "ck"), t, {})
    bad = _zeros_like(t)
    bad["a"] = torch.zeros((3, 3))
    with pytest.raises(ValueError):
        load_tree(str(tmp_path / "ck"), bad)


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    t = _tree()
    for step in (10, 20, 30):
        t["a"] = t["a"] + 1.0
        mgr.save(step, t)
    assert mgr.existing_steps() == [20, 30]
    step, t2, meta = mgr.restore_latest(_zeros_like(t))
    assert step == 30 and meta["step"] == 30 and torch.equal(t2["a"], t["a"])


def test_uncommitted_checkpoint_skipped(tmp_path):
    """A crash mid-save leaves no COMMIT marker; restore must skip it."""
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    t = _tree()
    mgr.save(10, t)
    torn = tmp_path / "step_00000020"
    os.makedirs(torn)
    np.savez(str(torn / "arrays.npz"), **tree_to_arrays(t))
    with open(torn / "meta.json", "w") as f:
        json.dump({"step": 20}, f)
    assert mgr.existing_steps() == [10]
    step, _, _ = mgr.restore_latest(_zeros_like(t))
    assert step == 10


def test_async_save_consistent_snapshot(tmp_path):
    """Changing the live tree after save() must not change the checkpoint
    (a numpy tree and a torch one)."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = {"w": np.zeros((1000,), np.float32), "x": torch.zeros(1000)}
    mgr.save(1, t)
    t["w"][:] = 999.0
    t["x"].fill_(999.0)
    mgr.wait()
    _, t2, _ = mgr.restore_latest({"w": np.ones((1000,), np.float32), "x": torch.ones(1000)})
    assert float(t2["w"].max()) == 0.0 and float(t2["x"].max()) == 0.0


def test_restore_fills_the_template_in_place(tmp_path):
    save_tree(str(tmp_path / "ck"), {"p": torch.full((3,), 2.0)}, {})
    template = {"p": torch.zeros(3, requires_grad=True)}
    before = template["p"]
    got, _ = load_tree(str(tmp_path / "ck"), template)
    assert got["p"] is before and before.requires_grad and torch.equal(before.detach(),
                                                                       torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="dtype"):
        load_tree(str(tmp_path / "ck"), {"p": torch.zeros(3, dtype=torch.bfloat16)})


def test_reference_files_load_in_the_port_and_back(tmp_path):
    """The on-disk format is the reference's, both ways, bit for bit."""
    jtree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
             "nested": {"b": jnp.asarray([1.5, -2.25, 3.0, 0.1], jnp.bfloat16),
                        "c": jnp.int32(7)},
             "list": [jnp.zeros((2, 2)), jnp.full((3,), 2.5)]}
    jsave_tree(str(tmp_path / "ref"), jtree, {"step": 4})
    got, meta = load_tree(str(tmp_path / "ref"), _zeros_like(None))
    assert meta == {"step": 4}
    want = [np.asarray(jtree["a"]), np.asarray(jtree["list"][0]), np.asarray(jtree["list"][1])]
    for g, w in zip([got["a"], got["list"][0], got["list"][1]], want):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(got["nested"]["b"].view(torch.int16).numpy().view(np.uint16),
                          np.asarray(jtree["nested"]["b"]).view(np.uint16))
    assert int(got["nested"]["c"]) == 7

    t = _tree()
    t["nested"]["b"] = torch.tensor([0.3, -1.0, 7.5, 2.0], dtype=torch.bfloat16)
    save_tree(str(tmp_path / "port"), t, {"step": 5})
    back, jmeta = jload_tree(str(tmp_path / "port"), jtree)
    assert jmeta == {"step": 5}
    assert np.asarray(back["nested"]["b"]).dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["nested"]["b"]).view(np.uint16),
                          t["nested"]["b"].view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(np.asarray(back["a"]), t["a"].numpy())
    assert int(back["nested"]["c"]) == 7


@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen36-35b-a3b"])
def test_crash_resume_bitwise(tmp_path, arch):
    """6 straight steps vs 3, a save, a "crash", a restore into a fresh
    state and 3 more: identical parameters and moments."""
    cfg = treduce(tget(arch))
    if cfg.moe is not None:           # the published capacity: assignments drop
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    rt = ttfm.Runtime()
    run = RunConfig(learning_rate=1e-3, warmup_steps=0)
    spec = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    step_fn = make_train_step(cfg, rt, run)

    def fresh():
        return init_train_state(cfg, ttfm.init_params(cfg, 0, "cpu"))

    def run_steps(state, a, b):
        for i in range(a, b):
            t, l = batch_at_step(spec, i)
            state, _ = step_fn(state, torch.from_numpy(t), torch.from_numpy(l))
        return state

    straight = run_steps(fresh(), 0, 6)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    s = run_steps(fresh(), 0, 3)
    mgr.save(3, s)
    del s                                   # "crash"
    mgr.wait()
    step, s2, _ = mgr.restore_latest(fresh())
    assert step == 3 and int(s2["opt"]["step"]) == 3
    s2 = run_steps(s2, 3, 6)
    for a, b in zip(leaves(straight), leaves(s2)):
        assert torch.equal(a.detach(), b.detach())
