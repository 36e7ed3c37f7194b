"""The port's data-parallel training with ZeRO-1 against the JAX package.

One world of two ``gloo`` ranks (``distributed/world.py``) on a (data 2,
model 1) mesh, and one JAX subprocess with two host devices
(``--xla_force_host_platform_device_count=2``) running the reference's
``make_train_step`` jitted over a (data 2, model 1) mesh of ``Auto`` axes,
the reference's semantics of global arrays. Both start from the same
weights: the port's ``init_params`` (seed 0), stacked into the reference's
layout for JAX. Configs are reduced and f32; a global batch of 8 x 16 with
labels that hold -1 (a run of -1 inside a row, a row's head, every last
position), two steps at learning rate 1e-3:

* starcoder2-3b (dense), ``num_micro`` 1;
* qwen36 (MoE) at capacity factor 1.25 (assignments drop), ``num_micro`` 2:
  each data rank's sorted dispatch keeps the capacity of its own rows of
  each microbatch, so a wrong choice of rows moves the drops.

Held (tolerances for f32 over two AdamW steps): the cross-entropy part of
the loss within 2e-6 relative of the reference's (its loss taken with the
router coefficients 0; 1.7e-7 measured); the loss within 2e-3 nats
(6.5e-4 measured at step 1; the reference's MoE
terms leave its ``shard_map`` through ``out_specs`` ``P()`` unchecked, so
their value is data shard 0's, the port's the shards' mean; their gradient
is the mean in both), exact within 2e-6 for the dense model; ``grad_norm``
within 1e-5 relative (7e-8 measured); the parameters within 5e-5 and the
moments within 1e-7 (m) and 5e-9 (v) absolute (1.0e-5, 1.3e-8 and 5.5e-10
measured). The moments' shard shapes are those of
``opt_spec`` under ZeRO-1; ZeRO-1 on and off give the same parameters and
metrics bit for bit; a checkpoint written under the mesh by ``train_loop``
(the moments gathered whole) restores in this process onto one rank
(``restore_elastic`` without a mesh) to the gathered state.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.world import run_world

ROOT = Path(__file__).resolve().parents[1]
CASES = (("starcoder2-3b", 1, None), ("qwen36-35b-a3b", 2, 1.25))
B, S, STEPS, LR = 8, 16, 2, 1e-3
XENT_RTOL, AUX_ATOL, NORM_RTOL = 2e-6, 2e-3, 1e-5
PARAM_ATOL, M_ATOL, V_ATOL = 5e-5, 1e-7, 5e-9
WORLD, TIMEOUT = 2, 120


def _cfg(get_config, reduce, arch, cf):
    cfg = dataclasses.replace(reduce(get_config(arch)), dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _torch_cfg(arch):
    from repro_torch.config import get_config
    from repro_torch.configs import reduce_for_smoke
    return _cfg(get_config, reduce_for_smoke, arch, next(c[2] for c in CASES if c[0] == arch))


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, 3:9] = -1
    labels[6, :5] = -1
    return tokens, labels


def _reference_layout(cfg, params):
    """The port's tree (parameters or moments) as the reference's flat
    {path: array}: each segment's layers stacked on a leading axis."""
    from repro_torch.tree import items
    out = {f"{n}/{k}" if k else n: v.detach().numpy() for n in params if n != "layers"
           for k, v in (items(params[n]) if isinstance(params[n], dict) else [("", params[n])])}
    base = 0
    for si, (unit, reps) in enumerate(cfg.segments):
        for pi in range(len(unit)):
            layers = [params["layers"][base + r * len(unit) + pi] for r in range(reps)]
            for path, _ in items(layers[0]):
                out[f"segments/{si}/{pi}/{path}"] = np.stack(
                    [dict(items(layer))[path].detach().numpy() for layer in layers])
        base += len(unit) * reps
    return out


# ---------------------------------------------------------------------------
# The reference's side (a subprocess with two host devices)
# ---------------------------------------------------------------------------
def _nest(flat):
    """{"a/0/b": x} -> {"a": ({"b": x},)}: digit keys become tuple indices."""
    tree = {}
    for path, v in flat.items():
        node, keys = tree, path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def fix(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return tuple(fix(t[str(i)]) for i in range(len(t)))
        return {k: fix(v) for k, v in t.items()}

    return fix(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, t in enumerate(tree) for k2, v2 in _flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _jax_side(in_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.config import RunConfig, ShardingConfig, get_config
    from repro.configs import reduce_for_smoke
    from repro.models import transformer as jtfm
    from repro.training.trainer import init_train_state, make_train_step

    data = dict(np.load(in_path))
    tokens, labels = jnp.asarray(data["tokens"]), jnp.asarray(data["labels"])
    mesh = jax.make_mesh((2, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rt = jtfm.Runtime(sharding=ShardingConfig(), mesh=mesh)
    out = {}
    for arch, micro, cf in CASES:
        cfg = _cfg(get_config, reduce_for_smoke, arch, cf)
        params = _nest({k[len(arch) + 1:]: jnp.asarray(v) for k, v in data.items()
                        if k.startswith(arch + "/")})
        xcfg = cfg if cfg.moe is None else dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_aux_coef=0.0, router_z_coef=0.0))
        xent = jax.jit(lambda p, t, lb: jtfm.lm_loss(xcfg, p, t, lb, rt)[0])
        step = jax.jit(make_train_step(cfg, rt, RunConfig(learning_rate=LR, warmup_steps=0),
                                       num_micro=micro))
        state = init_train_state(cfg, params)
        mb = B // micro
        for i in range(STEPS):
            out[f"{arch}/xent/{i}"] = np.mean([np.asarray(xent(
                state["params"], tokens[j * mb:(j + 1) * mb], labels[j * mb:(j + 1) * mb]))
                for j in range(micro)])
            state, m = step(state, tokens, labels)
            out[f"{arch}/loss/{i}"] = np.asarray(m["loss"])
            out[f"{arch}/grad_norm/{i}"] = np.asarray(m["grad_norm"])
        for key in ("params",):
            out.update({f"{arch}/{key}/{k}": v for k, v in _flat(state[key]).items()})
        for key in ("m", "v"):
            out.update({f"{arch}/{key}/{k}": v for k, v in _flat(state["opt"][key]).items()})
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# The port's side (every rank of the world)
# ---------------------------------------------------------------------------
def _train_case(rank, arch, micro, zero1, ckpt_dir):
    """STEPS steps through ``train_loop`` on this data rank's rows; with a
    checkpoint directory, a save after the last step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step, train_loop
    from repro_torch.training.trainer import data_rows
    from repro_torch.tree import leaves
    mesh = make_debug_mesh(2, 1, device="cpu")
    cfg = _torch_cfg(arch)
    sh = ShardingConfig(zero1=zero1)
    run = RunConfig(learning_rate=LR, warmup_steps=0, log_every=1, checkpoint_every=STEPS)
    state = init_train_state(cfg, tfm.init_params(cfg, 0, "cpu"), sh, mesh=mesh)
    step_fn = make_train_step(cfg, tfm.Runtime(sharding=sh, mesh=mesh), run, num_micro=micro)
    tokens, labels = (torch.from_numpy(a).long() for a in _batch())
    r = mesh.get_local_rank("data")
    loader = iter([(i, data_rows(tokens, micro, r, 2), data_rows(labels, micro, r, 2))
                   for i in range(STEPS)])
    metrics = []
    manager = CheckpointManager(ckpt_dir, async_save=False) if ckpt_dir else None
    state, _ = train_loop(cfg, state, step_fn, loader, run, num_steps=STEPS, ckpt_manager=manager,
                          log=lambda i, m: metrics.append(m))
    full = step_fn.full_state(state)
    return {"metrics": metrics, "shapes": [tuple(m.shape) for m in leaves(state["opt"]["m"])],
            "params": {k: v for k, v in _reference_layout(cfg, state["params"]).items()},
            "m": _reference_layout(cfg, full["opt"]["m"]),
            "v": _reference_layout(cfg, full["opt"]["v"]),
            "port_full": {"params": [p.detach().clone() for p in leaves(full["params"])],
                          "m": [t.clone() for t in leaves(full["opt"]["m"])],
                          "v": [t.clone() for t in leaves(full["opt"]["v"])]}}


def _rank_cases(rank, nprocs, ckpt_root):
    out = {}
    for arch, micro, _ in CASES:
        for zero1 in (True, False):
            name = f"{arch}/{'zero1' if zero1 else 'whole'}"
            ckpt = os.path.join(ckpt_root, arch) if zero1 else None
            try:
                out[name] = ("ok", _train_case(rank, arch, micro, zero1, ckpt))
            except Exception:                     # recorded for this case alone
                out[name] = ("error", traceback.format_exc())
    return out


# ---------------------------------------------------------------------------
# The world and the reference, side by side, once
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs():
    from repro_torch.models import transformer as tfm
    with tempfile.TemporaryDirectory() as d:
        in_path, ref_path = os.path.join(d, "in.npz"), os.path.join(d, "ref.npz")
        tokens, labels = _batch()
        arrays = {"tokens": tokens, "labels": labels}
        for arch, _, _ in CASES:
            cfg = _torch_cfg(arch)
            flat = _reference_layout(cfg, tfm.init_params(cfg, 0, "cpu"))
            arrays.update({f"{arch}/{k}": v for k, v in flat.items()})
        np.savez(in_path, **arrays)
        code = ("import sys; sys.path[:0] = sys.argv[3:]; import test_torch_data_parallel as m; "
                "m._jax_side(sys.argv[1], sys.argv[2])")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
        start = time.monotonic()
        jax_side = subprocess.Popen([sys.executable, "-c", code, in_path, ref_path,
                                     str(ROOT / "tests"), str(ROOT / "src")], env=env)
        try:
            results = run_world(_rank_cases, WORLD, args=(d,), device="cpu", timeout=TIMEOUT)
            left = max(0.1, TIMEOUT - (time.monotonic() - start))
            assert jax_side.wait(timeout=left) == 0, "the JAX side failed"
        finally:
            if jax_side.poll() is None:
                jax_side.kill()
                jax_side.wait()
        yield results, dict(np.load(ref_path)), d


def _got(runs, name):
    out = []
    for rank, res in enumerate(runs[0]):
        status, value = res[name]
        if status == "error":
            pytest.fail(f"rank {rank}, case {name}:\n{value}")
        out.append(value)
    return out


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_dp_zero1_step_matches_the_reference(runs, arch):
    ref = runs[1]
    got = _got(runs, f"{arch}/zero1")
    for res in got:
        for i, m in enumerate(res["metrics"]):
            np.testing.assert_allclose(m["lm_xent"], ref[f"{arch}/xent/{i}"], rtol=XENT_RTOL)
            tol = dict(atol=AUX_ATOL) if _torch_cfg(arch).has_moe else dict(rtol=XENT_RTOL)
            np.testing.assert_allclose(m["loss"], ref[f"{arch}/loss/{i}"], **tol)
            np.testing.assert_allclose(m["grad_norm"], ref[f"{arch}/grad_norm/{i}"],
                                       rtol=NORM_RTOL)
        for k, v in res["params"].items():
            np.testing.assert_allclose(v, ref[f"{arch}/params/{k}"], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
    for a, b in zip(got[0]["port_full"]["params"], got[1]["port_full"]["params"]):
        assert torch.equal(a, b)                       # the data ranks hold the same bits


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_zero1_moments_are_opt_spec_shards_and_gather_to_the_reference(runs, arch):
    from repro_torch.config import ShardingConfig
    from repro_torch.distributed.sharding import make_train_state_shardings
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import items
    ref = runs[1]
    cfg = _torch_cfg(arch)
    params = tfm.init_params(cfg, 0, "cpu")
    specs = make_train_state_shardings(cfg, {"data": 2, "model": 1}, ShardingConfig(),
                                       {"opt": {"m": params}})
    want = []
    for path, leaf in items(params):
        spec = specs[f"opt/m/{path}"]
        want.append(tuple(n // 2 if e == "data" else n for n, e in zip(leaf.shape, spec)))
    assert any(w != tuple(p.shape) for w, (_, p) in zip(want, items(params)))
    for res in _got(runs, f"{arch}/zero1"):
        assert res["shapes"] == want
        for key, atol in (("m", M_ATOL), ("v", V_ATOL)):
            for k, v in res[key].items():
                np.testing.assert_allclose(v, ref[f"{arch}/{key}/{k}"], atol=atol, rtol=0,
                                           err_msg=f"{key}/{k}")


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_zero1_on_and_off_are_bitwise_equal(runs, arch):
    on, off = _got(runs, f"{arch}/zero1"), _got(runs, f"{arch}/whole")
    for a, b in zip(on, off):
        assert a["metrics"] == b["metrics"]
        for key in ("params", "m", "v"):
            for x, y in zip(a["port_full"][key], b["port_full"][key]):
                assert torch.equal(x, y), key
        assert b["shapes"] != a["shapes"]              # off: every moment whole


def test_a_checkpoint_saved_under_the_mesh_restores_onto_one_rank(runs):
    from repro_torch.checkpoint import CheckpointManager, restore_elastic
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state
    from repro_torch.tree import leaves
    arch = CASES[1][0]
    cfg = _torch_cfg(arch)
    template = init_train_state(cfg, tfm.init_params(cfg, 0, "cpu"))
    got = restore_elastic(CheckpointManager(os.path.join(runs[2], arch)), template, None)
    assert got is not None and got[0] == STEPS
    state = got[1]
    full = _got(runs, f"{arch}/zero1")[0]["port_full"]
    for key, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                      ("v", state["opt"]["v"])):
        for x, y in zip(leaves(tree), full[key]):
            assert torch.equal(torch.as_tensor(x), y), key
    assert int(state["opt"]["step"]) == STEPS
