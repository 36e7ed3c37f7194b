"""The port's training over the model axis and FSDP storage against the JAX package.

One world of four ``gloo`` ranks (``distributed/world.py``, pinned to the
CPU) runs every case of this module, each case's result or traceback
recorded apart, and two JAX subprocesses with four host devices each
(``--xla_force_host_platform_device_count=4``) runs the reference's
``make_train_step`` jitted with ``in_shardings`` from
``make_train_state_shardings(fsdp=False)`` and ``(fsdp=True)`` over meshes of
``Auto`` axes (the semantics of global arrays). Both start from the port's
``init_params`` (seed 0), stacked into the reference's layout for JAX.
Configs are reduced and f32; two AdamW steps at learning rate 1e-3:

* (data 2, model 2), a global batch of 8 x 16 with -1 labels: starcoder2-3b
  (dense: heads, MLP and vocabulary split, ``num_micro`` 1) and qwen36 at
  capacity factor 1.25 (experts split, ``moe_epsum_train``: assignments
  drop; ``num_micro`` 2), each with FSDP off and on;
* (data 1, model 3) on the first three ranks, one row of 3,072 tokens in
  chunks of 1,024 (attention and loss, both sides): qwen36 with sorted
  dispatch at capacity factor 1.25 and the router coefficients 0 (its 4
  heads and 8 experts do not
  divide 3: sequence-parallel attention, everything else whole). S = 2,048
  would not split over 3 ranks, so the reference would not take its SP
  form there.

The reference's FSDP run gives its own losses, norms, parameters and
moments; its cross-entropy is the run's without FSDP (FSDP storage moves
GSPMD's parameters by under 1e-6, the cross-entropy tolerance is 2e-6).

Held (tolerances for f32 over two steps; measured worst in brackets):
the cross-entropy within 2e-6 relative of the reference's [1.8e-7]; the
loss within 2e-3 nats for qwen36 at (2, 2) [6.5e-4: the reference reports
data shard 0's aux losses, the port the shards' mean, as on the data axis
alone] and 2e-6 relative for the dense model and the SP case [1.2e-7];
``grad_norm`` within 1e-5 relative [1.8e-6, SP]; the parameters within
5e-5 [2.1e-5, SP; 8.6e-6 at (2, 2)] and the moments within 1e-7 (m)
[2.2e-8] and 5e-9 (v) [5.5e-10] absolute. Every stored shard has the shape
of its ``param_spec`` (FSDP's data axis included) and every moment that of
its ``opt_spec`` (ZeRO-1), except that an FSDP-split leaf's moments lie
beside its shard; FSDP on and off within 1e-6 in every parameter and moment
[1.5e-7; starcoder2 bitwise] and 2e-7 relative in the metrics [7.4e-8];
the model ranks' parameters bitwise equal; a checkpoint written by
``train_loop`` under the mesh (FSDP off and on) restores onto one rank
bitwise to the gathered state.

The JAX side also measures the reference over the model axis against its
own unsharded gradient (reduced qwen36 at capacity factor 8, so nothing
drops): at (data 1, model 2) every gradient leaf within 1e-5 of the
largest entry of its unsharded leaf [6.2e-7] and the loss within 1e-6
[0]: the model axis adds no departure, so the port is held to that
gradient. The backward rules of the collectives (``distributed/parallel.py``)
each get a case at the gradient level, against the unsharded port on the
same weights (within 1e-5 of each leaf's largest entry [1.6e-6]): a sum
over the axis that is missing or repeated is off by a factor of tp.

Measured time of this file alone on an 8-core CPU host: 38 s.
"""
import dataclasses
import functools
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
from test_torch_data_parallel import _batch, _cfg, _flat, _nest, _reference_layout

ROOT = Path(__file__).resolve().parents[1]
CASES = (("starcoder2-3b", 1, None), ("qwen36-35b-a3b", 2, 1.25))
SP_ARCH, SP_S, SP_CF = "qwen36-35b-a3b", 3072, 1.25
SP_CHUNKS = dict(q_chunk=1024, kv_chunk=1024, loss_chunk=1024)   # both sides, the SP row
B, STEPS, LR = 8, 2, 1e-3
XENT_RTOL, AUX_ATOL, NORM_RTOL = 2e-6, 2e-3, 1e-5
PARAM_ATOL, M_ATOL, V_ATOL = 5e-5, 1e-7, 5e-9
FSDP_ATOL, FSDP_RTOL = 1e-6, 2e-7
GRAD_RTOL, REF_GRAD_RTOL, REF_LOSS_ATOL = 1e-5, 1e-5, 1e-6
WORLD, TIMEOUT = 4, 400         # a hang's limit: the file takes ~40 s alone


def _torch_cfg(arch, cf=None):
    from repro_torch.config import get_config
    from repro_torch.configs import reduce_for_smoke
    return _cfg(get_config, reduce_for_smoke, arch, cf)


def _sp_batch():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (1, SP_S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 100:300] = -1
    return tokens, labels


# ---------------------------------------------------------------------------
# The reference's side (a subprocess with four host devices)
# ---------------------------------------------------------------------------
def _jax_train(cfg, params, tokens, labels, mesh, sh, micro, fsdp, xent_cfg=None, chunks=None):
    """STEPS steps of the reference's jitted ``make_train_step`` on ``mesh``;
    with ``xent_cfg`` (an MoE config with the router coefficients 0) also
    each step's cross-entropy before the step (a dense model's loss is its
    cross-entropy)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.config import RunConfig
    from repro.distributed import sharding as jsh
    from repro.models import transformer as jtfm
    from repro.training.trainer import init_train_state, make_train_step

    rt = jtfm.Runtime(sharding=sh, mesh=mesh, **(chunks or {}))
    state = init_train_state(cfg, params)
    shard = jsh.make_train_state_shardings(cfg, mesh, sh, state, fsdp=fsdp)
    rows = NamedSharding(mesh, jsh.batch_spec(sh, mesh, tokens.shape[0]))
    step = jax.jit(make_train_step(cfg, rt, RunConfig(learning_rate=LR, warmup_steps=0),
                                   num_micro=micro), in_shardings=(shard, rows, rows))
    xent = None if xent_cfg is None else jax.jit(
        lambda p, t, lb: jtfm.lm_loss(xent_cfg, p, t, lb, rt)[0])
    mb = tokens.shape[0] // micro
    out = {}
    for i in range(STEPS):
        if xent is not None:
            out[f"xent/{i}"] = np.mean([np.asarray(xent(
                state["params"], tokens[j * mb:(j + 1) * mb], labels[j * mb:(j + 1) * mb]))
                for j in range(micro)])
        state, m = step(jax.device_put(state, shard), jnp.asarray(tokens), jnp.asarray(labels))
        out[f"loss/{i}"] = np.asarray(m["loss"])
        out.setdefault(f"xent/{i}", out[f"loss/{i}"])
        out[f"grad_norm/{i}"] = np.asarray(m["grad_norm"])
    out.update({f"params/{k}": v for k, v in _flat(state["params"]).items()})
    for key in ("m", "v"):
        out.update({f"{key}/{k}": v for k, v in _flat(state["opt"][key]).items()})
    return out


def _no_aux(cfg):
    return None if cfg.moe is None else dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_coef=0.0, router_z_coef=0.0))


def _jax_side(in_path, out_path, part):
    """The reference's runs: ``part`` "mesh22" the (data 2, model 2) cases,
    "sp" the SP case and the model-axis gradient measurement (two
    subprocesses side by side)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.config import ShardingConfig, get_config
    from repro.configs import reduce_for_smoke
    from repro.models import transformer as jtfm

    data = dict(np.load(in_path))
    auto = dict(axis_types=(AxisType.Auto,) * 2)
    mesh = jax.make_mesh((2, 2), ("data", "model"), **auto)
    sh = ShardingConfig(moe_impl="epsum")
    out = {}
    for arch, micro, cf in (CASES if part == "mesh22" else ()):
        cfg = _cfg(get_config, reduce_for_smoke, arch, cf)
        params = _nest({k[len(arch) + 1:]: jnp.asarray(v) for k, v in data.items()
                        if k.startswith(arch + "/")})
        whole = _jax_train(cfg, params, data["tokens"], data["labels"], mesh, sh, micro, False,
                           _no_aux(cfg))
        fsdp = _jax_train(cfg, params, data["tokens"], data["labels"], mesh, sh, micro, True)
        fsdp.update({k: v for k, v in whole.items() if k.startswith("xent/")})
        for name, got in (("0", whole), ("1", fsdp)):
            out.update({f"{arch}/{name}/{k}": v for k, v in got.items()})
    if part == "mesh22":
        np.savez(out_path, **out)
        return
    sp_mesh = jax.make_mesh((1, 3), ("data", "model"), devices=jax.devices()[:3], **auto)
    cfg = _cfg(get_config, reduce_for_smoke, SP_ARCH, SP_CF)
    params = _nest({k[3:]: jnp.asarray(v) for k, v in data.items() if k.startswith("sp/")})
    got = _jax_train(_no_aux(cfg), params, data["sp_tokens"], data["sp_labels"], sp_mesh,
                     ShardingConfig(moe_impl="sorted"), 1, False, chunks=SP_CHUNKS)
    out.update({f"sp/{k}": v for k, v in got.items()})
    # the reference over the model axis against its own unsharded gradient
    cfg = _cfg(get_config, reduce_for_smoke, SP_ARCH, None)
    tokens, labels = jnp.asarray(data["tokens"]), jnp.asarray(data["labels"])
    tp_mesh = jax.make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2], **auto)
    for name, m in (("unsharded", None), ("model2", tp_mesh)):
        rt = jtfm.Runtime(sharding=sh, mesh=m)
        fn = jax.jit(jax.value_and_grad(lambda p, t, lb: jtfm.lm_loss(cfg, p, t, lb, rt)[0]))
        loss, grads = fn(params, tokens, labels)
        out[f"refgrad/{name}/loss"] = np.asarray(loss)
        out.update({f"refgrad/{name}/{k}": v for k, v in _flat(grads).items()})
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# The port's side (every rank of the world)
# ---------------------------------------------------------------------------
def _train_case(arch, micro, cf, fsdp, ckpt_dir):
    """STEPS steps through ``train_loop`` on (data 2, model 2), this data
    rank's rows; a checkpoint after the last step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step, train_loop
    from repro_torch.training.trainer import data_rows
    from repro_torch.tree import leaves
    mesh = make_debug_mesh(2, 2, device="cpu")
    cfg = _torch_cfg(arch, cf)
    sh = ShardingConfig(moe_impl="epsum")
    run = RunConfig(learning_rate=LR, warmup_steps=0, log_every=1, checkpoint_every=STEPS)
    state = init_train_state(cfg, tfm.init_params(cfg, 0, "cpu"), sh, mesh=mesh, fsdp=fsdp)
    step_fn = make_train_step(cfg, tfm.Runtime(sharding=sh, mesh=mesh), run, num_micro=micro,
                              fsdp=fsdp)
    tokens, labels = (torch.from_numpy(a).long() for a in _batch())
    r = mesh.get_local_rank("data")
    loader = iter([(i, data_rows(tokens, micro, r, 2), data_rows(labels, micro, r, 2))
                   for i in range(STEPS)])
    metrics = []
    state, _ = train_loop(cfg, state, step_fn, loader, run, num_steps=STEPS,
                          ckpt_manager=CheckpointManager(ckpt_dir, async_save=False),
                          log=lambda i, m: metrics.append(m))
    full = step_fn.full_state(state)
    return {"metrics": metrics, "coord": tuple(mesh.get_coordinate()),
            "shapes": [tuple(p.shape) for p in leaves(state["params"])],
            "moment_shapes": [tuple(m.shape) for m in leaves(state["opt"]["m"])],
            "local": [p.detach().clone() for p in leaves(state["params"])],
            "params": _reference_layout(cfg, full["params"]),
            "m": _reference_layout(cfg, full["opt"]["m"]),
            "v": _reference_layout(cfg, full["opt"]["v"]),
            "port_full": {"params": [p.detach().clone() for p in leaves(full["params"])],
                          "m": [t.clone() for t in leaves(full["opt"]["m"])],
                          "v": [t.clone() for t in leaves(full["opt"]["v"])]}}


def _sp_case():
    """qwen36 at (data 1, model 3): STEPS steps of one 3,072-token row."""
    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step
    mesh = make_debug_mesh(1, 3, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    cfg = _no_aux(_torch_cfg(SP_ARCH, SP_CF))
    sh = ShardingConfig(moe_impl="sorted")
    rt = tfm.Runtime(sharding=sh, mesh=mesh, **SP_CHUNKS)
    assert tfm._use_sp(cfg, rt, SP_S)
    state = init_train_state(cfg, tfm.init_params(cfg, 0, "cpu"), sh, mesh=mesh)
    step_fn = make_train_step(cfg, rt, RunConfig(learning_rate=LR, warmup_steps=0))
    tokens, labels = (torch.from_numpy(a).long() for a in _sp_batch())
    metrics = []
    for _ in range(STEPS):
        state, m = step_fn(state, tokens, labels)
        metrics.append({k: float(v) for k, v in m.items()})
    full = step_fn.full_state(state)
    return {"metrics": metrics, "params": _reference_layout(cfg, full["params"]),
            "m": _reference_layout(cfg, full["opt"]["m"]),
            "v": _reference_layout(cfg, full["opt"]["v"])}


def _grads_case(shape, aux_only):
    """The gradients a step updates with (after the sums over the axes),
    gathered whole: reduced qwen36 (capacity factor 8, nothing drops) on
    the (data 1, model 2) mesh and 8 x 16 tokens, or at (data 1, model 3)
    on the SP row; ``aux_only`` differentiates the MoE aux losses alone."""
    from repro_torch.config import ShardingConfig
    from repro_torch.distributed.sharding import gather_tensor
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state
    from repro_torch.training.trainer import _MeshStep
    from repro_torch.tree import leaves
    mesh = make_debug_mesh(*shape, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    cfg = _torch_cfg(SP_ARCH)
    sh = ShardingConfig(moe_impl="epsum" if shape[1] == 2 else "sorted", zero1=False)
    state = init_train_state(cfg, tfm.init_params(cfg, 0, "cpu"), sh, mesh=mesh)
    ms = _MeshStep(cfg, tfm.Runtime(sharding=sh, mesh=mesh,
                                    **(SP_CHUNKS if shape[1] == 3 else {})), False)
    tokens, labels = (torch.from_numpy(a).long() for a in (_batch() if shape[1] == 2
                                                           else _sp_batch()))
    loss, aux = tfm.lm_loss(cfg, state["params"], tokens, labels, ms.rt)
    if aux_only:
        loss = aux["moe_load_balance"] + aux["moe_router_z"]
    ps = leaves(state["params"])
    g = [torch.zeros_like(p) if gi is None else gi
         for p, gi in zip(ps, torch.autograd.grad(loss, ps, allow_unused=True))]
    g = ms.reduce(state["params"], g, tokens.shape[1])
    partial = tfm.tp_partial_leaves(cfg, state["params"], ms.rt, tokens.shape[1])
    return {"partial": partial, "grads": {path: gather_tensor(gi, lay.pspec, mesh)
                                          for (path, lay), gi in zip(ms.layout.items(), g)}}


def _rank_cases(rank, nprocs, ckpt_root):
    cases = [(f"{arch}/{int(fsdp)}",
              lambda a=arch, mi=micro, c=cf, f=fsdp: _train_case(
                  a, mi, c, f, os.path.join(ckpt_root, f"{a}-{int(f)}")))
             for arch, micro, cf in CASES for fsdp in (False, True)]
    cases += [("sp", _sp_case), ("grads/tp", lambda: _grads_case((1, 2), False)),
              ("grads/aux", lambda: _grads_case((1, 2), True)),
              ("grads/sp", lambda: _grads_case((1, 3), False))]
    out = {}
    for name, fn in cases:
        try:
            out[name] = ("ok", fn())
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
        sp_tokens, sp_labels = _sp_batch()
        arrays = {"tokens": tokens, "labels": labels, "sp_tokens": sp_tokens,
                  "sp_labels": sp_labels}
        for arch, _, cf in CASES:
            cfg = _torch_cfg(arch, cf)
            flat = _reference_layout(cfg, tfm.init_params(cfg, 0, "cpu"))
            arrays.update({f"{arch}/{k}": v for k, v in flat.items()})
        cfg = _torch_cfg(SP_ARCH)
        arrays.update({f"sp/{k}": v for k, v in
                       _reference_layout(cfg, tfm.init_params(cfg, 0, "cpu")).items()})
        np.savez(in_path, **arrays)
        code = ("import sys; sys.path[:0] = sys.argv[4:]; import test_torch_model_parallel_train "
                "as m; m._jax_side(sys.argv[1], sys.argv[2], sys.argv[3])")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
        start = time.monotonic()
        parts = ("mesh22", "sp")
        jax_sides = [subprocess.Popen([sys.executable, "-c", code, in_path, f"{ref_path}.{part}.npz",
                                       part, str(ROOT / "tests"), str(ROOT / "src")], env=env)
                     for part in parts]
        try:
            results = run_world(_rank_cases, WORLD, args=(d,), device="cpu", timeout=TIMEOUT)
            for part, proc in zip(parts, jax_sides):
                left = max(0.1, TIMEOUT - (time.monotonic() - start))
                assert proc.wait(timeout=left) == 0, f"the JAX side ({part}) failed"
        finally:
            for proc in jax_sides:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        ref = {}
        for part in parts:
            ref.update(np.load(f"{ref_path}.{part}.npz"))
        yield results, ref, d


def _got(runs, name):
    out = []
    for rank, res in enumerate(runs[0]):
        status, value = res[name]
        if status == "error":
            pytest.fail(f"rank {rank}, case {name}:\n{value}")
        if value is not None:
            out.append(value)
    return out


def _hold(res, ref, prefix, moe):
    for i, m in enumerate(res["metrics"]):
        np.testing.assert_allclose(m["lm_xent"], ref[f"{prefix}/xent/{i}"], rtol=XENT_RTOL)
        tol = dict(atol=AUX_ATOL) if moe else dict(rtol=XENT_RTOL)
        np.testing.assert_allclose(m["loss"], ref[f"{prefix}/loss/{i}"], **tol)
        np.testing.assert_allclose(m["grad_norm"], ref[f"{prefix}/grad_norm/{i}"],
                                   rtol=NORM_RTOL)
    for key, atol in (("params", PARAM_ATOL), ("m", M_ATOL), ("v", V_ATOL)):
        for k, v in res[key].items():
            np.testing.assert_allclose(v, ref[f"{prefix}/{key}/{k}"], atol=atol, rtol=0,
                                       err_msg=f"{key}/{k}")


@pytest.mark.parametrize("fsdp", (False, True), ids=("whole", "fsdp"))
@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_model_axis_step_matches_the_reference(runs, arch, fsdp):
    got = _got(runs, f"{arch}/{int(fsdp)}")
    assert len(got) == WORLD
    for res in got:
        _hold(res, runs[1], f"{arch}/{int(fsdp)}", _torch_cfg(arch).has_moe)
    by_data = {}
    for res in got:                        # the model ranks of a data rank: the same bits
        by_data.setdefault(res["coord"][0], []).append(res)
    for rs in by_data.values():
        for a, b in zip(rs[0]["port_full"]["params"], rs[1]["port_full"]["params"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_shards_follow_param_spec_and_opt_spec(runs, arch):
    from repro_torch.config import ShardingConfig
    from repro_torch.distributed.sharding import make_param_shardings, make_train_state_shardings
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import items
    cfg = _torch_cfg(arch)
    params = tfm.init_params(cfg, 0, "meta")
    sizes = {"data": 2, "model": 2}
    opt = make_train_state_shardings(cfg, sizes, ShardingConfig(), {"opt": {"m": params}})

    def local(shape, spec):
        return tuple(n // (sizes[e] if e else 1) for n, e in zip(shape, spec))

    for fsdp in (False, True):
        pspec = make_param_shardings(cfg, sizes, ShardingConfig(), params, fsdp=fsdp)
        want_p = [local(p.shape, pspec[path]) for path, p in items(params)]
        want_m = [local(p.shape, pspec[path] if "data" in pspec[path] else opt[f"opt/m/{path}"])
                  for path, p in items(params)]
        assert any("model" in s for s in pspec.values())
        assert fsdp == any("data" in s for s in pspec.values())
        for res in _got(runs, f"{arch}/{int(fsdp)}"):
            assert res["shapes"] == want_p
            assert res["moment_shapes"] == want_m


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_fsdp_on_and_off_agree(runs, arch):
    on, off = _got(runs, f"{arch}/1"), _got(runs, f"{arch}/0")
    for a, b in zip(on, off):
        for ma, mb in zip(a["metrics"], b["metrics"]):
            for k in ("loss", "lm_xent", "grad_norm"):
                np.testing.assert_allclose(ma[k], mb[k], rtol=FSDP_RTOL)
        for key in ("params", "m", "v"):
            for x, y in zip(a["port_full"][key], b["port_full"][key]):
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=FSDP_ATOL, rtol=0)
        assert a["shapes"] != b["shapes"]                # on: stored over the data axis too


@pytest.mark.parametrize("fsdp", (False, True), ids=("whole", "fsdp"))
def test_a_checkpoint_saved_under_the_mesh_restores_onto_one_rank(runs, fsdp):
    from repro_torch.checkpoint import CheckpointManager, restore_elastic
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state
    from repro_torch.tree import leaves
    arch, _, cf = CASES[1]
    cfg = _torch_cfg(arch, cf)
    template = init_train_state(cfg, tfm.init_params(cfg, 0, "cpu"))
    got = restore_elastic(CheckpointManager(os.path.join(runs[2], f"{arch}-{int(fsdp)}")),
                          template, None)
    assert got is not None and got[0] == STEPS
    state = got[1]
    full = _got(runs, f"{arch}/{int(fsdp)}")[0]["port_full"]
    for key, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                      ("v", state["opt"]["v"])):
        for x, y in zip(leaves(tree), full[key]):
            assert torch.equal(torch.as_tensor(x), y), key
    assert int(state["opt"]["step"]) == STEPS


def test_sequence_parallel_step_matches_the_reference(runs):
    got = _got(runs, "sp")
    assert len(got) == 3
    for res in got:
        _hold(res, runs[1], "sp", False)


def test_the_reference_adds_no_departure_over_the_model_axis(runs):
    ref = runs[1]
    np.testing.assert_allclose(ref["refgrad/model2/loss"], ref["refgrad/unsharded/loss"],
                               atol=REF_LOSS_ATOL, rtol=0)
    keys = [k[len("refgrad/unsharded/"):] for k in ref if k.startswith("refgrad/unsharded/")
            and not k.endswith("/loss")]
    assert len(keys) > 10
    for k in keys:
        want = ref[f"refgrad/unsharded/{k}"]
        np.testing.assert_allclose(ref[f"refgrad/model2/{k}"], want, rtol=0,
                                   atol=REF_GRAD_RTOL * np.abs(want).max(), err_msg=k)


# (case, leaves held, leaves that the rule sums over the axis)
RULES = {
    "qk_norms_under_a_head_split_are_summed": (
        "grads/tp", ("attn/q_norm", "attn/k_norm"), True),
    "router_under_expert_parallelism_is_summed": ("grads/tp", ("moe/router",), True),
    "aux_losses_are_counted_once": (
        "grads/aux", ("moe/router", "ln1/scale", "ln2/scale", "attn/wq", "attn/wk"), None),
    "sp_queries_keys_and_values_are_summed": (
        "grads/sp", ("attn/wq", "attn/wk", "attn/wv", "attn/q_norm", "attn/k_norm"), True),
    "sp_output_projection_and_moe_are_whole": (
        "grads/sp", ("attn/wo", "moe/router", "moe/experts/w_up", "ln2/scale"), False),
}


@functools.lru_cache(maxsize=None)
def _unsharded_grads(case):
    """The unsharded port's gradients for a ``_grads_case`` case."""
    from repro_torch.config import ShardingConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import items, leaves
    cfg = _torch_cfg(SP_ARCH)
    params = tfm.init_params(cfg, 0, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    sp = case == "grads/sp"
    tokens, labels = (torch.from_numpy(a).long() for a in (_sp_batch() if sp else _batch()))
    loss, aux = tfm.lm_loss(cfg, params, tokens, labels, tfm.Runtime(
        sharding=ShardingConfig(moe_impl="sorted"), **(SP_CHUNKS if sp else {})))
    if case == "grads/aux":
        loss = aux["moe_load_balance"] + aux["moe_router_z"]
    return dict(zip([p for p, _ in items(params)],
                    torch.autograd.grad(loss, leaves(params), allow_unused=True)))


@pytest.mark.parametrize("rule", list(RULES))
def test_backward_rule(runs, rule):
    """Each rule of the collectives' backward at the gradient level, against
    the unsharded port on the same weights and tokens."""
    case, names, summed = RULES[rule]
    want = _unsharded_grads(case)
    held = 0
    for res in _got(runs, case):
        for path, g in res["grads"].items():
            if not path.endswith(names):
                continue
            w = want[path]
            assert float(w.abs().max()) > 0, path
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=GRAD_RTOL * float(w.abs().max()), err_msg=path)
            if summed is not None:
                assert (path in res["partial"]) == summed, path
            held += 1
    assert held >= 2 * len(names)


def test_run_world_without_a_device_asks_for_the_card(monkeypatch):
    """The world launcher runs on the card unless the caller asks for the
    CPU: on a host with no card it raises before any rank starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no card"):
        run_world(_rank_cases, 2)
