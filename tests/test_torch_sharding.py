"""The port's partition rules against the reference's, leaf by leaf.

For all 11 archs at published widths (``jax.eval_shape``: no weights, no
JAX devices), with FSDP on and off, at mesh sizes (16, 16), (2, 16, 16)
(dp over ("pod", "data"), with the error-feedback residuals) and (1, 4):
the port's ``make_param_shardings``, ``make_train_state_shardings`` and
``make_state_shardings`` give every leaf of the reference's trees the spec
the reference's own functions give it. The reference's ``sanitize_spec``
reads only ``mesh.shape``, so a mapping of axis sizes stands for its mesh,
and its ``NamedSharding`` is swapped for one that returns the spec. Its
size hints (``_TP_SIZE``, ``_DP_SIZE``) are module state that its
``make_*`` functions set: each test restores them (``monkeypatch.setitem``).

The port's own layout (a list of layers, unstacked) gets, per layer, the
spec of that layer stacked alone; the meshes are functions that raise
without a process group of their size.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import ShardingConfig as JSharding
from repro.config import get_config as jget
from repro.configs.shapes import SHAPES
from repro.distributed import sharding as jshr
from repro.models import init_params as jinit
from repro.models import transformer as jtfm
from repro.training import init_train_state as jinit_state
from repro_torch.config import ShapeConfig, ShardingConfig
from repro_torch.config import get_config as tget
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.distributed import FaultTolerantCoordinator
from repro_torch.distributed import sharding as shr
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttfm
from repro_torch.tree import items

# (mesh axis sizes, dp axes)
MESHES = (({"data": 16, "model": 16}, ("data",)),
          ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
          ({"data": 1, "model": 4}, ("data",)))
CELL = SHAPES["decode_32k"]


def _flat(tree):
    """The reference's tree of ``PartitionSpec`` -> {path: spec tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(jshr._path_keys(path)): tuple(spec) for path, spec in flat}


@pytest.fixture
def reference(monkeypatch):
    """The reference's sharding module with its hints restored after the
    test and ``NamedSharding(mesh, spec)`` returning the spec."""
    monkeypatch.setitem(jshr._TP_SIZE, "hint", jshr._TP_SIZE["hint"])
    monkeypatch.setitem(jshr._DP_SIZE, "hint", jshr._DP_SIZE["hint"])
    monkeypatch.setattr(jshr, "NamedSharding", lambda mesh, spec: spec)
    return jshr


class _Mesh:
    """The reference's view of a mesh: its ``shape`` mapping."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_match_the_reference(reference, arch):
    jc, tc = jget(arch), tget(arch)
    params = jax.eval_shape(lambda: jinit(jc, jax.random.PRNGKey(0)))
    dstate = jax.eval_shape(lambda: jtfm.zero_state(jc, 8, 1024))
    cell = ShapeConfig(CELL.name, CELL.seq_len, CELL.global_batch, CELL.kind)
    for sizes, dp in MESHES:
        pods = "pod" in sizes
        jsh = JSharding(dp_axes=dp, grad_compression="int8_ef" if pods else None)
        tsh = ShardingConfig(dp_axes=dp, grad_compression=jsh.grad_compression)
        state = jax.eval_shape(lambda: jinit_state(jc, jinit(jc, jax.random.PRNGKey(0)), jsh))
        assert ("ef" in state) == pods
        mesh = _Mesh(sizes)
        for fsdp in (False, True):
            want = _flat(reference.make_param_shardings(jc, mesh, jsh, params, fsdp=fsdp))
            got = shr.make_param_shardings(tc, sizes, tsh, params, fsdp=fsdp)
            assert got == want, (sizes, fsdp)
            want = _flat(reference.make_train_state_shardings(jc, mesh, jsh, state, fsdp=fsdp))
            got = shr.make_train_state_shardings(tc, sizes, tsh, state, fsdp=fsdp)
            assert got == want, (sizes, fsdp)
        want = _flat(reference.make_state_shardings(jc, mesh, jsh, dstate, CELL))
        assert shr.make_state_shardings(tc, sizes, tsh, dstate, cell) == want, sizes


@pytest.mark.parametrize("sizes,dp", MESHES, ids=("16x16", "2x16x16", "1x4"))
def test_input_specs_match_the_reference(sizes, dp):
    jsh, tsh = JSharding(dp_axes=dp), ShardingConfig(dp_axes=dp)
    mesh = _Mesh(sizes)
    assert shr.dp_size(sizes, tsh) == jshr.dp_size(mesh, jsh)
    for batch in (1, 2, 32, 128, 256):
        for port, ref in ((shr.batch_spec, jshr.batch_spec), (shr.token_spec, jshr.token_spec),
                          (shr.frontend_spec, jshr.frontend_spec)):
            assert port(tsh, sizes, batch) == tuple(ref(jsh, mesh, batch))
            assert port(tsh) == tuple(ref(jsh))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_port_layers_take_their_stacked_spec(arch):
    """On the port's own trees (reduced widths, tp 4): a layer's parameter,
    moment and decode-state leaves get the reference's spec of their layer
    stacked alone, without the leading entry; an unstacked leaf (embed,
    heads, norms) gets its spec as it is."""
    tc = treduce(tget(arch))
    params = ttfm.init_params(tc, 0, "cpu")
    sizes, sh = {"data": 2, "model": 4}, ShardingConfig()
    specs = shr.make_param_shardings(tc, sizes, sh, params, fsdp=True)
    state = {"params": params, "opt": {"m": params, "v": params, "step": torch.zeros(())}}
    tspecs = shr.make_train_state_shardings(tc, sizes, sh, state)
    for path, leaf in items(params):
        stacked = (1,) + tuple(leaf.shape) if path.startswith("layers/") else tuple(leaf.shape)
        want = shr.sanitize_spec(shr.param_spec(path, stacked, tc, sh, fsdp=True, tp_size=4),
                                 stacked, sizes)
        assert specs[path] == (want[1:] if path.startswith("layers/") else want), path
        assert len(specs[path]) == leaf.dim()
        assert len(tspecs[f"opt/m/{path}"]) == leaf.dim()
    assert tspecs["opt/step"] == ()
    dstate = ttfm.zero_state(tc, 4, 64, "cpu")
    cell = ShapeConfig("decode", 64, 4, "decode")
    dspecs = shr.make_state_shardings(tc, sizes, sh, dstate, cell)
    for path, leaf in items(dstate):
        assert len(dspecs[path]) == leaf.dim()
        if path.endswith(("/k", "/v")):
            assert dspecs[path] == ("data", "model", None, None)      # batch dp, sequence tp


def test_heads_rule_follows_the_tp_size():
    """The attention projections split over heads only where the heads
    divide the tp size (starcoder2-7b's 36 heads do not divide 16)."""
    cfg, sh = tget("starcoder2-7b"), ShardingConfig()
    assert shr.param_spec("layers/0/attn/wq", (4608, 4608), cfg, sh, tp_size=16) == (None, None)
    assert shr.param_spec("layers/0/attn/wq", (4608, 4608), cfg, sh, tp_size=4) == (None, "model")
    assert shr.param_spec("layers/0/attn/wo", (4608, 4608), cfg, sh, tp_size=4) == ("model", None)


def test_meshes_raise_without_their_world():
    """No process group is started here: every mesh function raises, and
    importing the module touched nothing."""
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_debug_mesh(1, 4, device="cpu")
    assert not torch.distributed.is_initialized()


def test_sharded_runtime_refuses_what_is_not_ported():
    """Under a mesh: an MoE layer needs ``moe_impl="epsum"`` and the tensor
    axis; pod compression refuses a tensor or data axis inside the pod (the
    model axis trains without it)."""
    from repro_torch.config import RunConfig
    from repro_torch.training import make_train_step

    class FakeMesh:
        mesh_dim_names = ("data",)
        shape = (1,)

    class FakePodMesh:
        mesh_dim_names = ("pod", "model")
        shape = (2, 2)

    rt = ttfm.Runtime(mesh=FakeMesh())
    with pytest.raises(ValueError, match="tensor axis"):
        rt.tp_size()
    with pytest.raises(ValueError, match="epsum"):
        dataclasses.replace(rt, sharding=ShardingConfig(moe_impl="sorted")).ep_axis()
    with pytest.raises(ValueError, match="inside a pod are not ported"):
        make_train_step(treduce(tget("starcoder2-3b")), ttfm.Runtime(mesh=FakePodMesh()),
                        RunConfig(), pod_compression=True)
    with pytest.raises(ValueError, match="'pod' axis"):
        make_train_step(treduce(tget("starcoder2-3b")), rt, RunConfig(), pod_compression=True)


def test_fault_tolerance_is_the_reference_copy():
    """The port keeps a copy of the reference's plain-Python coordinator;
    ``test_torch_elastic.py`` holds its behaviour to the reference's."""
    import inspect

    from repro.distributed import fault_tolerance as jft
    from repro_torch.distributed import fault_tolerance as tft
    body = inspect.getsource(jft)
    port = inspect.getsource(tft)
    assert port[port.index("import enum"):] == body[body.index("import enum"):]
    assert np.isclose(FaultTolerantCoordinator(2).backoff_s(), 60.0)
