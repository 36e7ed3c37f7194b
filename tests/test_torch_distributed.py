"""The port's sharded model paths and cross-pod compression over
``torch.distributed`` against the JAX package.

One world of four ``gloo`` ranks (``distributed/world.py``) runs every case
of this module, each on its own mesh (``launch.mesh.make_mesh`` over the
first ranks of the world), and records each case's result or traceback
apart; one JAX subprocess, with four host devices
(``--xla_force_host_platform_device_count=4``) and meshes of ``Auto`` axes,
runs the reference's side of every case and writes it to an npz. Both start
from the same weights: the port's ``init_params`` (seed 0), stacked into the
reference's layout for JAX. Configs are reduced and f32.

* EP prefill and decode: qwen36 at capacity factor 1.25 (assignments
  drop), 4 rows x 16 tokens, at meshes (1, 4) and (2, 2): ``prefill_model``
  (``moe_epsum_local`` in every MoE layer) and three ``decode_model``
  steps fed tokens drawn from the seed (``moe_epsum_decode_local``), each rank's
  rows against the reference's ``prefill_model`` / ``decode_model`` with
  ``moe_impl="epsum"``.
* SP prefill: 3,072 tokens at mesh (1, 3), where 4 heads do not divide 3:
  qwen36 with 9 stored experts (3 a rank; the ninth never routed) and
  recurrentgemma (window 16, ring caches): logits and every KV cache
  (qwen36's a rank's slice of the sequence, the state's layout under the
  tensor axis; recurrentgemma's whole on every rank).
* Pod compression at 2 pods: the int8 payload bitwise the plain numpy
  computation, the dequantized mean, the residual identity; 20 steps of
  error feedback at one pod against JAX's ``compressed_psum_pod`` (as
  ``tests/test_training.py`` runs it); two train steps with
  ``pod_compression=True`` (pods' parameters bitwise equal, the loss the
  mean of the pods' losses).

The ranks count their calls of ``_sp_attention`` and of both epsum bodies,
so a case shows that its sharded path ran. Tolerance: 1e-4 absolute and
relative on f32 logits and caches (as the port's unsharded parity tests);
int8 payloads and one-pod error feedback's means exact, its residuals
within one f32 rounding (XLA fuses the residual's multiply-add).
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
TOL = dict(atol=1e-4, rtol=1e-4)
EP_MESHES = ((1, 4), (2, 2))
EP_B, EP_S, EP_CACHE, EP_STEPS = 4, 16, 32, 3
SP_MESH, SP_LEN = (1, 3), 3072
SP_ARCHS = ("qwen36-35b-a3b", "recurrentgemma-2b")
POD_SHAPE, EF_STEPS = (8, 8), 20
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 16, 2
WORLD, TIMEOUT = 4, 120


def _cfg(get_config, reduce, arch, cf=None, padded=None):
    """A reduced f32 config of either package, MoE fields overridden."""
    cfg = dataclasses.replace(reduce(get_config(arch)), dtype="float32")
    if cfg.moe is not None:
        over = {k: v for k, v in (("capacity_factor", cf), ("padded_experts", padded))
                if v is not None}
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))
    return cfg


# (name, arch, capacity factor, stored experts) of each weight set
MODELS = (("ep", "qwen36-35b-a3b", 1.25, None),
          ("sp-qwen36-35b-a3b", "qwen36-35b-a3b", None, 9),
          ("sp-recurrentgemma-2b", "recurrentgemma-2b", None, None))


def _torch_cfg(name):
    from repro_torch.config import get_config
    from repro_torch.configs import reduce_for_smoke
    _, arch, cf, padded = next(m for m in MODELS if m[0] == name)
    return _cfg(get_config, reduce_for_smoke, arch, cf, padded)


def _torch_params(name):
    from repro_torch.models import transformer as tfm
    return tfm.init_params(_torch_cfg(name), 0, "cpu")


def _reference_layout(cfg, params):
    """The port's parameters as the reference's flat {path: array}: each
    segment's layers stacked on a leading axis (the inverse of
    ``bridge.from_reference``)."""
    from repro_torch.tree import items
    out = {f"{n}/{k}" if k else n: v.numpy() for n in params if n != "layers"
           for k, v in (items(params[n]) if isinstance(params[n], dict) else [("", params[n])])}
    base = 0
    for si, (unit, reps) in enumerate(cfg.segments):
        for pi in range(len(unit)):
            layers = [params["layers"][base + r * len(unit) + pi] for r in range(reps)]
            for path, _ in items(layers[0]):
                stack = [dict(items(layer))[path].numpy() for layer in layers]
                out[f"segments/{si}/{pi}/{path}"] = np.stack(stack)
        base += len(unit) * reps
    return out


def _inputs():
    rng = np.random.default_rng(0)
    return {"ep_tokens": rng.integers(0, 256, (EP_B, EP_S)).astype(np.int32),
            "ep_fed": rng.integers(0, 256, (EP_STEPS, EP_B)).astype(np.int32),
            "sp_tokens": rng.integers(0, 256, (1, SP_LEN)).astype(np.int32),
            "train_tokens": rng.integers(0, 256, (TRAIN_B, TRAIN_S)).astype(np.int32)}


# ---------------------------------------------------------------------------
# The reference's side (a subprocess with four host devices)
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


def _jax_side(in_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.compat import shard_map
    from repro.config import ShardingConfig, get_config
    from repro.configs import reduce_for_smoke
    from repro.models import transformer as jtfm
    from repro.training.compression import compressed_psum_pod

    data = dict(np.load(in_path))
    out = {}

    def model(name):
        _, arch, cf, padded = next(m for m in MODELS if m[0] == name)
        cfg = _cfg(get_config, reduce_for_smoke, arch, cf, padded)
        flat = {k[len(name) + 1:]: jnp.asarray(v) for k, v in data.items()
                if k.startswith(name + "/")}
        return cfg, _nest(flat)

    def mesh_of(shape, names=("data", "model")):
        return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

    cfg, params = model("ep")
    tokens = jnp.asarray(data["ep_tokens"])
    for shape in EP_MESHES:
        rt = jtfm.Runtime(sharding=ShardingConfig(moe_impl="epsum"), mesh=mesh_of(shape),
                          cache_len=EP_CACHE)
        logits, state = jax.jit(lambda p, t: jtfm.prefill_model(cfg, p, t, rt))(params, tokens)
        dec = jax.jit(lambda p, tok, st, cl: jtfm.decode_model(cfg, p, tok, st, cl, rt)[:2])
        tag = "ep/%dx%d" % shape
        out[f"{tag}/prefill"] = np.asarray(logits)
        steps = []
        for i in range(EP_STEPS):
            logits, state = dec(params, jnp.asarray(data["ep_fed"][i]), state,
                                jnp.int32(EP_S + i))
            steps.append(np.asarray(logits))
        out[f"{tag}/decode"] = np.stack(steps)
    for arch in SP_ARCHS:
        cfg, params = model(f"sp-{arch}")
        rt = jtfm.Runtime(sharding=ShardingConfig(moe_impl="epsum"), mesh=mesh_of(SP_MESH),
                          cache_len=SP_LEN)
        logits, state = jax.jit(lambda p, t: jtfm.prefill_model(cfg, p, t, rt))(
            params, jnp.asarray(data["sp_tokens"]))
        out[f"sp-{arch}/logits"] = np.asarray(logits)
        li = 0
        for si, (unit, reps) in enumerate(cfg.segments):
            for r in range(reps):
                for pi, kind in enumerate(unit):
                    for n in ("k", "v") if "k" in state[si][pi] else ():
                        out[f"sp-{arch}/{n}/{li}"] = np.asarray(state[si][pi][n][r])
                    li += 1
    # error feedback at one pod (the reference's own unbiasedness test)
    g = {"w": jnp.asarray(np.linspace(-1, 1, 64).reshape(POD_SHAPE), jnp.float32)}
    ef = {"w": jnp.zeros((1,) + POD_SHAPE, jnp.bfloat16)}
    pod = mesh_of((1,), ("pod",))
    from jax.sharding import PartitionSpec as P
    step = jax.jit(shard_map(lambda e: compressed_psum_pod(g, e, axis="pod", pod_count=1),
                             mesh=pod, in_specs=(P(),), out_specs=(P(), P()),
                             check_vma=False))
    outs, efs = [], []
    for _ in range(EF_STEPS):
        o, ef = step(ef)
        outs.append(np.asarray(o["w"]))
        efs.append(np.asarray(ef["w"].astype(jnp.float32)))
    out["ef/outs"], out["ef/ef"] = np.stack(outs), np.stack(efs)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# The port's side (every rank of the world)
# ---------------------------------------------------------------------------
def _counting(counts):
    """Wrap the sharded bodies so that each call is counted in ``counts``."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as tfm
    for mod, name in ((tfm, "_sp_attention"), (tmoe, "moe_epsum_local"),
                      (tmoe, "moe_epsum_decode_local")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        setattr(mod, name, wrapped)


def _ep_case(shape, inputs):
    from repro_torch.config import ShardingConfig
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    mesh = make_debug_mesh(*shape, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    cfg = _torch_cfg("ep")
    sh = ShardingConfig(moe_impl="epsum")
    rt = tfm.Runtime(sharding=sh, mesh=mesh, cache_len=EP_CACHE)
    params = tfm.shard_params(cfg, _torch_params("ep"), rt)
    rows = shr.batch_spec(sh, mesh, EP_B)
    tokens = shr.shard_tensor(torch.from_numpy(inputs["ep_tokens"]), rows, mesh)
    logits, state = tfm.prefill_model(cfg, params, tokens, EP_CACHE, rt=rt)
    fed = torch.from_numpy(inputs["ep_fed"])
    steps = []
    for i in range(EP_STEPS):
        tok = shr.shard_tensor(fed[i], shr.token_spec(sh, mesh, EP_B), mesh)
        step_logits, _ = tfm.decode_model(cfg, params, tok, state, EP_S + i, rt=rt)
        steps.append(step_logits.numpy())
    lo, hi = shr.shard_bounds(EP_B, rows[0], mesh)
    return {"rows": (lo, hi), "prefill": logits.numpy(), "decode": np.stack(steps)}


def _sp_case(arch, inputs):
    from repro_torch.config import ShardingConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    mesh = make_debug_mesh(*SP_MESH, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    name = f"sp-{arch}"
    cfg = _torch_cfg(name)
    rt = tfm.Runtime(sharding=ShardingConfig(moe_impl="epsum"), mesh=mesh, cache_len=SP_LEN)
    params = tfm.shard_params(cfg, _torch_params(name), rt)
    logits, state = tfm.prefill_model(cfg, params, torch.from_numpy(inputs["sp_tokens"]),
                                      SP_LEN, rt=rt)
    return {"logits": logits.numpy(), "tp_rank": rt.tp_rank(),
            "cache": {f"{n}/{li}": st[n].numpy() for li, st in enumerate(state)
                      for n in ("k", "v") if n in st}}


def _pod_payload_case(rank):
    """Two pods, each its own gradient: the mean, the residual, and the
    pods' shared maximum (for the plain payload)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import compression
    mesh = make_mesh((2,), ("pod",), device="cpu")
    if mesh.get_coordinate() is None:
        return None
    g = torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(POD_SHAPE)
                         .astype(np.float32))
    e = torch.from_numpy(np.random.default_rng(20 + rank).standard_normal((1,) + POD_SHAPE)
                         .astype(np.float32) * 1e-2).to(torch.bfloat16)
    out, new_e = compression.compressed_psum_pod([g], {"w": e}, mesh.get_group("pod"), 2)
    gf = g + e[0].float()
    amax = gf.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.get_group("pod"))
    q, _ = compression.quantize(gf, amax)
    return {"g": g.numpy(), "e": e.float().numpy(), "out": out[0].numpy(),
            "new_e": new_e["w"].float().numpy(), "q": q.numpy()}


def _ef_case():
    """Error feedback at one pod, 20 steps (the reference's own test)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import compression
    mesh = make_mesh((1,), ("pod",), device="cpu")
    if mesh.get_coordinate() is None:
        return None
    g = torch.from_numpy(np.linspace(-1, 1, 64).reshape(POD_SHAPE).astype(np.float32))
    ef = {"w": torch.zeros((1,) + POD_SHAPE, dtype=torch.bfloat16)}
    outs, efs = [], []
    for _ in range(EF_STEPS):
        o, ef = compression.compressed_psum_pod([g], ef, mesh.get_group("pod"), 1)
        outs.append(o[0].numpy())
        efs.append(ef["w"].float().numpy())
    return {"outs": np.stack(outs), "ef": np.stack(efs)}


def _train_case(rank, inputs):
    """Two pods train ``TRAIN_STEPS`` steps with pod compression, each on
    its half of the global batch; rank 2 takes the loss of each half alone
    from the same weights."""
    from repro_torch.config import RunConfig, ShardingConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.tree import leaves
    mesh = make_mesh((2,), ("pod",), device="cpu")
    cfg = _cfg(get_config, reduce_for_smoke, "qwen36-35b-a3b")     # dropless: cf 8
    run = RunConfig(learning_rate=1e-3, warmup_steps=0)
    tokens = torch.from_numpy(inputs["train_tokens"]).long()
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    halves = [slice(i * TRAIN_B // 2, (i + 1) * TRAIN_B // 2) for i in range(2)]
    params = tfm.init_params(cfg, 0, "cpu")
    if mesh.get_coordinate() is None:
        if rank != 2:
            return None
        with torch.no_grad():
            return {"halves": [float(tfm.lm_loss(cfg, params, tokens[h], labels[h],
                                                 tfm.Runtime())[0]) for h in halves]}
    state = init_train_state(cfg, params, ShardingConfig(grad_compression="int8_ef"))
    step = make_train_step(cfg, tfm.Runtime(mesh=mesh), run, pod_compression=True, pod_count=2)
    losses, snaps = [], []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, tokens[halves[rank]], labels[halves[rank]])
        losses.append(float(m["loss"]))
        snaps.append([p.detach().numpy().copy() for p in leaves(state["params"])])
    return {"loss": losses, "params": snaps,
            "ef_shapes": [tuple(e.shape) for e in leaves(state["ef"])]}


def _rank_cases(rank, nprocs, in_path):
    """Every case of the module on this rank: {case: ("ok", result or None
    off its mesh) or ("error", traceback)}, with the sharded bodies' calls
    counted per case."""
    inputs = dict(np.load(in_path))
    counts = {}
    _counting(counts)
    cases = [("ep-%dx%d" % s, lambda s=s: _ep_case(s, inputs)) for s in EP_MESHES]
    cases += [(f"sp-{a}", lambda a=a: _sp_case(a, inputs)) for a in SP_ARCHS]
    cases += [("pod-payload", lambda: _pod_payload_case(rank)), ("ef", _ef_case),
              ("pod-train", lambda: _train_case(rank, inputs))]
    out = {}
    for name, fn in cases:
        counts.clear()
        try:
            out[name] = ("ok", fn(), dict(counts))
        except Exception:                     # recorded for this case alone
            out[name] = ("error", traceback.format_exc(), dict(counts))
    return out


# ---------------------------------------------------------------------------
# The module's world and its reference, run once
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs():
    """(the ranks' results, the reference's npz): the JAX subprocess and the
    world side by side, from the same inputs file."""
    with tempfile.TemporaryDirectory() as d:
        in_path, ref_path = os.path.join(d, "in.npz"), os.path.join(d, "ref.npz")
        arrays = _inputs()
        for name, *_ in MODELS:
            flat = _reference_layout(_torch_cfg(name), _torch_params(name))
            arrays.update({f"{name}/{k}": v for k, v in flat.items()})
        np.savez(in_path, **arrays)
        code = ("import sys; sys.path[:0] = sys.argv[3:]; import test_torch_distributed as m; "
                "m._jax_side(sys.argv[1], sys.argv[2])")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
        start = time.monotonic()
        jax_side = subprocess.Popen([sys.executable, "-c", code, in_path, ref_path,
                                     str(ROOT / "tests"), str(ROOT / "src")], env=env)
        try:
            results = run_world(_rank_cases, WORLD, args=(in_path,), device="cpu", timeout=TIMEOUT)
            left = max(0.1, TIMEOUT - (time.monotonic() - start))     # its own TIMEOUT
            assert jax_side.wait(timeout=left) == 0, "the JAX side failed"
        finally:
            if jax_side.poll() is None:
                jax_side.kill()
                jax_side.wait()
        yield results, dict(np.load(ref_path))


def _case(runs, name):
    """Each rank's result of ``name`` (None off its mesh), and the counts of
    the ranks that ran it; a rank's recorded traceback fails the case."""
    results, _ = runs
    got, counts = [], []
    for rank, res in enumerate(results):
        status, value, n = res[name]
        if status == "error":
            pytest.fail(f"rank {rank}, case {name}:\n{value}")
        got.append(value)
        if value is not None:
            counts.append(n)
    return got, counts


@pytest.mark.parametrize("shape", EP_MESHES, ids=lambda s: "%dx%d" % s)
def test_ep_prefill_and_decode_match_jax(runs, shape):
    got, counts = _case(runs, "ep-%dx%d" % shape)
    ref = runs[1]
    tag = "ep/%dx%d" % shape
    for res in got:
        lo, hi = res["rows"]
        np.testing.assert_allclose(res["prefill"], ref[f"{tag}/prefill"][lo:hi], **TOL)
        np.testing.assert_allclose(res["decode"], ref[f"{tag}/decode"][:, lo:hi], **TOL)
    # two MoE layers: one moe_epsum_local each at prefill, one decode body a step
    assert all(n == {"moe_epsum_local": 2, "moe_epsum_decode_local": 2 * EP_STEPS}
               for n in counts), counts


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_sp_prefill_matches_jax(runs, arch):
    got, counts = _case(runs, f"sp-{arch}")
    ref = runs[1]
    assert sum(r is not None for r in got) == SP_MESH[0] * SP_MESH[1]
    for res in got:
        if res is None:
            continue
        np.testing.assert_allclose(res["logits"], ref[f"sp-{arch}/logits"], **TOL)
        assert res["cache"]
        for key, cache in res["cache"].items():
            want = ref[f"sp-{arch}/{key}"]
            if cache.shape[1] < want.shape[1]:         # this rank's slice of the sequence
                n = cache.shape[1]
                want = want[:, res["tp_rank"] * n:(res["tp_rank"] + 1) * n]
            np.testing.assert_allclose(cache, want, **TOL)
    attn_layers = sum(k in ("attn_moe", "attn_mlp", "local_attn")
                      for k in _torch_cfg(f"sp-{arch}").layer_kinds)
    moe_layers = sum(k == "attn_moe" for k in _torch_cfg(f"sp-{arch}").layer_kinds)
    for n in counts:
        assert n.get("_sp_attention") == attn_layers
        assert n.get("moe_epsum_local", 0) == moe_layers


def test_pod_compression_payload_mean_and_residual(runs):
    got, _ = _case(runs, "pod-payload")
    pods = [r for r in got if r is not None]
    assert len(pods) == 2
    gf = [p["g"] + p["e"][0] for p in pods]
    amax = np.float32(max(np.abs(x).max() for x in gf))
    scale = amax / np.float32(127.0) + np.float32(1e-12)
    for p, x in zip(pods, gf):
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(p["q"], q)                 # the int8 payload, bitwise
        resid = (x - q.astype(np.float32) * scale)[None]
        np.testing.assert_array_equal(p["new_e"], torch.from_numpy(resid).to(
            torch.bfloat16).float().numpy())                     # the residual, bf16
        assert np.abs(resid).max() <= scale / 2 + 1e-7
    mean = (pods[0]["q"].astype(np.int32) + pods[1]["q"].astype(np.int32)).astype(
        np.float32) * scale / np.float32(2)
    for p in pods:
        np.testing.assert_array_equal(p["out"], mean)            # both pods, the same mean
    np.testing.assert_allclose(pods[0]["out"], (gf[0] + gf[1]) / 2, atol=float(scale), rtol=0)


def test_error_feedback_matches_jax(runs):
    got, _ = _case(runs, "ef")
    res = next(r for r in got if r is not None)
    ref = runs[1]
    np.testing.assert_array_equal(res["outs"], ref["ef/outs"])    # payloads and scales exact
    # XLA contracts the residual ``gf - q * scale`` into one fused multiply-
    # add; PyTorch rounds the product first: one f32 rounding of a product
    # of at most amax (1.0) apart, 2**-24, before the bf16 store
    np.testing.assert_allclose(res["ef"], ref["ef/ef"], atol=2.0 ** -24, rtol=0)
    g = np.linspace(-1, 1, 64).reshape(POD_SHAPE)
    np.testing.assert_allclose(res["outs"].mean(axis=0), g, atol=5e-3)


def test_pod_compressed_train_step(runs):
    """The pods' parameters bitwise equal after every step, and the step's
    loss the mean of the halves' losses taken alone from the same weights
    (the reference's ``pmean`` over pods)."""
    got, _ = _case(runs, "pod-train")
    pods, alone = got[:2], got[2]
    assert pods[0]["ef_shapes"] and all(s[0] == 1 for s in pods[0]["ef_shapes"])
    for step in range(TRAIN_STEPS):
        assert pods[0]["loss"][step] == pods[1]["loss"][step]
        for a, b in zip(pods[0]["params"][step], pods[1]["params"][step]):
            np.testing.assert_array_equal(a, b)
    assert pods[0]["loss"][0] == pytest.approx(np.mean(alone["halves"]), rel=1e-6)
