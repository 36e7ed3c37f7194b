"""The port's tensor (model) axis when serving against the JAX package.

One world of four ``gloo`` ranks (``distributed/world.py``) runs every case
of this module on sub-meshes (1, 4), (2, 2) and (1, 2) (``make_mesh`` over
the first ranks), each case's result or traceback recorded apart. The
reference runs in this process, unsharded (GSPMD's results are the
unsharded ones, so the reference needs one device): its ``prefill_model``
and ``decode_model`` under ``jax.jit``, and its Pallas ``decode_attention``
in interpret mode. Both start from the reference's weights
(``init_params``, key 0), carried to the port by ``bridge.from_reference``.
Configs are reduced and f32:

* qwen3-4b at 8 query / 4 KV heads: every projection split at tp 2 and 4;
* starcoder2-3b at 8 / 2 heads: at tp 4 ``wq`` / ``wo`` split and ``wk`` /
  ``wv`` whole (the mixed case of 24 / 2 heads at tp 4: a rank reads the KV
  head of its query groups);
* qwen36 (4 / 2 heads, tp 4 mixed; the MoE half expert-parallel).

Each arch prefills 4 rows x 12 tokens into a 32-position cache, then takes
4 decode steps fed tokens drawn from the seed: at tp 4 the slices hold
8 positions, so two ranks' slices are empty through every step and rank 1's
slice fills to its edge at the last step (length 16); at tp 2 rank 1's
slice stays empty and the last step ends on rank 0's edge. Every rank's
logits and its slice of every KV cache are held to the reference within
1e-4 (absolute and relative), as the port's unsharded parity tests; K2's
partial plain version and the merge to the Pallas kernel over the whole
cache within 1e-5. ``shard_params`` / ``shard_state`` are held to the
sanitized specs exactly, and a model axis > 1 must raise for training a
recurrent stack, a recurrent stack's decode and width, and a ring cache.
"""
import dataclasses
import traceback

import numpy as np
import pytest
import torch

from repro_torch.distributed.world import run_world

TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = ((1, 4), (2, 2), (1, 2))
ARCHS = (("qwen3-4b", (8, 4)), ("starcoder2-3b", (8, 2)), ("qwen36-35b-a3b", None))
B, S, CACHE, STEPS = 4, 12, 32, 4
WORLD, TIMEOUT = 4, 120


def _cfg(get_config, reduce, arch, heads):
    cfg = dataclasses.replace(reduce(get_config(arch)), dtype="float32")
    if heads is not None:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, num_heads=heads[0], num_kv_heads=heads[1]))
    return cfg


def _torch_cfg(arch):
    from repro_torch.config import get_config
    from repro_torch.configs import reduce_for_smoke
    return _cfg(get_config, reduce_for_smoke, arch, dict(ARCHS)[arch])


def _inputs():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
            "fed": rng.integers(0, 256, (STEPS, B)).astype(np.int32)}


# ---------------------------------------------------------------------------
# The reference, unsharded, in this process
# ---------------------------------------------------------------------------
def _reference(inputs):
    import jax
    import jax.numpy as jnp
    from repro.config import get_config
    from repro.configs import reduce_for_smoke
    from repro.models import transformer as jtfm

    out = {}
    for arch, heads in ARCHS:
        cfg = _cfg(get_config, reduce_for_smoke, arch, heads)
        params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
        rt = jtfm.Runtime(cache_len=CACHE)
        logits, state = jax.jit(lambda p, t: jtfm.prefill_model(cfg, p, t, rt))(
            params, jnp.asarray(inputs["tokens"]))
        dec = jax.jit(lambda p, tok, st, cl: jtfm.decode_model(cfg, p, tok, st, cl, rt)[:2])
        steps = []
        for i in range(STEPS):
            lg, state = dec(params, jnp.asarray(inputs["fed"][i]), state, jnp.int32(S + i))
            steps.append(np.asarray(lg))
        caches, li = {}, 0
        for si, (unit, reps) in enumerate(cfg.segments):
            for r in range(reps):
                for pi, _ in enumerate(unit):
                    for n in ("k", "v"):
                        caches[f"{li}/{n}"] = np.asarray(state[si][pi][n][r])
                    li += 1
        out[arch] = {"params": jax.tree.map(np.asarray, params), "prefill": np.asarray(logits),
                     "decode": np.stack(steps), "caches": caches}
    return out


# ---------------------------------------------------------------------------
# The port's side (every rank of the world)
# ---------------------------------------------------------------------------
def _counting(counts):
    """Count the sharded attention bodies' calls and K2's partial entry."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    for mod, name in ((tfm, "_tp_prefill"), (tfm, "_tp_decode"),
                      (ops, "decode_attention_partial")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        setattr(mod, name, wrapped)


def _shards_case(shape, weights):
    """Every parameter leaf against ``shard_tensor`` of the whole leaf at its
    sanitized ``param_spec``, and every leaf of a whole decode state against
    its ``state_spec`` shard: shapes and values exact."""
    from repro_torch.bridge import from_reference
    from repro_torch.config import ShapeConfig, ShardingConfig
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import items
    mesh = make_debug_mesh(*shape, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    sizes = shr.axis_sizes(mesh)
    out = {}
    for arch, _ in ARCHS:
        cfg = _torch_cfg(arch)
        sh = ShardingConfig(moe_impl="epsum")
        rt = tfm.Runtime(sharding=sh, mesh=mesh, cache_len=CACHE)
        full = from_reference(cfg, weights[arch])
        local = dict(items(tfm.shard_params(cfg, full, rt)))
        specs = shr.make_param_shardings(cfg, mesh, sh, full)
        cut = 0
        for path, leaf in items(full):
            spec = specs[path]
            parts = [int(np.prod([sizes[a] for a in shr._axes(e)])) for e in spec]
            want = tuple(n // p for n, p in zip(leaf.shape, parts))
            assert tuple(local[path].shape) == want, (arch, path, spec)
            assert torch.equal(local[path], shr.shard_tensor(leaf, spec, mesh)), (arch, path)
            cut += want != tuple(leaf.shape)
        state = tfm.zero_state(cfg, B, CACHE, "cpu")
        for layer in state:
            for t in layer.values():
                t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(1)))
        mine = tfm.shard_state(cfg, state, rt)
        cell = ShapeConfig(name="decode", seq_len=CACHE, global_batch=B, kind="decode")
        sspecs = shr.make_state_shardings(cfg, mesh, sh, state, cell)
        for li, layer in enumerate(state):
            for n, t in layer.items():
                spec = sspecs[f"{li}/{n}"]
                assert spec[1] == "model" and spec[0] == ("data" if B % shape[0] == 0 else None)
                assert torch.equal(mine[li][n], shr.shard_tensor(t, spec, mesh)), (arch, li, n)
                assert mine[li][n].shape[1] == CACHE // shape[1]
        out[arch] = cut
    return out


def _serve_case(shape, inputs, weights):
    """Prefill and STEPS decode steps of every arch on this rank's rows,
    parameters and cache slice; returns logits, caches and which rows and
    slice this rank holds."""
    from repro_torch.bridge import from_reference
    from repro_torch.config import ShardingConfig
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    mesh = make_debug_mesh(*shape, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    out = {}
    for arch, _ in ARCHS:
        cfg = _torch_cfg(arch)
        sh = ShardingConfig(moe_impl="epsum")
        rt = tfm.Runtime(sharding=sh, mesh=mesh, cache_len=CACHE)
        params = tfm.shard_params(cfg, from_reference(cfg, weights[arch]), rt)
        rows = shr.batch_spec(sh, mesh, B)
        tokens = shr.shard_tensor(torch.from_numpy(inputs["tokens"]), rows, mesh)
        logits, state = tfm.prefill_model(cfg, params, tokens, CACHE, rt=rt)
        fed = torch.from_numpy(inputs["fed"])
        steps = []
        for i in range(STEPS):
            tok = shr.shard_tensor(fed[i], shr.token_spec(sh, mesh, B), mesh)
            lg, _ = tfm.decode_model(cfg, params, tok, state, S + i, rt=rt)
            steps.append(lg.numpy())
        out[arch] = {"rows": shr.shard_bounds(B, rows[0], mesh), "tp_rank": rt.tp_rank(),
                     "prefill": logits.numpy(), "decode": np.stack(steps),
                     "caches": {f"{li}/{n}": st[n].numpy() for li, st in enumerate(state)
                                for n in ("k", "v")}}
    return out


def _raises_case(weights):
    """What a model axis > 1 refuses before anything is built (training a
    recurrent stack: the width split of its layers is not ported)."""
    from repro_torch.config import RunConfig, ShardingConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import make_train_step
    mesh = make_debug_mesh(1, 2, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    rt = tfm.Runtime(sharding=ShardingConfig(moe_impl="epsum"), mesh=mesh, cache_len=CACHE)
    cfg = _torch_cfg("qwen3-4b")
    rg = dataclasses.replace(reduce_for_smoke(get_config("recurrentgemma-2b")), dtype="float32")
    ring = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, window=8))
    params = tfm.init_params(cfg, 0, "cpu")
    tokens = torch.zeros((2, S), dtype=torch.long)
    calls = {
        "train recurrent": lambda: make_train_step(rg, rt, RunConfig()),
        "recurrent width": lambda: tfm.shard_params(rg, tfm.init_params(rg, 0, "cpu"), rt),
        "recurrent decode": lambda: tfm.decode_model(rg, params, tokens[:, 0], [], S, rt=rt),
        "recurrent state": lambda: tfm.shard_state(rg, tfm.zero_state(rg, 2, CACHE, "cpu"), rt),
        "ring prefill": lambda: tfm.prefill_model(ring, params, tokens, CACHE, rt=rt),
        "ring decode": lambda: tfm.decode_model(ring, params, tokens[:, 0], [], S, rt=rt),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = "returned"
        except ValueError as exc:
            out[name] = f"ValueError: {exc}"
    return out


def _rank_cases(rank, nprocs, inputs, weights):
    counts = {}
    _counting(counts)
    cases = [("shards-%dx%d" % s, lambda s=s: _shards_case(s, weights)) for s in MESHES]
    cases += [("serve-%dx%d" % s, lambda s=s: _serve_case(s, inputs, weights)) for s in MESHES]
    cases += [("raises", lambda: _raises_case(weights))]
    out = {}
    for name, fn in cases:
        counts.clear()
        try:
            out[name] = ("ok", fn(), dict(counts))
        except Exception:                     # recorded for this case alone
            out[name] = ("error", traceback.format_exc(), dict(counts))
    return out


@pytest.fixture(scope="module")
def runs():
    """(the ranks' results, the reference's), from the same weights."""
    inputs = _inputs()
    ref = _reference(inputs)
    weights = {arch: r.pop("params") for arch, r in ref.items()}
    results = run_world(_rank_cases, WORLD, args=(inputs, weights), device="cpu", timeout=TIMEOUT)
    return results, ref


def _case(runs, name):
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


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_shard_params_and_state_follow_the_specs(runs, shape):
    got, _ = _case(runs, "shards-%dx%d" % shape)
    held = [r for r in got if r is not None]
    assert len(held) == shape[0] * shape[1]
    for res in held:
        for arch, cut in res.items():
            assert cut > 0, f"{arch}: nothing cut at {shape}"


@pytest.mark.parametrize("arch", [a for a, _ in ARCHS])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_tp_prefill_and_decode_match_the_unsharded_reference(runs, shape, arch):
    got, counts = _case(runs, "serve-%dx%d" % shape)
    ref = runs[1][arch]
    tp = shape[1]
    for res in got:
        if res is None:
            continue
        r = res[arch]
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["prefill"], ref["prefill"][lo:hi], **TOL)
        np.testing.assert_allclose(r["decode"], ref["decode"][:, lo:hi], **TOL)
        n = CACHE // tp
        for key, cache in r["caches"].items():
            assert cache.shape[1] == n
            want = ref["caches"][key][lo:hi, r["tp_rank"] * n:(r["tp_rank"] + 1) * n]
            np.testing.assert_allclose(cache, want, **TOL)
    # the lengths: every decode step leaves a slice past S + STEPS empty, and
    # the last step's length S + STEPS ends on a slice edge
    assert (S + STEPS) % (CACHE // tp) == 0 and S + STEPS <= CACHE - CACHE // tp
    layers = sum(len(_torch_cfg(a).layer_kinds) for a, _ in ARCHS)   # every arch's
    for c in counts:
        assert c["_tp_prefill"] == layers                # one call a layer
        assert c["_tp_decode"] == c["decode_attention_partial"] == layers * STEPS


def test_partial_plain_version_and_merge_match_the_reference_kernel():
    """K2's partial plain version on each slice of a cache split four
    ways, merged in rank order, against the reference's Pallas
    ``decode_attention`` (interpret mode) over the whole cache: lengths
    with an empty slice (1 position: three empty slices), a slice edge
    (16), a length inside a slice, and the whole cache, with a soft-cap."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention as pallas_decode

    from repro_torch.distributed.parallel import merge_partials
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    b, h, hkv, dh, s, tp = 4, 8, 2, 16, 32, 4
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    lengths = np.array([1, 16, 21, 32], dtype=np.int32)
    for cap in (None, 5.0):
        want = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(lengths), soft_cap=cap, block_kv=8,
                                        interpret=True))
        n = s // tp
        parts = torch.stack([ops.decode_attention_partial(
            torch.from_numpy(q), torch.from_numpy(k[:, r * n:(r + 1) * n]),
            torch.from_numpy(v[:, r * n:(r + 1) * n]),
            lengths=torch.from_numpy(np.clip(lengths - r * n, 0, n)), soft_cap=cap)
            for r in range(tp)])
        assert torch.isinf(parts[1:, 0, :, -1]).all() and not torch.isnan(parts).any()
        np.testing.assert_allclose(merge_partials(parts).numpy(), want, atol=1e-5, rtol=1e-5)


def test_a_model_axis_raises_for_training_recurrent_stacks_and_rings(runs):
    got, _ = _case(runs, "raises")
    held = [r for r in got if r is not None]
    assert len(held) == 2
    for res in held:
        for name, what in res.items():
            assert what.startswith("ValueError"), (name, what)
