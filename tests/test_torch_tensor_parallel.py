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

Rotary residency over the model axis rides the same world on the (1, 2)
sub-mesh: reduced f32 qwen36 (4 / 2 heads, 8 experts, F 48: 24 a rank), a
24-position cache (two slices of 12), 2 rows of a 20-token prompt in chunks
of 8 (the chunk at 8-15 straddles the slices), then 4 decode steps. At the
model level each layer's 8 experts sit in 6 slots (seeded; two miss) and
``prefill_chunk_model``, ``decode_model`` and a 3-position ``decode_window``
run on this rank's shards, F slice of the slots and cache slices, held to
the reference's functions unsharded within 1e-4 (the miss masks and each
rank's cache slice after the prompt too); ``RotaryEngine`` over the mesh at
6 slots, spec 1 and spec 2, is held to the reference's engine: tokens
exact, logits within 1e-4, the ranks' rotations (telemetry and LUTs)
equal, and every slot of every store exactly ``residency_spec``'s shard of
the expert its LUT names. K4's partial chunk plain version is merged over
slices against the Pallas ``flash_attention`` in interpret mode, and what
the engine does not run over a mesh raises (a stand-in mesh, no world).
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
QWEN = "qwen36-35b-a3b"
# rotary residency: rows, cache (two slices of 12), prompt, chunk, steps, slots, window
RB, R_CACHE, R_PROMPT, R_CHUNK, R_STEPS, R_SLOTS, R_WINDOW = 2, 24, 20, 8, 4, 6, 3


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
    rot = np.random.default_rng(3)
    return {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
            "fed": rng.integers(0, 256, (STEPS, B)).astype(np.int32),
            "r_tokens": rot.integers(0, 256, (RB, R_PROMPT)).astype(np.int32),
            "r_fed": rot.integers(0, 256, (R_STEPS, RB)).astype(np.int32)}


def _experts(weights, layer):
    """One MoE layer's whole expert stacks [E, ...] from the reference's
    stacked weights (numpy)."""
    ex = weights[QWEN]["segments"][0][0]["moe"]["experts"]
    return {n: np.asarray(w[layer]) for n, w in ex.items()}


def _slot_planes(experts, layer):
    """A layer's residency from its expert stacks: slot s holds expert
    ``perm[s]`` of a seeded permutation, then the zero MISS row; the LUT
    maps an expert to its slot, or to R_SLOTS (a miss)."""
    e = next(iter(experts.values())).shape[0]
    perm = np.random.default_rng(7 + layer).permutation(e)[:R_SLOTS]
    planes = {n: np.concatenate([w[perm], np.zeros((1,) + w.shape[1:], w.dtype)])
              for n, w in experts.items()}
    lut = np.full(e, R_SLOTS, np.int32)
    lut[perm] = np.arange(R_SLOTS)
    return planes, lut


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


def _stepped(engine, prompt):
    """Greedy tokens, one decode call a token, and the logits that chose
    them: [B, steps], [B, steps, V]."""
    logits = [np.asarray(engine.prefill(prompt), np.float32)]
    toks = []
    for _ in range(R_STEPS):
        toks.append(np.asarray(engine.decode(logits[-1], 1))[:, 0])
        logits.append(np.asarray(engine.last_logits, np.float32))
    return np.stack(toks, 1), np.stack(logits[:-1], 1)


def _rotary_reference(inputs, weights):
    """The reference unsharded on reduced f32 qwen36: the prompt's chunks
    (logits, miss masks, the caches after it), the decode steps and a
    window from the prompt's end through a fixed residency; its engine at
    R_SLOTS slots, spec 1 (a call a token) and spec 2 (one call)."""
    import jax
    import jax.numpy as jnp
    from repro.config import ResidencyConfig as JRes
    from repro.config import get_config
    from repro.configs import reduce_for_smoke
    from repro.core import RotaryEngine as JEngine
    from repro.core.engine import prefill_chunk_plan
    from repro.models import transformer as jtfm

    cfg = _cfg(get_config, reduce_for_smoke, QWEN, None)
    params = jax.tree.map(jnp.asarray, weights[QWEN])
    rt = jtfm.Runtime(cache_len=R_CACHE)
    layers = [_slot_planes(_experts(weights, r), r) for r in range(cfg.num_layers)]
    res = ({"slots": {n: jnp.stack([jnp.asarray(p[n]) for p, _ in layers]) for n in layers[0][0]},
            "lut": jnp.stack([jnp.asarray(lut) for _, lut in layers])},)
    chunk = jax.jit(lambda t, st, cl: jtfm.prefill_chunk_model(cfg, params, t, st, cl, rt, res))
    dec = jax.jit(lambda t, st, cl: jtfm.decode_model(cfg, params, t, st, cl, rt, res))
    win = jax.jit(lambda t, st, cl: jtfm.decode_window(cfg, params, t, st, cl, rt, R_WINDOW,
                                                       res)[:2])
    state, cur, chunks = jtfm.zero_state(cfg, RB, R_CACHE), 0, []
    for c in prefill_chunk_plan(R_PROMPT, R_CHUNK):
        lg, state, aux = chunk(jnp.asarray(inputs["r_tokens"][:, cur:cur + c]), state,
                               jnp.int32(cur))
        chunks.append((np.asarray(lg), np.asarray(aux["route_miss/seg0"])))
        cur += c
    post = state
    caches = {f"{li}/{n}": np.asarray(post[0][0][n][li]) for li in range(cfg.num_layers)
              for n in ("k", "v")}
    steps = []
    for i in range(R_STEPS):
        lg, state, aux = dec(jnp.asarray(inputs["r_fed"][i]), state, jnp.int32(R_PROMPT + i))
        steps.append((np.asarray(lg), np.asarray(aux["route_miss/seg0"])))
    draft, last = win(jnp.asarray(inputs["r_fed"][0]), post, jnp.int32(R_PROMPT))
    kw = dict(rt=rt, batch=RB, prefill_chunk=R_CHUNK)
    rescfg = JRes(mode="rotary", num_slots=R_SLOTS, prefetch_margin=1)
    engines = {1: _stepped(JEngine(cfg, params, rescfg, **kw), inputs["r_tokens"]),
               2: JEngine(cfg, params, rescfg, spec_k=2, **kw).generate(inputs["r_tokens"],
                                                                       R_STEPS)}
    return {"chunks": chunks, "caches": caches, "steps": steps, "draft": np.asarray(draft),
            "last": np.asarray(last), "engines": engines}


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


def _rotations(engine):
    """Every rotation's telemetry and the LUTs after it, as a list the
    manager's two rotation entries append to."""
    log, man = [], engine.manager
    for name in ("rotate_from_telemetry", "rotate_window_from_telemetry"):
        def wrapped(predictor, *arrays, _fn=getattr(man, name), **kw):
            out = _fn(predictor, *arrays, **kw)
            log.append([np.array(a) for a in arrays[:4]] + [p.lut.e2s.copy()
                                                            for p in man.policies])
            return out

        setattr(man, name, wrapped)
    return log


def _rotary_case(inputs, weights):
    """Rotary residency on this rank's shards of the (1, 2) sub-mesh: the
    model functions through ``shard_residency``'s F slices and the cache
    slices, then ``RotaryEngine`` over the mesh at spec 1 and spec 2, each
    store's slots against ``residency_spec``'s shards of their experts."""
    from repro_torch.bridge import from_reference
    from repro_torch.config import ResidencyConfig, ShardingConfig
    from repro_torch.core.engine import RotaryEngine, prefill_chunk_plan
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tfm
    mesh = make_debug_mesh(1, 2, device="cpu")
    if mesh.get_coordinate() is None:
        return None
    cfg = _torch_cfg(QWEN)
    sh = ShardingConfig(moe_impl="epsum")
    rt = tfm.Runtime(sharding=sh, mesh=mesh, cache_len=R_CACHE)
    whole = from_reference(cfg, weights[QWEN])
    params = tfm.shard_params(cfg, whole, rt)
    experts = [_experts(weights, r) for r in range(cfg.num_layers)]
    res = tfm.shard_residency(cfg, [
        ({n: torch.from_numpy(p) for n, p in planes.items()}, torch.from_numpy(lut).long())
        for planes, lut in (_slot_planes(ex, r) for r, ex in enumerate(experts))], rt)
    state = tfm._sharded_zero_state(cfg, RB, R_CACHE, rt, "cpu")
    tokens, fed = torch.from_numpy(inputs["r_tokens"]), torch.from_numpy(inputs["r_fed"])
    chunks, cur = [], 0
    for c in prefill_chunk_plan(R_PROMPT, R_CHUNK):
        lg, aux = tfm.prefill_chunk_model(cfg, params, tokens[:, cur:cur + c], state, cur, res,
                                          rt=rt)
        chunks.append((lg.numpy(), aux["route_miss"].numpy()))
        cur += c
    post = [{n: t.clone() for n, t in layer.items()} for layer in state]
    caches = {f"{li}/{n}": st[n].numpy().copy() for li, st in enumerate(post) for n in ("k", "v")}
    steps = []
    for i in range(R_STEPS):
        lg, aux = tfm.decode_model(cfg, params, fed[i], state, R_PROMPT + i, res, rt=rt)
        steps.append((lg.numpy(), aux["route_miss"].numpy()))
    draft, wl, _ = tfm.decode_window(cfg, params, fed[0], post, R_PROMPT, R_WINDOW, res, rt=rt)
    engines = {}
    for k in (1, 2):
        eng = RotaryEngine(cfg, whole, ResidencyConfig(mode="rotary", num_slots=R_SLOTS,
                                                       prefetch_margin=1),
                           rt=rt, batch=RB, device="cpu", spec_k=k, prefill_chunk=R_CHUNK)
        rotations = _rotations(eng)
        if k == 1:
            toks, lgs = _stepped(eng, inputs["r_tokens"])
        else:
            first = eng.prefill(inputs["r_tokens"])
            eng.logit_log = [first]
            toks = eng.decode(first, R_STEPS)
            lgs = eng.logged_logits()[:-1].transpose(1, 0, 2)
        exact = True
        for li, (store, pol) in enumerate(zip(eng.manager.stores, eng.manager.policies)):
            for name, plane in store.raw_dict().items():
                want = torch.zeros((R_SLOTS + 1,) + experts[li][name].shape[1:])
                for slot, e in enumerate(pol.lut.s2e):
                    if e >= 0:
                        want[slot] = torch.from_numpy(experts[li][name][e])
                spec = shr.residency_spec(name, sh)
                exact &= torch.equal(plane, shr.shard_tensor(want, spec, mesh))
        st = eng.stats
        engines[k] = {"tokens": toks, "logits": lgs, "rotations": rotations, "slots_exact": exact,
                      "misses": st.misses, "replays": st.replayed_steps + st.prefill_replays,
                      "windows": st.spec_windows}
    return {"tp_rank": rt.tp_rank(), "chunks": chunks, "caches": caches, "steps": steps,
            "draft": draft.numpy(), "last": wl[-1].numpy(), "engines": engines}


def _rank_cases(rank, nprocs, inputs, weights):
    counts = {}
    _counting(counts)
    cases = [("shards-%dx%d" % s, lambda s=s: _shards_case(s, weights)) for s in MESHES]
    cases += [("serve-%dx%d" % s, lambda s=s: _serve_case(s, inputs, weights)) for s in MESHES]
    cases += [("raises", lambda: _raises_case(weights)),
              ("rotary", lambda: _rotary_case(inputs, weights))]
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
    ref["rotary"] = _rotary_reference(inputs, weights)
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


def test_rotary_chunks_decode_and_window_match_the_unsharded_reference(runs):
    """The model functions with residency on each rank of (1, 2): the
    prompt's chunks (the second straddles the slices) and each rank's cache
    slice after them, the decode steps in rank 1's slice, a window from the
    prompt's end; logits within 1e-4, miss masks equal (some picks miss)."""
    got, _ = _case(runs, "rotary")
    ref = runs[1]["rotary"]
    held = [r for r in got if r is not None]
    assert len(held) == 2 and {r["tp_rank"] for r in held} == {0, 1}
    n = R_CACHE // 2
    for r in held:
        for (lg, miss), (jlg, jmiss) in zip(r["chunks"] + r["steps"], ref["chunks"] + ref["steps"]):
            np.testing.assert_allclose(lg, jlg, **TOL)
            np.testing.assert_array_equal(miss, jmiss)
        for key, cache in r["caches"].items():
            want = ref["caches"][key][:, r["tp_rank"] * n:(r["tp_rank"] + 1) * n]
            np.testing.assert_allclose(cache, want, **TOL)
        np.testing.assert_array_equal(r["draft"], ref["draft"])
        np.testing.assert_allclose(r["last"], ref["last"], **TOL)
    assert any(m.any() for _, m in ref["chunks"] + ref["steps"])
    assert len(ref["chunks"]) == 3 and 8 < R_CACHE // 2 < 16


@pytest.mark.parametrize("spec_k", [1, 2])
def test_rotary_engine_over_the_model_axis_matches_the_unsharded_reference(runs, spec_k):
    """RotaryEngine over (1, 2) at 6 of 8 slots: tokens exact, logits within
    1e-4 of the reference engine's (spec 2 against the reference's own
    invariant: its spec-2 tokens equal its spec-1 ones), misses corrected
    and replayed, the ranks' rotations equal, every slot exactly its
    expert's shard at ``residency_spec``."""
    got, _ = _case(runs, "rotary")
    held = [r["engines"][spec_k] for r in got if r is not None]
    jtoks, jlogits = runs[1]["rotary"]["engines"][1]
    if spec_k == 2:
        np.testing.assert_array_equal(runs[1]["rotary"]["engines"][2], jtoks)
    for r in held:
        np.testing.assert_array_equal(r["tokens"], jtoks)
        np.testing.assert_allclose(r["logits"], jlogits, **TOL)
        assert r["slots_exact"] and r["misses"] > 0 and r["replays"] > 0
        assert (r["windows"] > 0) == (spec_k == 2)
    a, b = (r["rotations"] for r in held)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_partial_chunk_plain_version_merged_matches_the_reference_kernel():
    """K4's partial chunk plain version on each slice of a cache split two
    ways, merged in rank order, against the Pallas ``flash_attention``
    (interpret mode) over the whole sequence, at a chunk that straddles
    the slices and one inside the first (whose second slice is empty:
    lse -inf), with and without a soft-cap."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as pallas_flash

    from repro_torch.distributed.parallel import merge_partials
    from repro_torch.kernels import ops
    rng = np.random.default_rng(6)
    b, h, hkv, dh, s, tp = 2, 8, 2, 16, 32, 2
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    n = s // tp
    for cap in (None, 5.0):
        want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=True, soft_cap=cap, block_q=8, block_kv=8,
                                       interpret=True))
        for cur, c in ((12, 8), (0, 8)):
            parts = torch.stack([ops.flash_attention_chunk_partial(
                torch.from_numpy(q[:, cur:cur + c]), torch.from_numpy(k[:, r * n:(r + 1) * n]),
                torch.from_numpy(v[:, r * n:(r + 1) * n]), torch.tensor(cur), r * n,
                soft_cap=cap) for r in range(tp)])
            assert not torch.isnan(parts).any()
            assert torch.isinf(parts[1, :, :max(0, n - cur), :, -1]).all()
            np.testing.assert_allclose(merge_partials(parts).numpy(), want[:, cur:cur + c],
                                       atol=1e-5, rtol=1e-5)


def test_rotary_engine_refuses_what_a_mesh_does_not_run():
    """Over a mesh, RotaryEngine raises before anything is built for each
    path it does not run there (a stand-in mesh: nothing reaches a process
    group)."""
    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import RotaryEngine
    from repro_torch.models import transformer as tfm

    class FakeMesh:
        mesh_dim_names = ("data", "model")
        shape = (1, 2)

        def size(self, dim):
            return self.shape[dim]

    cfg = _torch_cfg(QWEN)
    params = tfm.init_params(cfg, 0, "cpu")
    rt = tfm.Runtime(mesh=FakeMesh(), cache_len=R_CACHE)
    rot = dict(mode="rotary", num_slots=R_SLOTS, prefetch_margin=1)
    ok = dict(prefill_chunk=R_CHUNK)
    refused = {
        "host_routing=True": (rot, dict(ok, host_routing=True)),
        "LRU": (dict(rot, mode="lru"), ok),
        "fused_decode=False": (rot, dict(ok, fused_decode=False)),
        "prefetch=True": (rot, dict(ok, prefetch=True)),
        "int8 slots": (dict(rot, quantization="int8"), ok),
        "int4 slots": (dict(rot, quantization="int4", quant_group_size=16), ok),
        "legacy prefill walk": (rot, {}),
    }
    for what, (res, kw) in refused.items():
        with pytest.raises(ValueError, match="over a mesh"):
            RotaryEngine(cfg, params, ResidencyConfig(**res), rt=rt, device="cpu", **kw)
    data = tfm.Runtime(mesh=type("DataMesh", (FakeMesh,), {"shape": (2, 2)})(),
                       cache_len=R_CACHE)
    with pytest.raises(ValueError, match="rows split"):
        RotaryEngine(cfg, params, ResidencyConfig(**rot), rt=data, device="cpu", **ok)
    ring = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, window=8))
    with pytest.raises(ValueError, match="ring cache"):
        RotaryEngine(ring, tfm.init_params(ring, 0, "cpu"), ResidencyConfig(**rot), rt=rt,
                     device="cpu", **ok)


def test_window_snapshot_and_rollback_over_cache_slices():
    """``snapshot_kv_window`` / ``rollback_kv_window`` on each rank's slice
    of a cache split in two (a stand-in mesh for each rank, no world), for
    windows that straddle the slices or lie in one, each rolled back to
    several lengths: every slice equals the whole cache's rollback, cut."""
    from repro_torch.models import transformer as tfm

    class RankMesh:
        mesh_dim_names = ("data", "model")
        shape = (1, 2)

        def __init__(self, rank):
            self.rank = rank

        def size(self, dim):
            return self.shape[dim]

        def get_local_rank(self, axis):
            return self.rank if axis == "model" else 0

    rng = np.random.default_rng(9)
    b, cap, k, n = 2, R_CACHE, 4, R_CACHE // 2

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    whole = {name: arr(b, cap, 2, 4) for name in ("k", "v")}
    written = {name: arr(b, k, 2, 4) for name in ("k", "v")}
    for cur in (n - 2, R_PROMPT):
        for keep in (0, 1, 3):
            want = [{name: t.clone() for name, t in whole.items()}]
            saved = tfm.snapshot_kv_window(want, cur, k)
            for name in want[0]:
                want[0][name][:, cur:cur + k] = written[name]
            tfm.rollback_kv_window(want, saved, cur, k, keep)
            for r in range(2):
                rt = tfm.Runtime(mesh=RankMesh(r), cache_len=cap)
                mine = [{name: t[:, r * n:(r + 1) * n].clone() for name, t in whole.items()}]
                saved = tfm.snapshot_kv_window(mine, cur, k, rt=rt)
                for j in range(k):
                    if r * n <= cur + j < (r + 1) * n:
                        for name in mine[0]:
                            mine[0][name][:, cur + j - r * n] = written[name][:, j]
                tfm.rollback_kv_window(mine, saved, cur, k, keep, rt=rt)
                for name in mine[0]:
                    assert torch.equal(mine[0][name], want[0][name][:, r * n:(r + 1) * n]), (
                        cur, keep, r, name)
