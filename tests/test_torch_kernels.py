"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode on the CPU) and against the jnp code the reference's main
path runs; and the CPU dispatch of ``repro_torch.kernels.ops``.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: f32 results agree to 1e-5 absolute + 1e-5 relative (the two
frameworks sum in different orders); bf16 results to 1e-2 + 1e-2 (one bf16
rounding of f32 sums that differ in the last bits). Routing ids are exact.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
from repro.kernels import flash_attention as jfa
from repro.kernels import moe_gmm as jgmm
from repro.kernels import topk_gate as jtk
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import topk_gate as ttk

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pair(a, dtype):
    """The same numpy array as a jnp array and a torch tensor of one type."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_slot_gmm_plain_matches_pallas(dtype, tol):
    """K1 bf16/f32 body: out[e] = x[e] @ w[lut[e]], the MISS slot all zeros."""
    x_np = _np((4, 8, 32), 0)
    w_np = _np((6, 32, 48), 1, 32 ** -0.5)
    w_np[5] = 0.0
    lut_np = np.array([2, 5, 0, 2], np.int32)
    xj, xt = _pair(x_np, dtype)
    wj, wt = _pair(w_np, dtype)
    got = ops.slot_gmm(xt, wt, torch.from_numpy(lut_np))
    want = jgmm.slot_gmm(xj, wj, jnp.asarray(lut_np), interpret=True)
    assert got.dtype == xt.dtype and tuple(got.shape) == (4, 8, 48)
    _close(got, want, tol)
    assert not got[1].float().abs().sum()                      # read the MISS slot


@pytest.mark.parametrize("soft_cap", [None, 5.0])
def test_decode_attention_plain_matches_pallas(soft_cap):
    """K2: per-row lengths including 1 and a non-multiple of the block."""
    b, s, h, hkv, dh = 3, 64, 4, 2, 16
    q, k, v = _np((b, h, dh), 0), _np((b, s, hkv, dh), 1), _np((b, s, hkv, dh), 2)
    lengths = np.array([1, 37, 64], np.int32)
    got = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(lengths),
                                   soft_cap=soft_cap)
    want = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lengths), soft_cap=soft_cap, block_kv=16,
                                 interpret=True)
    _close(got, want, F32)


def test_topk_gate_plain_matches_pallas_and_lax_top_k_on_ties():
    """K3: forced ties go to the lowest index, as ``_topk_kernel`` and the
    main path's ``lax.top_k`` both break them."""
    logits = _np((16, 32), 3)
    logits[:, [3, 11, 20]] = 5.0
    logits[4, :] = 0.0                                          # an all-tied row
    for normalize in (True, False):
        ids, w = ops.topk_gate(torch.from_numpy(logits), 4, normalize=normalize)
        pid, pw = jtk.topk_gate(jnp.asarray(logits), 4, normalize=normalize,
                                interpret=True)
        lid, lw = jtk.route_topk(jnp.asarray(logits), 4, normalize=normalize)
        for want_ids, want_w in ((pid, pw), (lid, lw)):
            np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
            _close(w, want_w, F32)
        assert ids.dtype == torch.int32
        assert ids[4].tolist() == [0, 1, 2, 3]


ROUTE_MARGIN = 1e-6       # probability gap that a summation order cannot close


def _softmax(x):
    z = np.exp(x - x.max(-1, keepdims=True))
    return z / z.sum(-1, keepdims=True)


def _reference_route(h, router, k, normalize):
    """The reference's routing on the CPU: ``router_logits``, then the Pallas
    gate (interpret mode) and the main path's ``route_topk``."""
    logits = jmoe.router_logits({"router": jnp.asarray(router)}, jnp.asarray(h))
    return logits, [jtk.topk_gate(logits, k, normalize=normalize, interpret=True),
                    jtk.route_topk(logits, k, normalize=normalize)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("d,e,k", [(64, 8, 2), (2048, 128, 8), (2048, 60, 4)])
def test_router_topk_plain_matches_jax_router_and_pallas_gate(d, e, k, normalize, dtype):
    """K3's fused entry on the CPU (``ops.router_topk``: the plain router GEMM
    and gate) against ``router_logits`` + the Pallas gate and ``route_topk``
    on seeded random inputs. XLA-CPU and torch-CPU sum the GEMM in other
    orders, so ids must be equal on every row whose k-th and (k+1)-th
    probabilities differ by more than ROUTE_MARGIN; weights to 1e-5 + 1e-5."""
    t = 24
    hj, ht = _pair(_np((t, d), 7), dtype)
    router = _np((d, e), 8, d ** -0.5)
    ids, w = ops.router_topk(ht, torch.from_numpy(router), k, normalize=normalize)
    assert ids.dtype == torch.int32 and w.dtype == torch.float32
    logits, wants = _reference_route(hj, router, k, normalize)
    probs = -np.sort(-_softmax(np.asarray(logits, np.float64)), axis=-1)
    sure = probs[:, k - 1] - probs[:, k] > ROUTE_MARGIN
    assert sure.sum() >= t // 2
    for want_ids, want_w in wants:
        np.testing.assert_array_equal(ids.numpy()[sure], np.asarray(want_ids)[sure])
        _close(w, want_w, F32)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("e,k", [(8, 2), (128, 8), (60, 4)])
def test_router_topk_plain_breaks_exact_ties_as_the_reference(e, k, normalize):
    """Small integers (h2 in {-1, 0, 1}, router in {-2..2}, D = 64): every
    partial sum is exact in f32 in any order, so duplicated router columns
    tie exactly in both frameworks and ids must be equal on EVERY row. Row 0
    puts four equal columns on top, row 1 ties every expert."""
    rng = np.random.default_rng(e + k)
    d, t = 64, 16
    h = rng.integers(-1, 2, (t, d)).astype(np.float32)
    router = rng.integers(-2, 3, (d, e)).astype(np.float32)
    dup = [1, 3, e // 2, e - 1]
    router[:, dup] = 2.0 * np.sign(h[0])[:, None]          # row 0: these four win, tied
    h[1] = 0.0                                              # row 1: all logits 0
    ids, w = ops.router_topk(torch.from_numpy(h), torch.from_numpy(router), k,
                             normalize=normalize)
    _, wants = _reference_route(h, router, k, normalize)
    for want_ids, want_w in wants:
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        _close(w, want_w, F32)
    assert ids[0, :min(k, 4)].tolist() == dup[:k]
    assert ids[1].tolist() == list(range(k))


@pytest.mark.parametrize("d,e", [(2048, 128), (2048, 60), (64, 8), (100, 7), (8192, 256),
                                 (32, 1024)])
def test_router_plan_covers_d_once_and_tiles_fit_a_block(d, e):
    """The fused entry's plan (from D and E only): at most 16 spans (one
    cluster) of whole 32-row chunks cover D, none wholly past it; every row
    tile is R-row groups of 4 columns that 256 threads hold."""
    plan = ttk.router_plan(d, e)
    assert 1 <= plan.splits <= 16 and plan.span % 32 == 0
    assert (plan.splits - 1) * plan.span < d <= plan.splits * plan.span
    assert (plan.etiles, plan.ecols) == (1, e)
    for t in (1, 2, 3, 4, 5, 15, 16, 33, 64, 512, 1000):
        r, cv, rows = ttk.router_tile(t, e)
        assert (r, cv) in ((1, 1), (2, 1), (1, 4), (2, 4), (4, 4)) and rows % r == 0
        assert (rows // r) * (-(-e // 4) * 4 // cv) <= 256
        assert rows >= min(t, r)


def test_router_plan_at_the_main_path_shape():
    """qwen36-35b-a3b (D 2048, E 128): 16 spans of 128 rows in one cluster;
    decode takes one column a thread, prefill 32-row tiles of 4 x 4 a
    thread (16 x 16 blocks)."""
    assert ttk.router_plan(2048, 128) == ttk.RouterPlan(16, 128, 1, 128)
    assert ttk.router_tile(1, 128) == (1, 1, 1)
    assert ttk.router_tile(512, 128) == (4, 4, 32)


def test_router_topk_cpu_path_counts_nothing_and_the_kernel_refuses_cpu_tensors():
    """``ops.router_topk`` sends a CPU tensor to the plain version (the
    reference's bits: router GEMM then ``topk_gate_ref``) and counts nothing;
    the fused wrapper itself launches or raises."""
    ops.reset_launch_counts()
    h, r = torch.from_numpy(_np((5, 16), 0)), torch.from_numpy(_np((16, 8), 1))
    ids, w = ops.router_topk(h, r, 3, normalize=False)
    rid, rw = ref.topk_gate_ref(h @ r, 3, normalize=False)
    assert torch.equal(ids, rid) and torch.equal(w, rw)
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}
    assert ops.symbol_launch_counts() == {n: {} for n in ops.KERNELS}
    with pytest.raises(ValueError):
        ttk.router_topk(h, r, 3)
    with pytest.raises(ValueError):
        ops.router_topk(h.to("meta"), r.to("meta"), 3)


@pytest.mark.parametrize("window,soft_cap", [(None, None), (24, None), (None, 4.0), (40, 4.0)])
def test_flash_attention_plain_matches_pallas(window, soft_cap):
    """K4: causal GQA with window and soft-cap cases; blocks of 16 so
    unreachable blocks are skipped in the Pallas grid."""
    b, s, h, hkv, dh = 1, 64, 4, 2, 16
    q, k, v = _np((b, s, h, dh), 0), _np((b, s, hkv, dh), 1), _np((b, s, hkv, dh), 2)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, window=window, soft_cap=soft_cap)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               window=window, soft_cap=soft_cap, block_q=16, block_kv=16,
                               interpret=True)
    _close(got, want, F32)
    # and the chunked jnp path the reference's prefill runs at long prompts
    chunked = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=True, window=window, soft_cap=soft_cap,
                                      q_chunk=16, kv_chunk=16)
    _close(got, chunked, F32)


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    ops.reset_launch_counts()
    x = torch.from_numpy(_np((2, 1, 16), 0))
    w = torch.from_numpy(_np((3, 16, 8), 1))
    lut = torch.tensor([0, 2], dtype=torch.int32)
    torch.testing.assert_close(ops.slot_gmm(x, w, lut), ref.slot_gmm_ref(x, w, lut))
    ops.topk_gate(torch.from_numpy(_np((3, 8), 2)), 2)
    q = torch.from_numpy(_np((1, 1, 4, 16), 3))
    kv = torch.from_numpy(_np((1, 8, 2, 16), 4))
    ops.decode_attention(q, kv, kv, lengths=torch.tensor([4]))
    ops.flash_attention(torch.from_numpy(_np((1, 8, 4, 16), 5)), kv, kv)
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}


def test_kernel_wrappers_refuse_cpu_tensors_and_other_devices():
    """A CUDA wrapper launches or raises; no device quietly takes the plain path."""
    x = torch.zeros((2, 1, 16))
    with pytest.raises(ValueError):
        tgmm.slot_gmm(x, torch.zeros((3, 16, 8)), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ttk.topk_gate(torch.zeros((3, 8)), 2)
    with pytest.raises(ValueError):
        tdec.decode_attention(torch.zeros((1, 4, 16)), torch.zeros((1, 8, 2, 16)),
                              torch.zeros((1, 8, 2, 16)), torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tfa.flash_attention(torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 2, 16)),
                            torch.zeros((1, 8, 2, 16)))
    with pytest.raises(ValueError):
        ops.topk_gate(torch.zeros((3, 8), device="meta"), 2)
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}


def test_quantized_wrapper_refuses_cpu_tensors_and_bad_planes():
    """The int8/int4 bodies' wrapper: CPU tensors are refused (ops sends
    them to the plain version and counts nothing); planes are checked."""
    x = torch.zeros((2, 1, 16))
    lut = torch.zeros(2, dtype=torch.int32)
    q8, s8 = torch.zeros((3, 16, 8), dtype=torch.int8), torch.zeros((3, 8))
    q4 = torch.zeros((3, 8, 8), dtype=torch.uint8)
    s4 = torch.zeros((3, 2, 8), dtype=torch.float16)
    with pytest.raises(ValueError):
        tgmm.slot_gmm(x, q8, lut, s8)
    with pytest.raises(ValueError):
        tgmm.slot_gmm(x, q4, lut, s4, s4)
    meta = dict(device="meta")
    xm, lm = torch.zeros((2, 1, 16), **meta), torch.zeros(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError):
        ops.slot_gmm(xm, q8.to("meta"), lm, s8.to("meta"))
    ops.reset_launch_counts()
    out8 = ops.slot_gmm(x, q8, lut, s8)
    out4 = ops.slot_gmm(x, q4, lut, s4, s4)
    assert out8.dtype == out4.dtype == torch.float32
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}
    assert {"slot_gmm_int8", "slot_gmm_int8_tiled", "slot_gmm_int4",
            "slot_gmm_int4_tiled"} <= set(ops.KERNELS)


_PLAN_SHAPES = [
    (2048, 768, torch.bfloat16), (768, 2048, torch.bfloat16),   # main path: gate/up, down
    (2048, 768, torch.int8), (768, 2048, torch.int8),
    (2048, 768, torch.uint8), (768, 2048, torch.uint8),         # uint8: packed int4
    (256, 96, torch.float32), (132, 70, torch.uint8), (96, 33, torch.int8),
]


@pytest.mark.parametrize("d,f,w_dtype", _PLAN_SHAPES)
def test_gemv_plan_covers_every_row_once_whatever_c(d, f, w_dtype):
    """K1's GEMV plan: ``splits`` consecutive spans of 8 warps' runs cover
    the stored rows (D, or D/2 packed int4 rows), none of them empty, in at
    most one cluster of splits, so each row falls in exactly one run (the
    check the launcher makes before it launches); the plan takes only D, F
    and the format (never C or G), so the order of the sum over D is the
    same at every C."""
    assert list(inspect.signature(tgmm.gemv_plan).parameters) == ["d", "f", "w_dtype"]
    plan = tgmm.gemv_plan(d, f, w_dtype)
    rows = d // 2 if w_dtype == torch.uint8 else d
    span = tgmm.GEMV_WARPS * plan.rows_per_warp
    assert 1 <= plan.splits <= tgmm.GEMV_MAX_SPLITS
    assert plan.splits * span >= rows > (plan.splits - 1) * span
    if (d, f) in ((2048, 768), (768, 2048)):     # the decode shapes split D across blocks
        assert plan.splits > 1


@pytest.mark.parametrize("f,w_dtype,vector", [
    (768, torch.bfloat16, True), (2048, torch.bfloat16, True), (768, torch.int8, True),
    (768, torch.uint8, True), (96, torch.float32, True), (70, torch.bfloat16, False),
    (72, torch.bfloat16, True), (72, torch.int8, True), (68, torch.int8, False),
    (33, torch.uint8, False),
    (70, torch.float32, False), (72, torch.uint8, True), (68, torch.uint8, False),
])
def test_gemv_plan_takes_whole_chunk_loads_only_where_rows_are_whole_chunks(f, w_dtype, vector):
    """The vector/element choice follows F x element bytes alone: lanes load
    16 bytes, 8 for int8 and int4."""
    assert tgmm.gemv_plan(64, f, w_dtype).vector is vector


@pytest.mark.parametrize("d,w_dtype,fits", [
    (4096, torch.bfloat16, True), (4104, torch.bfloat16, False),
    (8192, torch.uint8, True), (8208, torch.uint8, False),
])
def test_gemv_plan_reaches_4096_stored_rows(d, w_dtype, fits):
    """Runs of up to 64 rows cover 8 splits x 8 warps x 64 = 4096 stored
    rows; deeper stores keep the GEMV body with longer runs (a warp stages
    its x 64 rows at a time), still in one cluster of 8 splits."""
    plan = tgmm.gemv_plan(d, 256, w_dtype)
    rows = d // 2 if w_dtype == torch.uint8 else d
    assert (plan.rows_per_warp <= 64) is fits
    assert plan.splits == tgmm.GEMV_MAX_SPLITS
    assert plan.splits * tgmm.GEMV_WARPS * plan.rows_per_warp >= rows


_DECODE_SHAPES = [
    (1024, 128, 8, torch.bfloat16), (4096, 128, 8, torch.bfloat16),   # main path; 4x longer
    (1024, 128, 8, torch.float32), (256, 64, 4, torch.bfloat16), (300, 64, 1, torch.float32),
    (64, 128, 16, torch.bfloat16), (1, 16, 2, torch.float32), (1000, 80, 4, torch.bfloat16),
    (65, 256, 8, torch.bfloat16),
]


@pytest.mark.parametrize("s,dh,g,dtype", _DECODE_SHAPES)
def test_decode_plan_covers_every_position_once_whatever_the_batch(s, dh, g, dtype):
    """K2's plan: ``splits`` spans of ``span`` positions (whole tiles) cover
    the cache's S positions, each position in exactly one span and no span
    wholly past S, in one cluster of at most 16 (the launcher's check); the
    plan takes S, dh, g and the type only, never B or a row's length, so a
    row's softmax and merge run in one order in every batch."""
    assert list(inspect.signature(tdec.decode_plan).parameters) == ["s", "dh", "g", "dtype"]
    plan = tdec.decode_plan(s, dh, g, dtype)
    assert 1 <= plan.splits <= tdec.MAX_SPLITS and plan.tile in tdec.TILES
    assert plan.span % plan.tile == 0
    owner = np.full(s, -1)
    for k in range(plan.splits):
        lo, hi = k * plan.span, min(s, (k + 1) * plan.span)
        assert lo < hi
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = k
    assert (owner >= 0).all()
    assert plan.tensor_cores == (dtype == torch.bfloat16 and dh in tdec.TENSOR_CORE_DH)


def test_decode_plan_at_the_main_path_shape():
    """At the decode shape (S 1024, dh 128, 8 heads per KV head, bf16) the
    cache is cut into 16 spans of one 64-position tile on tensor cores: 64
    blocks at batch 1, where the parent's two launches had 36 working."""
    plan = tdec.decode_plan(1024, 128, 8, torch.bfloat16)
    assert (plan.splits, plan.tile, plan.span, plan.tensor_cores) == (16, 64, 64, True)


_TILED_SHAPES = [
    (2048, 768, torch.bfloat16, torch.bfloat16, 0, True),     # prefill gate/up
    (768, 2048, torch.bfloat16, torch.bfloat16, 0, True),     # prefill down
    (2048, 768, torch.bfloat16, torch.int8, 0, True),
    (2048, 768, torch.bfloat16, torch.uint8, 64, True),
    (768, 2048, torch.bfloat16, torch.uint8, 32, True),
    (1024, 256, torch.bfloat16, torch.uint8, 128, True),
    (2048, 768, torch.float32, torch.float32, 0, False),      # f32 keeps CUDA cores
    (2048, 768, torch.float32, torch.int8, 0, False),
    (200, 72, torch.bfloat16, torch.int8, 0, False),          # int8 rows not whole 16 bytes
    (96, 33, torch.bfloat16, torch.bfloat16, 0, False),       # odd F
    (132, 70, torch.bfloat16, torch.uint8, 6, False),         # a group of 6
    (960, 256, torch.bfloat16, torch.uint8, 48, False),       # 48 neither divides 64 nor is divided
    (2048, 768, torch.bfloat16, torch.uint8, 16, False),      # a group of 16: no kernel built for it
]


@pytest.mark.parametrize("d,f,x_dtype,w_dtype,group,tensor_cores", _TILED_SHAPES)
def test_tiled_plan_covers_every_row_and_column_once_whatever_c(d, f, x_dtype, w_dtype, group,
                                                                 tensor_cores):
    """K1's tiled plan: its blocks of 64 rows x ``block_n`` columns cover
    every (row, column) of the output once at every C, and its D steps cover
    D once, in one order that the plan fixes without reading C or G (so row
    c of the output does not depend on C); int4 groups fall in whole k16
    slices of whole steps or whole runs of steps."""
    params = list(inspect.signature(tgmm.tiled_plan).parameters)
    assert params == ["d", "f", "x_dtype", "w_dtype", "group"]
    plan = tgmm.tiled_plan(d, f, x_dtype, w_dtype, group)
    assert plan.tensor_cores is tensor_cores
    if not tensor_cores:
        return
    bm, bn, bk = 64, plan.block_n, plan.block_k
    for c in (5, 33, 64, 65, 200):
        seen = np.zeros((c, f), np.int32)
        for m0 in range(0, c, bm):
            for n0 in range(0, f, bn):
                seen[m0:m0 + bm, n0:n0 + bn] += 1
        assert (seen == 1).all()
    steps = [(k0, min(d, k0 + bk)) for k0 in range(0, d, bk)]
    assert steps[0][0] == 0 and steps[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(steps, steps[1:]))
    if w_dtype == torch.uint8:
        assert group in tgmm.TILED_INT4_GROUPS and (bk % group == 0 or group % bk == 0)
