"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and the engine on the card against the engine on the CPU.

Every test here is marked ``gpu`` and skips (from the ``card`` fixture)
where no CUDA device is present. This file imports no JAX, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: bf16 inputs are compared in f32 against the plain version on the
same inputs; the kernels accumulate in f32 in another order than the plain
version, and bf16 outputs round once more, so bf16 outputs are held to 2e-2
absolute + 2e-2 relative and f32 outputs to 1e-4 + 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import SOURCES, build

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2), torch.float32: dict(atol=1e-4, rtol=1e-4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build(SOURCES)
    return torch.device("cuda")


def _randn(shape, dtype, seed, device, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.parametrize("t", [1, 37, 512])
def test_topk_gate_kernel_matches_plain(card, t):
    rng = np.random.default_rng(t)
    logits = rng.standard_normal((t, 128)).astype(np.float32)
    logits[:, 5] = logits[:, 9] = logits[:, 70] = 6.0      # forced ties: lowest index first
    x = torch.from_numpy(logits).to(card)
    for normalize in (True, False):
        ids, w = ops.topk_gate(x, 8, normalize=normalize)
        rid, rw = ref.topk_gate_ref(x, 8, normalize=normalize)
        torch.cuda.synchronize()
        assert torch.equal(ids, rid)
        torch.testing.assert_close(w, rw, atol=1e-6, rtol=1e-5)
        assert ids[:, :3].tolist() == [[5, 9, 70]] * t


@pytest.mark.parametrize("e,k", [(8, 2), (60, 4), (300, 8), (1000, 40)])
def test_topk_gate_kernel_at_other_widths(card, e, k):
    """The logits-in entry past the main path: a row in registers (E 8, 60),
    in shared memory (E 300, 1000), and more than 32 picks (k 40)."""
    x = _randn((37, e), torch.float32, e, card, scale=3.0)
    x[:, [1, 5]] = 20.0                                    # tied on top: lowest index first
    for normalize in (True, False):
        ids, w = ops.topk_gate(x, k, normalize=normalize)
        rid, rw = ref.topk_gate_ref(x, k, normalize=normalize)
        torch.cuda.synchronize()
        assert torch.equal(ids, rid)
        torch.testing.assert_close(w, rw, atol=1e-6, rtol=1e-5)
        assert ids[:, :2].tolist() == [[1, 5]] * 37


# K3's fused entry against its plain version (cuBLAS's f32 GEMM, then the
# plain gate). The two sum the router GEMM in other orders, so ids must be
# equal on every row whose plain k-th and (k+1)-th probabilities differ by
# more than ROUTE_MARGIN, and weights agree to 1e-5 + 1e-5 (logits that
# differ in the last bits of f32, through the softmax).
ROUTE_MARGIN = 1e-6
ROUTE_TOL = dict(atol=1e-5, rtol=1e-5)
ROUTE_SHAPES = [(64, 8, 2), (2048, 128, 8), (2048, 60, 4),
                (256, 300, 8),     # E 300: a shared-memory row
                (100, 30, 3),      # odd D and E: element copies, no TMA
                (8192, 128, 8),    # spans of 16 chunks: the ring of 4 stages
                (2048, 1024, 8)]   # E 1024: one stage fits, the ring again


def _route_inputs(t, d, e, dtype, device, seed=0):
    return (_randn((t, d), dtype, seed, device),
            _randn((d, e), torch.float32, seed + 1, device, scale=d ** -0.5))


def _check_route(h, router, k, normalize, ids, w):
    rid, rw = ref.router_topk_ref(h, router, k, normalize=normalize)
    probs = torch.softmax(h.float() @ router, -1).sort(dim=-1, descending=True).values
    sure = probs[:, k - 1] - probs[:, k] > ROUTE_MARGIN
    assert sure.float().mean() > 0.5
    assert torch.equal(ids[sure], rid[sure])
    torch.testing.assert_close(w, rw, **ROUTE_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,e,k", ROUTE_SHAPES)
@pytest.mark.parametrize("t", [1, 2, 4, 5, 33, 512])
def test_router_topk_kernel_matches_plain(card, t, d, e, k, dtype):
    h, router = _route_inputs(t, d, e, dtype, card, seed=t)
    for normalize in (True, False):
        ops.reset_launch_counts()
        ids, w = ops.router_topk(h, router, k, normalize=normalize)
        torch.cuda.synchronize()
        assert ops.launch_counts()["topk_gate"] == 1
        assert ops.symbol_launch_counts()["topk_gate"] == {
            "router_topk_bf16" if dtype == torch.bfloat16 else "router_topk_f32": 1}
        assert ids.dtype == torch.int32 and tuple(ids.shape) == (t, k)
        _check_route(h, router, k, normalize, ids, w)


@pytest.mark.parametrize("e,k", [(8, 2), (128, 8), (60, 4)])
def test_router_topk_kernel_breaks_ties_lowest_index_first(card, e, k):
    """Small integers (h2 in {-1, 0, 1}, router in {-2..2}, D 64): the sums
    are exact in any order, so the kernel's ids equal the plain version's on
    every row. Row 0 has four equal columns on top, row 1 ties every expert."""
    rng = np.random.default_rng(e + k)
    h = rng.integers(-1, 2, (16, 64)).astype(np.float32)
    router = rng.integers(-2, 3, (64, e)).astype(np.float32)
    dup = [1, 3, e // 2, e - 1]
    router[:, dup] = 2.0 * np.sign(h[0])[:, None]
    h[1] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        ht = torch.from_numpy(h).to(card, dtype)
        rt = torch.from_numpy(router).to(card)
        for normalize in (True, False):
            ids, w = ops.router_topk(ht, rt, k, normalize=normalize)
            rid, rw = ref.router_topk_ref(ht, rt, k, normalize=normalize)
            torch.cuda.synchronize()
            assert torch.equal(ids, rid)
            torch.testing.assert_close(w, rw, atol=1e-6, rtol=1e-5)
            assert ids[0, :min(k, 4)].tolist() == dup[:k]
            assert ids[1].tolist() == list(range(k))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,e,k", ROUTE_SHAPES)
def test_router_topk_rows_are_bitwise_invariant(card, d, e, k, dtype):
    """The plan reads D and E only and a row's sums run in one order: row t
    has the same ids and weights bits at T = 1, 5 and 512, under another row
    tile, with E split into tiles (the sweep's variant), and on two launches."""
    from repro_torch.kernels import topk_gate as tk

    h, router = _route_inputs(512, d, e, dtype, card, seed=7)
    full = tk.router_topk(h, router, k)
    again = tk.router_topk(h, router, k)
    five = tk.router_topk(h[:5].contiguous(), router, k)
    one = [tk.router_topk(h[i:i + 1].contiguous(), router, k) for i in (0, 3, 511)]
    plan = tk.router_plan(d, e)
    groups = tk.ROUTER_THREADS // (-(-e // 4))              # row groups of 4 columns a block holds
    other_tile = tk.router_topk(h, router, k, tile=(2, 4, 2 * min(3, groups)))
    ecols = -(-e // 16) * 4
    esplit = tk.router_topk(h, router, k, plan=dataclasses.replace(
        plan, etiles=-(-e // ecols), ecols=ecols))
    torch.cuda.synchronize()
    for got in (again, other_tile, esplit):
        assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    assert torch.equal(five[0], full[0][:5]) and torch.equal(five[1], full[1][:5])
    for i, got in zip((0, 3, 511), one):
        assert torch.equal(got[0], full[0][i:i + 1]) and torch.equal(got[1], full[1][i:i + 1])
    _check_route(h, router, k, True, *full)


def test_router_topk_refuses_what_it_does_not_take(card):
    h, router = _route_inputs(4, 64, 8, torch.float32, card)
    with pytest.raises(ValueError):
        ops.router_topk(h.half(), router, 2)                      # f16 h2
    with pytest.raises(ValueError):
        ops.router_topk(h, router.to(torch.bfloat16), 2)          # a bf16 router
    with pytest.raises(ValueError):
        ops.router_topk(h.t().contiguous().t(), router, 2)        # not contiguous
    with pytest.raises(ValueError):
        ops.router_topk(h, router[:32], 2)                        # D differs
    with pytest.raises(ValueError):
        ops.router_topk(h, router, 9)                             # k > E
    with pytest.raises(ValueError):
        ops.router_topk(h, router.cpu(), 2)                       # another device
    with pytest.raises(ValueError):
        ops.router_topk(h[:, :64], torch.zeros((64, 1100), device=card), 2)   # E past 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,c,d,f", [(8, 1, 256, 96), (5, 3, 130, 70), (4, 40, 200, 72)])
def test_slot_gmm_kernel_matches_plain(card, dtype, g, c, d, f):
    x = _randn((g, c, d), dtype, 0, card)
    w = _randn((7, d, f), dtype, 1, card, scale=d ** -0.5)
    w[6] = 0                                                   # the MISS slot
    lut = torch.tensor([(3 * i + 1) % 7 for i in range(g)], dtype=torch.int32, device=card)
    out = ops.slot_gmm(x, w, lut)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.slot_gmm_ref(x, w, lut).float(), **TOL[dtype])


def _quant_store(kind, s1, d, f, group, device, seed):
    """A random [s1, d, f] store quantized as the manager does, its last
    slot the zero MISS slot in every plane."""
    from repro_torch.core.slots import quantize_int8_batch
    from repro_torch.quant import quantize_int4_batch

    w = _randn((s1, d, f), torch.float32, seed, "cpu", scale=d ** -0.5)
    planes = list(quantize_int8_batch(w) if kind == "int8" else quantize_int4_batch(w, group))
    for p in planes:
        p[s1 - 1] = 0
    return [p.to(device) for p in planes] + [None] * (3 - len(planes))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,c,d,f,group", [
    (8, 1, 256, 96, 64),       # GEMV, decode
    (5, 4, 132, 70, 6),        # GEMV at its largest C, a group of 6, F not a tile multiple
    (4, 5, 200, 72, 8),        # tiled at its smallest C, D not a multiple of 32
    (3, 64, 768, 130, 64),     # tiled, w_down's depth: 12 groups
    (6, 37, 96, 33, 6),        # tiled, odd F, groups of 6 straddling every 32-row step
])
def test_quantized_slot_gmm_kernels_match_plain(card, kind, dtype, g, c, d, f, group):
    """The int8/int4 bodies against the plain version on the same planes:
    f32 outputs, 1e-4 + 1e-4 (f32 sums in another order); a group that
    reads the MISS slot gives exactly 0."""
    x = _randn((g, c, d), dtype, 0, card)
    w, scale, mn = _quant_store(kind, 7, d, f, group, card, 1)
    lut = torch.tensor([(3 * i + 1) % 7 for i in range(g)], dtype=torch.int32, device=card)
    lut[-1] = 6
    ops.reset_launch_counts()
    out = ops.slot_gmm(x, w, lut, scale, mn)
    torch.cuda.synchronize()
    body = f"slot_gmm_{kind}" + ("" if c <= 4 else "_tiled")
    assert ops.launch_counts()[body] == 1
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref.slot_gmm_ref(x, w, lut, scale, mn), atol=1e-4, rtol=1e-4)
    assert not out[-1].abs().sum()


def test_quantized_wrapper_refuses_mismatched_planes(card):
    from repro_torch.kernels import moe_gmm as gmm

    x = torch.zeros((2, 1, 64), device=card)
    lut = torch.zeros(2, dtype=torch.int32, device=card)
    w, scale, mn = _quant_store("int4", 3, 64, 16, 16, card, 0)
    with pytest.raises(ValueError):
        gmm.slot_gmm(x, w, lut, scale)                     # no min plane
    with pytest.raises(ValueError):
        gmm.slot_gmm(x, w, lut, scale.float(), mn)         # scale in the wrong type
    with pytest.raises(ValueError):                       # an int8 store takes no min
        gmm.slot_gmm(x[..., :32].contiguous(), w.view(torch.int8), lut, scale[:, 0], mn)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_decode_attention_kernel_matches_plain(card, dtype, soft_cap):
    b, s, h, hkv, dh = 3, 256, 8, 2, 64
    q = _randn((b, h, dh), dtype, 0, card)
    k = _randn((b, s, hkv, dh), dtype, 1, card)
    v = _randn((b, s, hkv, dh), dtype, 2, card)
    lengths = torch.tensor([1, 65, 256], dtype=torch.int32, device=card)
    from repro_torch.kernels import decode_attention as dec

    out = dec.decode_attention(q, k, v, lengths, soft_cap=soft_cap)
    torch.cuda.synchronize()
    exp = ref.decode_attention_ref(q, k, v, lengths, soft_cap=soft_cap)
    torch.testing.assert_close(out.float(), exp.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window,soft_cap", [(None, None), (48, None), (None, 20.0)])
def test_flash_attention_kernel_matches_plain(card, dtype, window, soft_cap):
    b, s, h, hkv, dh = 2, 150, 4, 2, 64
    q = _randn((b, s, h, dh), dtype, 0, card)
    k = _randn((b, s, hkv, dh), dtype, 1, card)
    v = _randn((b, s, hkv, dh), dtype, 2, card)
    out = ops.flash_attention(q, k, v, causal=True, window=window, soft_cap=soft_cap)
    torch.cuda.synchronize()
    exp = ref.flash_attention_ref(q, k, v, causal=True, window=window, soft_cap=soft_cap)
    torch.testing.assert_close(out.float(), exp.float(), **TOL[dtype])


@pytest.mark.parametrize("s,dh,window,soft_cap", [
    (512, 128, None, None),          # the main path's prefill: 32 heads on 4 KV heads
    (200, 128, 48, None),            # ragged length (not a tile multiple), sliding window
    (200, 128, None, 20.0),          # ragged length, tanh soft-cap
])
def test_flash_attention_bf16_tensor_core_body(card, s, dh, window, soft_cap):
    """The bf16 tensor-core body at dh 128 against the plain version: bf16
    tolerance (P is rounded to bf16 before P V, as the TPU's matrix unit
    rounds the Pallas body's f32 operands)."""
    h, hkv = 32, 4
    q = _randn((1, s, h, dh), torch.bfloat16, 0, card)
    k = _randn((1, s, hkv, dh), torch.bfloat16, 1, card)
    v = _randn((1, s, hkv, dh), torch.bfloat16, 2, card)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=window, soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    exp = ref.flash_attention_ref(q, k, v, causal=True, window=window, soft_cap=soft_cap)
    torch.testing.assert_close(out.float(), exp.float(), **TOL[torch.bfloat16])


def test_flash_attention_bf16_query_tiles_with_no_keys(card):
    """Fewer keys than queries with a window: rows 147.. of 200 reach no key,
    and the last query tile no KV tile at all, so only the final barrier
    orders the warps' copies of Q before the output is staged over them.
    Rows with keys hold the plain version's values; rows without give
    zeros (the plain version spreads them evenly over the masked keys).
    Repeated, since a missing barrier shows only now and then."""
    h, hkv, dh, sq, skv, window = 32, 4, 128, 200, 100, 48
    q = _randn((1, sq, h, dh), torch.bfloat16, 0, card)
    k = _randn((1, skv, hkv, dh), torch.bfloat16, 1, card)
    v = _randn((1, skv, hkv, dh), torch.bfloat16, 2, card)
    exp = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    reach = skv - 1 + window                                   # first row past every key
    for _ in range(20):
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[:, :reach].float(), exp[:, :reach].float(),
                                   **TOL[torch.bfloat16])
        assert not out[:, reach:].float().abs().sum()


@functools.lru_cache(maxsize=None)
def _main_store(kind, d, f, device):
    """A [97, d, f] store as the main path holds it: bf16, or int8 / int4
    (groups of 64) quantized from it, slot 96 the zero MISS slot."""
    if kind == "bf16":
        w = _randn((97, d, f), torch.bfloat16, 1, device, scale=d ** -0.5)
        w[96] = 0
        return w, None, None
    w, scale, mn = _quant_store(kind, 97, d, f, 64, "cpu", 1)
    return w.to(device), scale.to(device), None if mn is None else mn.to(device)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("d,f", [(2048, 768), (768, 2048)])
@pytest.mark.parametrize("c", [1, 4])
def test_slot_gmm_gemv_at_the_main_path_widths(card, kind, d, f, c):
    """The GEMV bodies at the decode gate/up and down widths, 8 picks, one
    of them the MISS slot: bf16 out at the bf16 tolerance, f32 out at 1e-4."""
    x = _randn((8, c, d), torch.bfloat16, 0, card)
    w, scale, mn = _main_store(kind, d, f, str(card))
    lut = torch.tensor([3, 17, 96, 40, 41, 0, 95, 63], dtype=torch.int32, device=card)
    ops.reset_launch_counts()
    out = ops.slot_gmm(x, w, lut, scale, mn)
    torch.cuda.synchronize()
    assert ops.launch_counts()["slot_gmm" + ("" if kind == "bf16" else f"_{kind}")] == 1
    want = ref.slot_gmm_ref(x, w, lut, scale, mn)
    tol = TOL[torch.bfloat16] if kind == "bf16" else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert not out[2].float().abs().sum()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("d,f", [(2048, 768), (768, 2048)])
def test_slot_gmm_gemv_is_bitwise_stable_and_independent_of_c(card, kind, d, f):
    """No atomics and a plan that ignores C: two launches give the same bits,
    and row 0 of a C = 4 launch equals the C = 1 launch of that row."""
    x = _randn((8, 4, d), torch.bfloat16, 0, card)
    w, scale, mn = _main_store(kind, d, f, str(card))
    lut = torch.tensor([5, 6, 7, 8, 9, 10, 11, 96], dtype=torch.int32, device=card)
    first = ops.slot_gmm(x, w, lut, scale, mn)
    again = ops.slot_gmm(x, w, lut, scale, mn)
    one = ops.slot_gmm(x[:, :1].contiguous(), w, lut, scale, mn)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first[:, :1], one)


@pytest.mark.parametrize("kind,g,c,d,f", [
    ("bf16", 3, 4, 4104, 768),      # 4104 stored rows: runs of 65, two staged chunks
    ("bf16", 2, 2, 9000, 70),       # element loads, runs of 141 in three chunks
    ("int8", 3, 1, 5000, 72),
    ("int4", 3, 3, 8320, 768),      # 4160 packed rows, groups of 64
])
def test_slot_gmm_gemv_past_4096_stored_rows(card, kind, g, c, d, f):
    """Stores deeper than 8 splits x 8 warps x 64 rows keep the GEMV body at
    C <= 4 (longer runs; a warp stages its x 64 rows at a time), held to the
    plain version like the shallow stores."""
    x = _randn((g, c, d), torch.bfloat16, 0, card)
    if kind == "bf16":
        w = _randn((5, d, f), torch.bfloat16, 1, card, scale=d ** -0.5)
        w[4] = 0
        scale = mn = None
    else:
        w, scale, mn = _quant_store(kind, 5, d, f, 64, card, 1)
    lut = torch.tensor([2, 0, 4][:g], dtype=torch.int32, device=card)
    ops.reset_launch_counts()
    out = ops.slot_gmm(x, w, lut, scale, mn)
    torch.cuda.synchronize()
    body = "slot_gmm" + ("" if kind == "bf16" else f"_{kind}")
    assert ops.launch_counts()[body] == 1 and ops.launch_counts()[body + "_tiled"] == 0
    tol = TOL[torch.bfloat16] if kind == "bf16" else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out.float(), ref.slot_gmm_ref(x, w, lut, scale, mn).float(), **tol)


def test_wrapper_refuses_a_bad_launch_loudly(card):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros((1, 4, 2, 272), device=card)               # head_dim above the limit (256)
    with pytest.raises(ValueError, match="at most 256"):
        fa.flash_attention(q, q, q)


def test_engine_on_card_matches_cpu(card):
    """Reduced f32 qwen36 on the card emits the CPU engine's tokens, through
    every kernel, with misses and replays exercised."""
    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import RotaryEngine
    from repro_torch.models.transformer import Runtime, init_params

    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
    # 2 x 40 prompt tokens x top-2 picks: sorted by slot (K1's ragged entry,
    # counted under the tiled body)
    prompt = np.random.default_rng(0).integers(0, 200, (2, 40)).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, 0, "cpu")
        eng = RotaryEngine(cfg, params, ResidencyConfig(mode="rotary", num_slots=3,
                                                        prefetch_margin=1),
                           rt=Runtime(cache_len=64), batch=2, device=dev)
        ops.reset_launch_counts()
        out[dev] = (eng.generate(prompt, 8), eng.stats.replayed_steps, ops.launch_counts())
    np.testing.assert_array_equal(out["cpu"][0], out["cuda"][0])
    assert out["cuda"][1] > 0
    # the legacy prefill walk and decode: every bf16/f32 kernel but K4's
    # chunk entry (its engine test is test_chunk_graph_equals_eager_chunk)
    bf16_kernels = {n: c for n, c in out["cuda"][2].items()
                    if "_int" not in n and not n.endswith("_chunk")}
    assert all(n > 0 for n in bf16_kernels.values()), out["cuda"][2]
    assert all(n == 0 for n in out["cpu"][2].values())


@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_quantized_engine_on_card_matches_cpu(card, quantization):
    """Reduced f32 qwen36 with int8/int4 slots: the card's tokens equal the
    CPU engine's, through both bodies of the format's K1."""
    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import RotaryEngine
    from repro_torch.models.transformer import Runtime, init_params

    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
    prompt = np.random.default_rng(0).integers(0, 200, (2, 40)).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = RotaryEngine(cfg, init_params(cfg, 0, "cpu"),
                           ResidencyConfig(mode="rotary", num_slots=3, prefetch_margin=1,
                                           quantization=quantization, quant_group_size=16),
                           rt=Runtime(cache_len=64), batch=2, device=dev)
        ops.reset_launch_counts()
        out[dev] = (eng.generate(prompt, 8), ops.launch_counts())
    np.testing.assert_array_equal(out["cpu"][0], out["cuda"][0])
    counts = out["cuda"][1]
    assert counts[f"slot_gmm_{quantization}"] > 0 and counts[f"slot_gmm_{quantization}_tiled"] > 0
    assert counts["slot_gmm"] == counts["slot_gmm_tiled"] == 0


def _decode_inputs(b, s, h, hkv, dh, dtype, device, seed=0):
    return (_randn((b, h, dh), dtype, seed, device), _randn((b, s, hkv, dh), dtype, seed + 1, device),
            _randn((b, s, hkv, dh), dtype, seed + 2, device))


@pytest.mark.parametrize("soft_cap", [None, 30.0])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 576, 1024])
def test_decode_attention_at_the_main_path_shape(card, length, soft_cap):
    """K2 at the decode shape (32 heads on 4 KV heads, dh 128, S 1024, bf16)
    at lengths on and beside the 64-position spans: one launch, the plain
    version's values at the bf16 tolerance."""
    from repro_torch.kernels import decode_attention as dec

    q, k, v = _decode_inputs(1, 1024, 32, 4, 128, torch.bfloat16, card)
    lengths = torch.tensor([length], dtype=torch.int32, device=card)
    ops.reset_launch_counts()
    out = dec.decode_attention(q, k, v, lengths, soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == 1
    exp = ref.decode_attention_ref(q, k, v, lengths, soft_cap=soft_cap)
    torch.testing.assert_close(out.float(), exp.float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("g", [1, 8, 16])
def test_decode_attention_groups_head_dims_and_types(card, g, dh, dtype):
    """K2 at g = 1 (MHA: one n8 fragment padded with zero heads), 8 (one
    fragment) and 16 (two), dh 64 and 128, bf16 (tensor cores) and f32
    (CUDA cores), two rows of different lengths."""
    from repro_torch.kernels import decode_attention as dec

    hkv = 2
    q, k, v = _decode_inputs(2, 300, g * hkv, hkv, dh, dtype, card)
    lengths = torch.tensor([300, 77], dtype=torch.int32, device=card)
    for cap in (None, 20.0):
        out = dec.decode_attention(q, k, v, lengths, soft_cap=cap)
        torch.cuda.synchronize()
        exp = ref.decode_attention_ref(q, k, v, lengths, soft_cap=cap)
        torch.testing.assert_close(out.float(), exp.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [96, 128, 160])
def test_decode_attention_partial_entry_matches_plain(card, dtype, dh):
    """K2's partial entry (tensor cores for bf16 at every width, CUDA cores
    for f32) at local lengths 0 / 1 / 130 / 256 of a 256-position slice:
    the context and lse against the plain version, an empty slice lse -inf
    and context 0, and two slices merged against the contiguous entry over
    both."""
    from repro_torch.distributed.parallel import merge_partials
    from repro_torch.kernels import decode_attention as dec

    assert dec.decode_plan(256, dh, 4, dtype).tensor_cores == (dtype == torch.bfloat16)
    q, k, v = _decode_inputs(4, 256, 8, 2, dh, dtype, card)
    _, k2, v2 = _decode_inputs(4, 256, 8, 2, dh, dtype, card, seed=3)
    lengths = torch.tensor([0, 1, 130, 256], dtype=torch.int32, device=card)
    for cap in (None, 20.0):
        out = dec.decode_attention_partial(q, k, v, lengths, soft_cap=cap)
        torch.cuda.synchronize()
        exp = ref.decode_attention_partial_ref(q, k, v, lengths, soft_cap=cap)
        assert torch.isinf(out[0, :, -1]).all() and not out[0, :, :-1].any()
        assert not torch.isnan(out).any()
        torch.testing.assert_close(out[1:], exp[1:], **TOL[dtype])
    whole = torch.tensor([1, 256, 300, 512], dtype=torch.int32, device=card)
    parts = torch.stack([dec.decode_attention_partial(q, kk, vv, torch.clamp(
        whole - r * 256, 0, 256).to(torch.int32)) for r, (kk, vv) in enumerate(((k, v), (k2, v2)))])
    exp = dec.decode_attention(q, torch.cat([k, k2], 1), torch.cat([v, v2], 1), whole)
    torch.testing.assert_close(merge_partials(parts, dtype).float(), exp.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128, 160, 256])
def test_flash_attention_chunk_partial_entry_matches_plain(card, dtype, dh):
    """K4's partial chunk entry (bf16: the chunk entry's tensor-core body
    with a key offset and the partial epilogue; f32: CUDA cores): a chunk of
    72 queries at positions 40-111 against the three 64-position slices of
    a 192-position cache, at offsets before the chunk (0), straddling it
    (64: invisible to its first 24 queries) and past it (128: invisible to
    all), each lse -inf, context 0 and no NaN where nothing is visible,
    with and without a soft cap, against the plain version; the three
    slices merged against the chunk entry over the whole cache; one launch
    counted per call under the chunk kernel."""
    from repro_torch.distributed.parallel import merge_partials
    from repro_torch.kernels import flash_attention as fa

    c, cur, n, h, hkv = 72, 40, 64, 8, 2
    q = _randn((2, c, h, dh), dtype, 0, card)
    k = _randn((2, 3 * n, hkv, dh), dtype, 1, card)
    v = _randn((2, 3 * n, hkv, dh), dtype, 2, card)
    cl = torch.tensor(cur, device=card)
    for cap in (None, 20.0):
        parts, empties = [], []
        for r in range(3):
            ks, vs = k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n]
            ops.reset_launch_counts()
            out = fa.flash_attention_chunk_partial(q, ks, vs, cl, r * n, soft_cap=cap)
            torch.cuda.synchronize()
            assert ops.launch_counts()["flash_attention_chunk"] == 1
            exp = ref.flash_attention_chunk_partial_ref(q, ks, vs, cur, r * n, soft_cap=cap)
            empty = torch.isinf(exp[..., -1])
            assert torch.equal(torch.isinf(out[..., -1]), empty) and not out[empty].nan_to_num(
                neginf=0.0).any() and not torch.isnan(out).any()
            torch.testing.assert_close(out[~empty], exp[~empty], **TOL[dtype])
            parts.append(out)
            empties.append(empty)
        assert not empties[0].any() and empties[2].all()
        assert empties[1][:, :n - cur].all() and not empties[1][:, n - cur:].any()
        whole = ops.flash_attention_chunk(q, k, v, cl, soft_cap=cap)
        torch.testing.assert_close(merge_partials(torch.stack(parts), dtype).float(),
                                   whole.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [128, 160])
def test_decode_attention_is_bitwise_stable_and_batch_invariant(card, dtype, dh):
    """The plan reads S, dh, g and the type only and the merge runs in span
    order: two launches give the same bits, and row b of a B = 3 launch with
    lengths (1, 300, 1024) equals that row launched alone (dh 160: the
    tensor-core body with dh m-tiles that 4 warps do not divide)."""
    from repro_torch.kernels import decode_attention as dec

    q, k, v = _decode_inputs(3, 1024, 32, 4, dh, dtype, card)
    lengths = torch.tensor([1, 300, 1024], dtype=torch.int32, device=card)
    first = dec.decode_attention(q, k, v, lengths)
    again = dec.decode_attention(q, k, v, lengths)
    alone = [dec.decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], lengths[i:i + 1])
             for i in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for i in range(3):
        assert torch.equal(first[i:i + 1], alone[i])


def _tiled_store(kind, d, f, device, group=64):
    if kind == "bf16":
        w = _randn((7, d, f), torch.bfloat16, 1, device, scale=d ** -0.5)
        w[6] = 0
        return w, None, None
    return _quant_store(kind, 7, d, f, group, device, 1)


@pytest.mark.parametrize("c", [5, 33, 64, 65, 200])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_slot_gmm_tiled_tensor_core_body(card, kind, c):
    """K1's tiled body on tensor cores at C on and beside the 64-row tiles,
    one LUT entry on the MISS slot (exact zeros): bf16 out at the bf16
    tolerance, int8/int4 f32 out at 1e-4 + 1e-4."""
    from repro_torch.kernels import moe_gmm as gmm

    d, f = 768, 384
    x = _randn((4, c, d), torch.bfloat16, 0, card)
    w, scale, mn = _tiled_store(kind, d, f, card)
    lut = torch.tensor([3, 6, 0, 5], dtype=torch.int32, device=card)
    assert gmm.tiled_plan(d, f, torch.bfloat16, w.dtype, 64 if kind == "int4" else 0).tensor_cores
    ops.reset_launch_counts()
    out = ops.slot_gmm(x, w, lut, scale, mn)
    torch.cuda.synchronize()
    assert ops.launch_counts()["slot_gmm" + ("" if kind == "bf16" else f"_{kind}") + "_tiled"] == 1
    tol = TOL[torch.bfloat16] if kind == "bf16" else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out.float(), ref.slot_gmm_ref(x, w, lut, scale, mn).float(), **tol)
    assert not out[1].float().abs().sum()


@pytest.mark.parametrize("group", [32, 64, 128])
def test_slot_gmm_tiled_int4_groups(card, group):
    """int4 groups shorter than the D step (32), equal to it (64) and longer
    (128, folded in every second step), against the plain version at the
    f32 tolerance."""
    d, f = 1024, 256
    x = _randn((3, 70, d), torch.bfloat16, 0, card)
    w, scale, mn = _tiled_store("int4", d, f, card, group)
    lut = torch.tensor([2, 6, 4], dtype=torch.int32, device=card)
    out = ops.slot_gmm(x, w, lut, scale, mn)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.slot_gmm_ref(x, w, lut, scale, mn), atol=1e-4, rtol=1e-4)
    assert not out[1].abs().sum()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_slot_gmm_tiled_is_bitwise_stable_and_independent_of_c(card, kind):
    """The sum over D runs in one order whatever C: row c of the output has
    the same bits at C = 5, 33, 64, 65 and 200, and two launches agree."""
    d, f = 768, 384
    x = _randn((3, 200, d), torch.bfloat16, 0, card)
    w, scale, mn = _tiled_store(kind, d, f, card)
    lut = torch.tensor([0, 4, 6], dtype=torch.int32, device=card)
    full = ops.slot_gmm(x, w, lut, scale, mn)
    again = ops.slot_gmm(x, w, lut, scale, mn)
    parts = {c: ops.slot_gmm(x[:, :c].contiguous(), w, lut, scale, mn) for c in (5, 33, 64, 65)}
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    for c, out in parts.items():
        assert torch.equal(out, full[:, :c]), c


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 18), (torch.bfloat16, 36)])
def test_decode_attention_element_loads(card, dtype, dh):
    """Rows that are not whole 16-byte copies (72 bytes) take the CUDA-core
    body with element loads into the same ring, against the plain version."""
    from repro_torch.kernels import decode_attention as dec

    q, k, v = _decode_inputs(2, 200, 8, 2, dh, dtype, card)
    lengths = torch.tensor([200, 9], dtype=torch.int32, device=card)
    out = dec.decode_attention(q, k, v, lengths, soft_cap=20.0)
    torch.cuda.synchronize()
    exp = ref.decode_attention_ref(q, k, v, lengths, soft_cap=20.0)
    torch.testing.assert_close(out.float(), exp.float(), **TOL[dtype])


# ---------------------------------------------------------------------------
# the decode step as one CUDA graph; the miss relaunch and prefetch
# ---------------------------------------------------------------------------
def _reduced_engine(device, slots=3, prefetch=False, quantization=None, dtype="float32",
                    cache_len=64, mode=None, **switches):
    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import RotaryEngine
    from repro_torch.core.transfer import CostModel
    from repro_torch.models.transformer import Runtime, init_params

    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype=dtype)
    mode = mode or ("full" if slots == 0 else "rotary")
    res = ResidencyConfig(mode=mode, num_slots=slots, prefetch_margin=1,
                          quantization=quantization, quant_group_size=16)
    # one link figure for every engine, so the modeled clocks compare
    cost = CostModel(host_link_gbs=20.0, link_latency_us=10.0)
    return cfg, RotaryEngine(cfg, init_params(cfg, 0, "cpu"), res, rt=Runtime(cache_len=cache_len),
                             batch=2, device=device, prefetch=prefetch, cost=cost, **switches)


def _decode_steps(eng, prompt, steps):
    """Greedy tokens and the logits of every decode step, one call per token."""
    logits = [eng.prefill(prompt)]
    toks = []
    for _ in range(steps):
        toks.append(eng.decode(logits[-1], 1)[:, 0])
        logits.append(eng.last_logits)
    return np.stack(toks, 1), np.stack(logits[1:], 1)


# host wall times: the only stats that may differ
_MEASURED = ("wall_s", "overlap_ms", "host_dequant_s")


@pytest.mark.parametrize("prefetch,dtype", [(False, "float32"), (True, "float32"),
                                            (True, "bfloat16")])
def test_graph_step_equals_eager_step(card, prefetch, dtype):
    """The captured step replayed against the same step run eagerly on the
    card, over steps that miss (replay) and relaunch: bitwise the same
    logits, the same tokens and the same EngineStats."""
    prompt = np.random.default_rng(0).integers(0, 200, (2, 12)).astype(np.int32)
    out = {}
    for capture in (True, False):     # at 5 slots a step's 4 picks fit: relaunches are feasible
        _, eng = _reduced_engine(card, slots=5 if prefetch else 3, prefetch=prefetch, dtype=dtype)
        eng._capture = capture
        toks, logits = _decode_steps(eng, prompt, 10)
        stats = {k: v for k, v in dataclasses.asdict(eng.stats).items() if k not in _MEASURED}
        out[capture] = (toks, logits, stats, eng.graph_captures, eng.graph_replays)
    np.testing.assert_array_equal(out[True][0], out[False][0])
    assert out[True][1].tobytes() == out[False][1].tobytes()
    assert out[True][2] == out[False][2]
    assert out[True][3:] == (1, 9 + out[True][2]["relaunched_steps"])
    assert out[False][3:] == (0, 0)
    s = out[True][2]
    assert (s["relaunched_steps"] > 0) if prefetch else (s["replayed_steps"] > 0)


def test_graph_launch_counts_are_replays_times_capture(card):
    """Full residency (no miss): after N decode steps (the capture's warm-up
    and N - 1 replays) every kernel's and symbol's count is N times one
    step's launches, which the capture recorded."""
    _, eng = _reduced_engine(card, slots=0)
    logits = eng.prefill(np.arange(10, dtype=np.int32).reshape(2, 5))
    ops.reset_launch_counts()
    eng.decode(logits, 7)
    torch.cuda.synchronize()
    per_step = eng._graphs[1].launches
    assert per_step["topk_gate"] == {"router_topk_f32": eng.num_moe_layers}   # one a layer
    assert set(per_step) == {"slot_gmm", "decode_attention", "topk_gate"}
    assert eng.graph_captures == 1 and eng.graph_replays == 6
    assert ops.symbol_launch_counts() == {
        name: {sym: 7 * n for sym, n in per_step.get(name, {}).items()} for name in ops.KERNELS}


def test_graph_replay_after_a_moved_plane_raises(card):
    _, eng = _reduced_engine(card, slots=3)
    logits = eng.prefill(np.arange(10, dtype=np.int32).reshape(2, 5))
    eng.decode(logits, 2)
    store = eng.manager.stores[1]
    store.buffers["w_up"] = store.buffers["w_up"].clone()
    with pytest.raises(RuntimeError, match="moved"):
        eng.decode(eng.last_logits, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_on_a_ring_cache_over_several_laps(card, dtype):
    """K2 scores a ring cache (slot = position % cap) in slot order with the
    row's length clamped to cap, against the reference's masked ring decode
    (``_ring_decode_plain``), at every step of four laps."""
    from repro_torch.config import AttentionConfig
    from repro_torch.models.attention import _ring_decode_plain

    b, h, hkv, dh, cap = 2, 8, 2, 64, 16
    acfg = AttentionConfig(num_heads=h, num_kv_heads=hkv, head_dim=dh, window=cap,
                           logit_soft_cap=30.0)
    ck = torch.zeros((b, cap, hkv, dh), dtype=dtype, device=card)
    cv = torch.zeros_like(ck)
    for cur in range(4 * cap):
        ck[:, cur % cap] = _randn((b, hkv, dh), dtype, 2 * cur, card)
        cv[:, cur % cap] = _randn((b, hkv, dh), dtype, 2 * cur + 1, card)
        q = _randn((b, 1, h, dh), dtype, 1000 + cur, card)
        lengths = torch.full((b,), min(cur + 1, cap), dtype=torch.int32, device=card)
        ops.reset_launch_counts()
        got = ops.decode_attention(q, ck, cv, lengths=lengths, soft_cap=30.0)
        assert ops.launch_counts()["decode_attention"] == 1
        want = _ring_decode_plain(acfg, q, ck, cv, cur)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_prefetch_flips_land_after_the_copy_stream(card):
    """The manager on the card under prefetch, fed a demand bump drifting
    round the experts (so forecasts land and layers flip): after every
    boundary the compute stream alone (not the device) is synchronized, and
    every layer's live generation then holds, slot by slot, the warehouse
    rows its LUT names (each flip's corrections and catch-up copies on the
    copy stream landed before the flip took effect); once the copy stream
    drains, the shadow generation holds what its bookkeeping says."""
    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.predictor import DemandPredictor
    from repro_torch.core.residency import RotaryResidencyManager

    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
    rng = np.random.default_rng(2)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    host = [{"w_gate": torch.from_numpy(rng.standard_normal((e, d, f)).astype(np.float32)),
             "w_up": torch.from_numpy(rng.standard_normal((e, d, f)).astype(np.float32)),
             "w_down": torch.from_numpy(rng.standard_normal((e, f, d)).astype(np.float32))}
            for _ in range(2)]
    m = RotaryResidencyManager(cfg, ResidencyConfig(mode="rotary", num_slots=4,
                                                    prefetch_margin=1),
                               host, batch=1, cache_len=32, device=card)
    m.enable_prefetch()
    pred = DemandPredictor([rng.standard_normal((d, e)).astype(np.float32) for _ in range(2)])
    for l in range(2):
        m.prepare_layer(l, pred.smoothed[l])
    flips, lives = 0, [s.live for s in m.stores]
    for step in range(16):
        ids = rng.integers(0, e, (2, 1, 2))
        bump = np.exp(-0.5 * ((np.arange(e) - 0.5 * step) % e) ** 2)
        m.begin_prefetch(pred)
        m.rotate_from_telemetry(pred, ids, rng.random((2, 1, 2)).astype(np.float32),
                                np.zeros(ids.shape, bool), np.stack([bump / bump.sum()] * 2))
        torch.cuda.current_stream().synchronize()
        for li, store in enumerate(m.stores):
            flips += store.live != lives[li]
            lives[li] = store.live
            live = store.generation_view()
            for s, ex in enumerate(m.policies[li].lut.s2e):
                if ex >= 0:
                    for name in live:
                        assert torch.equal(live[name][s].cpu(), host[li][name][ex]), (step, li)
        m._copy_stream.synchronize()
        for li, store in enumerate(m.stores):
            shadow = store.generation_view(1 - store.live)
            for s, ex in m._shadow_contents[li].items():
                assert torch.equal(shadow["w_up"][s].cpu(), host[li]["w_up"][ex])
    assert flips > 0 and m.stats.prefetch_launched > 0 and m.copy_stream_ms() > 0


@pytest.mark.parametrize("quantization", [None, "int4"])
def test_prefetch_engine_on_card_matches_cpu(card, quantization):
    """Reduced f32 qwen36 with prefetch=True: the card (graph replays, the
    relaunch, shadow uploads on the copy stream) emits the CPU engine's
    tokens, misses, relaunches and replays."""
    prompt = np.random.default_rng(0).integers(0, 200, (2, 40)).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):        # 5 slots cover a step's 4 picks: relaunches are feasible
        _, eng = _reduced_engine(dev, slots=5, prefetch=True, quantization=quantization)
        out[dev] = (eng.generate(prompt, 10), eng.stats)
    np.testing.assert_array_equal(out["cpu"][0], out["cuda"][0])
    for key in ("misses", "relaunched_steps", "replayed_steps", "prefetch_launched",
                "prefetch_hits", "bytes_uploaded"):
        assert getattr(out["cpu"][1], key) == getattr(out["cuda"][1], key), key
    assert out["cuda"][1].relaunched_steps > 0


# ---------------------------------------------------------------------------
# speculative windows as CUDA graphs; the per-layer walks on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec_k,prefetch,slots,dtype", [
    (4, False, 3, "float32"), (2, True, 6, "float32"), (2, True, 6, "bfloat16"),
    (4, False, 3, "bfloat16"),
])
def test_graph_windows_equal_eager_windows(card, spec_k, prefetch, slots, dtype):
    """Each window size captured once and replayed, against the same windows
    run eagerly on the card, over windows that miss and roll back and replay
    (synchronous) or relaunch (prefetch): bitwise the same logits at every
    committed position, the same tokens and the same EngineStats."""
    prompt = np.random.default_rng(0).integers(0, 200, (2, 12)).astype(np.int32)
    out = {}
    for capture in (True, False):
        _, eng = _reduced_engine(card, slots=slots, prefetch=prefetch, dtype=dtype,
                                 spec_k=spec_k)
        eng._capture = capture
        logits = eng.prefill(prompt)
        eng.logit_log = [logits]
        toks = eng.decode(logits, 15)
        stats = {k: v for k, v in dataclasses.asdict(eng.stats).items() if k not in _MEASURED}
        out[capture] = (toks, eng.logged_logits(), stats, eng.graph_captures, eng.graph_replays,
                        eng.launches, sorted(eng._graphs))
    np.testing.assert_array_equal(out[True][0], out[False][0])
    assert out[True][1].tobytes() == out[False][1].tobytes()
    assert out[True][2] == out[False][2]
    captures, replays, launches, sizes = out[True][3:]
    assert captures == len(sizes) and captures + replays == launches == out[False][5]
    assert spec_k in sizes and out[False][3:5] == (0, 0)
    s = out[True][2]
    assert s["spec_windows"] > 0
    if prefetch:
        assert s["relaunched_steps"] > 0
    else:
        assert s["replayed_steps"] > 0 and s["accepted_tokens"] < s["drafted_tokens"]


def test_window_replay_after_a_moved_cache_raises(card):
    _, eng = _reduced_engine(card, slots=0, spec_k=2)
    logits = eng.prefill(np.arange(10, dtype=np.int32).reshape(2, 5))
    eng.decode(logits, 4)
    eng.state[0]["k"] = eng.state[0]["k"].clone()
    with pytest.raises(RuntimeError, match="moved"):
        eng.decode(eng.last_logits, 2)


def test_lru_lut_rewrite_is_read_by_the_moe_half_that_follows(card):
    """LRU on the card: a miss is uploaded and the device LUT rewritten in
    place on the compute stream, then the MoE half runs. At every layer of
    every step the MoE half's own miss mask (read through the device LUT)
    equals the host's mask after the loads, so no loaded expert reads the
    miss row; the tokens equal the CPU engine's."""
    out = {}
    prompt = np.random.default_rng(0).integers(0, 200, (2, 12)).astype(np.int32)
    for dev in ("cpu", "cuda"):
        _, eng = _reduced_engine(card if dev == "cuda" else "cpu", slots=3, mode="lru")
        host, device = [], []
        resolve, moe_layer = eng.manager.resolve, eng._moe_layer

        def spy_resolve(li, ids, clock=None):
            lut, miss = resolve(li, ids, clock)
            host.append(miss.copy())
            return lut, miss

        def spy_moe(li, *a):
            x, miss = moe_layer(li, *a)
            device.append(miss.cpu().numpy())
            return x, miss

        eng.manager.resolve, eng._moe_layer = spy_resolve, spy_moe
        logits = eng.prefill(prompt)
        loads0 = sum(l.loads for l in eng.stats.layers.values())
        toks = eng.decode(logits, 8)
        assert len(host) == len(device)
        for h, d in zip(host, device):
            np.testing.assert_array_equal(h, d)
        assert sum(l.loads for l in eng.stats.layers.values()) > loads0
        out[dev] = toks
    np.testing.assert_array_equal(out["cpu"], out["cuda"])


def test_hot_walk_waits_on_the_routing_not_on_the_moe_half(card):
    """The hot walk's host waits on the event recorded after the routing
    copies, not on the MoE half: with each MoE half held up on the card by a
    20 ms sleep, the host reaches every layer's pre-gating while that MoE
    half is still running; the tokens equal the CPU walk's."""
    prompt = np.random.default_rng(0).integers(0, 200, (2, 12)).astype(np.int32)
    _, cpu = _reduced_engine("cpu", slots=3, fused_decode=False)
    want = cpu.generate(prompt, 4)
    _, eng = _reduced_engine(card, slots=3, fused_decode=False)
    logits = eng.prefill(prompt)
    running = []
    moe_layer, predict = eng._moe_layer, eng.predictor.predict
    pending = {}

    def slow_moe(li, *a):
        torch.cuda._sleep(int(20e-3 * 1.5e9))        # ~20 ms at the card's clock
        out = moe_layer(li, *a)
        pending["done"] = torch.cuda.Event()
        pending["done"].record()
        return out

    def spy_predict(layer, h):
        running.append(not pending["done"].query())
        return predict(layer, h)

    eng._moe_layer, eng.predictor.predict = slow_moe, spy_predict
    toks = [eng.decode(logits, 1)]
    for _ in range(3):
        toks.append(eng.decode(eng.last_logits, 1))
    np.testing.assert_array_equal(np.concatenate(toks, axis=1), want)
    assert len(running) >= 4 * eng.num_moe_layers and all(running)


# ---------------------------------------------------------------------------
# chunked prefill: K4's chunk-append entry, K1's ragged entry, chunk graphs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [1, 5, 64, 130])
@pytest.mark.parametrize("cur", [0, 77, 384])
@pytest.mark.parametrize("window,soft_cap", [(None, None), (100, None), (None, 30.0)])
def test_flash_attention_chunk_kernel_matches_plain(card, dtype, c, cur, window, soft_cap):
    """C queries at positions cur .. cur + C - 1 against a 512-slot cache
    (slots past cur + C hold stale values the kernel must not read), the
    offset read from an int64 on the device."""
    b, h, hkv, dh, cap = 2, 8, 2, 128, 512
    q = _randn((b, c, h, dh), dtype, 0, card)
    k = _randn((b, cap, hkv, dh), dtype, 1, card)
    v = _randn((b, cap, hkv, dh), dtype, 2, card)
    cl = torch.tensor(cur, device=card)
    ops.reset_launch_counts()
    out = ops.flash_attention_chunk(q, k, v, cl, window=window, soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_chunk"] == 1
    want = ref.flash_attention_chunk_ref(q, k, v, cur, window=window, soft_cap=soft_cap)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    k2 = k.clone()
    k2[:, cur + c:] = float("nan")                       # never read: past the live keys
    out2 = ops.flash_attention_chunk(q, k2, v, cl, window=window, soft_cap=soft_cap)
    assert torch.equal(out2, out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_chunk_query_is_independent_of_chunk_length(card, dtype):
    """A query's output does not depend on how many queries share its chunk
    or where in it it sits: rows of one 200-query chunk equal, bit for bit,
    the same positions scored in chunks of 1, 3 and 64 at other starts."""
    b, h, hkv, dh, cap = 1, 32, 4, 128, 1024
    q = _randn((b, 200, h, dh), dtype, 3, card)
    k = _randn((b, cap, hkv, dh), dtype, 4, card)
    v = _randn((b, cap, hkv, dh), dtype, 5, card)
    start = 50
    full = ops.flash_attention_chunk(q, k, v, torch.tensor(start, device=card))
    for lo, n in ((0, 1), (7, 1), (63, 1), (64, 3), (100, 64), (199, 1), (136, 64)):
        part = ops.flash_attention_chunk(q[:, lo:lo + n].contiguous(), k, v,
                                         torch.tensor(start + lo, device=card))
        assert torch.equal(part, full[:, lo:lo + n]), (lo, n)


def test_flash_attention_chunk_refuses_what_it_does_not_take(card):
    from repro_torch.kernels import flash_attention as fa

    q = _randn((1, 4, 8, 64), torch.bfloat16, 0, card)
    k = _randn((1, 16, 2, 64), torch.bfloat16, 1, card)
    with pytest.raises(ValueError, match="int64"):
        fa.flash_attention_chunk(q, k, k, torch.tensor(3, dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="capacity"):
        fa.flash_attention_chunk(_randn((1, 17, 8, 64), torch.bfloat16, 0, card), k, k,
                                 torch.tensor(0, device=card))


def _ragged_case(n, s1, seed, device, empty=(1, 4)):
    """Slot ids of ``n`` picks over ``s1`` store rows (some slots empty, the
    last the MISS row), sorted, and their offsets [s1 + 1] int32."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s1, n)
    ids[np.isin(ids, empty)] = s1 - 1
    ids.sort()
    offsets = np.searchsorted(ids, np.arange(s1 + 1)).astype(np.int32)
    return torch.from_numpy(offsets).to(device)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "f32"])
@pytest.mark.parametrize("n,d,f", [(1024, 2048, 768), (300, 768, 2048), (70, 130, 72)])
def test_slot_gmm_ragged_kernel_matches_plain(card, kind, n, d, f):
    """K1's ragged entry (the tensor-core body for bf16 x, the CUDA-core body
    for f32 x and for rows that are not whole 16-byte copies) against its
    plain version: MISS rows are zeros; without a MISS slot the last row
    computes."""
    from repro_torch.kernels import moe_gmm as gmm

    s1 = 7
    if kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        w = _randn((s1, d, f), dt, 1, card, scale=d ** -0.5)
        scale = mn = None
    else:
        if d % 2:
            pytest.skip("int4 packs rows in pairs")
        w, scale, mn = _quant_store(kind, s1, d, f, 64 if d % 64 == 0 else 2, card, 1)
        dt = torch.bfloat16
    x = _randn((n, d), dt, 0, card)
    offsets = _ragged_case(n, s1, n, card)
    for miss in (s1 - 1, None):
        ops.reset_launch_counts()
        out = ops.slot_gmm_ragged(x, w, offsets, scale, mn, miss_slot=miss)
        torch.cuda.synchronize()
        stem = "slot_gmm" + ("" if kind in ("bf16", "f32") else f"_{kind}")
        assert ops.symbol_launch_counts()[stem + "_tiled"] == {
            f"{stem}_ragged_{'f32' if kind == 'f32' else 'bf16'}": 1}
        want = ref.slot_gmm_ragged_ref(x, w, offsets, scale, mn, miss_slot=miss)
        tol = TOL[torch.bfloat16] if kind == "bf16" else dict(atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(out.float(), want.float(), **tol)
        if miss is not None:
            assert not out[int(offsets[s1 - 1]):].float().abs().sum()
    assert gmm.tiled_plan(d, f, dt, w.dtype, 64).tensor_cores == (kind != "f32" and d % 8 == 0)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_slot_gmm_ragged_rows_equal_the_grouped_body_bitwise(card, kind):
    """A row gives the same bits through the ragged entry as through the
    grouped tiled body: one slot's rows grouped [1, C, D] and the same rows
    among other slots' in a ragged batch."""
    d, f, s1 = 768, 384, 7
    w, scale, mn = _tiled_store(kind, d, f, card)
    x = _randn((200, d), torch.bfloat16, 0, card)
    offsets = torch.tensor([0, 30, 30, 100, 133, 170, 200, 200], dtype=torch.int32, device=card)
    ragged = ops.slot_gmm_ragged(x, w, offsets, scale, mn, miss_slot=s1 - 1)
    for s in range(s1 - 1):
        a, b = int(offsets[s]), int(offsets[s + 1])
        if a == b:
            continue
        lut = torch.tensor([s], dtype=torch.int32, device=card)
        grouped = ops.slot_gmm(x[None, a:b].contiguous(), w, lut, scale, mn)[0]
        if b - a > 4:                                    # the tiled body (C <= 4: the GEMV)
            assert torch.equal(ragged[a:b], grouped), s


def test_ragged_moe_half_captures_in_a_graph(card):
    """The chunk's MoE half (argsort, offsets, three ragged launches, the
    scatter back) captured in a CUDA graph and replayed equals it eager, and
    equals bit for bit each slot's rows run as one group [1, C, D] through
    the tiled body's grouped entry (zero rows pad C past the GEMV's)."""
    from repro_torch.models import moe

    d, f, s1, e, t, k = 512, 256, 13, 32, 96, 4
    src = {n: _randn(shape, torch.bfloat16, i, card, scale=shape[1] ** -0.5)
           for i, (n, shape) in enumerate((("w_gate", (s1, d, f)), ("w_up", (s1, d, f)),
                                           ("w_down", (s1, f, d))))}
    for w in src.values():
        w[s1 - 1] = 0
    lut = torch.from_numpy(np.random.default_rng(0).permutation(e)).to(card, torch.int32)
    lut = torch.where(lut < s1 - 1, lut, torch.full_like(lut, s1 - 1))
    h2 = _randn((t, d), torch.bfloat16, 7, card)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, e, (t, k))).to(card, torch.int32)
    wts = torch.rand((t, k), device=card)
    eager, miss = moe.moe_apply_routed({}, h2, ids, wts, slot_buffer=src, lut=lut)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_apply_routed({}, h2, ids, wts, slot_buffer=src, lut=lut)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = moe.moe_apply_routed({}, h2, ids, wts, slot_buffer=src, lut=lut)
    graph.replay()
    torch.cuda.synchronize()
    assert miss.any() and torch.equal(out, eager)
    gidx = lut[ids.long()].reshape(-1)
    outs = torch.zeros((t * k, d), dtype=torch.bfloat16, device=card)
    for s in range(s1 - 1):                          # every slot but MISS
        rows = torch.nonzero(gidx == s).flatten()
        if rows.numel():
            xs = torch.zeros((1, max(rows.numel(), 8), d), dtype=h2.dtype, device=card)
            xs[0, :rows.numel()] = h2[rows // k]
            slot = torch.tensor([s], dtype=torch.int32, device=card)
            outs[rows] = moe.expert_ffn(src, xs, slot)[0, :rows.numel()]
    w_eff = wts * (gidx.reshape(t, k) < s1 - 1).float()
    grouped = (outs.float().reshape(t, k, d) * w_eff[..., None]).sum(dim=1).to(h2.dtype)
    assert torch.equal(grouped, eager)


def _chunked_prefill(eng, prompt):
    logits = eng.prefill(prompt)
    return (logits, [(c["k"].cpu(), c["v"].cpu()) for c in eng.state],
            {k: v for k, v in dataclasses.asdict(eng.stats).items() if k not in _MEASURED})


@pytest.mark.parametrize("slots,prefetch,dtype", [
    (0, False, "bfloat16"), (3, False, "float32"), (3, False, "bfloat16"),
    (5, True, "bfloat16")])
def test_chunk_graph_equals_eager_chunk(card, slots, prefetch, dtype):
    """Chunked prefill with each chunk length one captured graph (plan [8, 8,
    4, 1] over two requests) against the same chunks run eagerly on the
    card: bitwise the same logits, caches and EngineStats; the chunked walk
    gives the same logits and caches too. Three chunk lengths, three
    captures; every chunk attends through K4's chunk entry."""
    prompts = [np.random.default_rng(i).integers(0, 200, (2, 21)).astype(np.int32)
               for i in range(2)]
    out = {}
    for variant in ("graph", "eager", "walk"):
        switches = dict(fused_decode=False) if variant == "walk" else {}
        _, eng = _reduced_engine(card, slots=slots, prefetch=prefetch and variant != "walk",
                                 dtype=dtype, cache_len=64, prefill_chunk=8, **switches)
        eng._capture = variant == "graph"
        ops.reset_launch_counts()
        runs = [_chunked_prefill(eng, p) for p in prompts]
        torch.cuda.synchronize()
        out[variant] = (runs, eng.graph_captures, eng.graph_replays, ops.launch_counts())
    for (lg, kv, st), (le, kve, ste) in zip(out["graph"][0], out["eager"][0]):
        assert lg.tobytes() == le.tobytes() and st == ste
        assert all(torch.equal(a, b) for pa, pb in zip(kv, kve) for a, b in zip(pa, pb))
    for (lg, kv, _), (lw, kvw, _) in zip(out["graph"][0], out["walk"][0]):
        assert lg.tobytes() == lw.tobytes()
        assert all(torch.equal(a, b) for pa, pb in zip(kv, kvw) for a, b in zip(pa, pb))
    captures, replays, counts = out["graph"][1:]
    assert captures == 3 and replays == 2 * 4 - 3    # (8), (4) and (1, with the head)
    assert counts["flash_attention_chunk"] > 0 and counts["flash_attention"] == 0
    if slots == 3:
        assert out["graph"][0][0][2]["prefill_replays"] > 0


def test_chunk_graph_runs_the_ragged_entry(card):
    """Chunks of 32 tokens at batch 2 (128 picks a layer) take K1's ragged
    entry inside the chunk graph; the graph equals the eager chunk and the
    walk bit for bit."""
    prompt = np.random.default_rng(3).integers(0, 200, (2, 40)).astype(np.int32)
    out = {}
    for variant in ("graph", "eager", "walk"):
        switches = dict(fused_decode=False) if variant == "walk" else {}
        _, eng = _reduced_engine(card, slots=3, dtype="bfloat16", cache_len=64,
                                 prefill_chunk=32, **switches)
        eng._capture = variant == "graph"
        ops.reset_launch_counts()
        out[variant] = (_chunked_prefill(eng, prompt), ops.symbol_launch_counts())
    assert out["graph"][0][0].tobytes() == out["eager"][0][0].tobytes() \
        == out["walk"][0][0].tobytes()
    assert out["graph"][0][2] == out["eager"][0][2]
    for variant in ("graph", "walk"):
        tiled = out[variant][1]["slot_gmm_tiled"]
        assert tiled.get("slot_gmm_ragged_bf16", 0) > 0 and set(tiled) == {"slot_gmm_ragged_bf16"}


@pytest.mark.parametrize("spec_k,slots,prefetch,dtype", [
    (1, 0, False, "bfloat16"), (4, 3, False, "float32"), (4, 3, False, "bfloat16"),
    (2, 6, True, "bfloat16")])
def test_sampled_window_graphs_equal_eager_windows(card, spec_k, slots, prefetch, dtype):
    """Sampled windows (one graph per size and sampler) and the draw between
    them (one graph per sampler) against the same windows and draws run
    eagerly on the card: the same tokens, bitwise the same logits at every
    committed position and the same EngineStats; the spec-K stream equals
    the spec-1 stream."""
    from repro_torch.serving.sampler import SamplerConfig

    prompt = np.random.default_rng(0).integers(0, 200, (2, 12)).astype(np.int32)
    sc = SamplerConfig(temperature=0.8, top_k=50, top_p=0.95, seed=7)
    out = {}
    for capture in (True, False):
        _, eng = _reduced_engine(card, slots=slots, prefetch=prefetch, dtype=dtype,
                                 spec_k=spec_k)
        eng._capture = capture
        logits = eng.prefill(prompt)
        eng.logit_log = [logits]
        toks = eng.decode(logits, 15, sampler=sc)
        stats = {k: v for k, v in dataclasses.asdict(eng.stats).items() if k not in _MEASURED}
        out[capture] = (toks, eng.logged_logits(), stats, eng.graph_captures, sorted(
            map(str, eng._graphs)))
    np.testing.assert_array_equal(out[True][0], out[False][0])
    assert sum(key.startswith("('draw'") for key in out[True][4]) == 1
    assert out[True][1].tobytes() == out[False][1].tobytes()
    assert out[True][2] == out[False][2] and out[True][2]["spec_windows"] > 0
    assert out[True][3] > 0 and out[False][3] == 0
    _, single = _reduced_engine(card, slots=slots, prefetch=prefetch, dtype=dtype)
    np.testing.assert_array_equal(single.decode(single.prefill(prompt), 15, sampler=sc),
                                  out[True][0])


# ---------------------------------------------------------------------------
# K2's paged entry and the serving engine's windows
# ---------------------------------------------------------------------------
def _paged_case(device, dtype, ps, lens, b=None, seed=0, spare=5, dh=128):
    """q [B, 32, dh], planes [P, ps, 4, dh] whose spare pages hold garbage,
    a shuffled page table [B, 1024 // ps] and lengths ``lens``."""
    b = b or len(lens)
    n_pages = 1024 // ps
    planes = b * n_pages + 1 + spare
    gen = torch.Generator(device="cpu").manual_seed(seed)
    kp = (torch.randn((planes, ps, 4, dh), generator=gen) * 3).to(device=device, dtype=dtype)
    vp = torch.randn((planes, ps, 4, dh), generator=gen).to(device=device, dtype=dtype)
    pt = (torch.randperm(planes - 1, generator=gen)[:b * n_pages] + 1).reshape(b, n_pages)
    q = torch.randn((b, 32, dh), generator=gen).to(device=device, dtype=dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, kp, vp, pt.to(device=device, dtype=torch.int32), lengths


def _gathered(planes, pt):
    b, n = pt.shape
    return planes[pt.long()].reshape((b, n * planes.shape[1]) + tuple(planes.shape[2:]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("soft_cap", [None, 30.0])
@pytest.mark.parametrize("dh", [128, 96, 160])
def test_decode_attention_paged_matches_plain_and_contiguous(card, dtype, ps, soft_cap, dh):
    """Lengths on and around page boundaries (and the whole row), pages in
    shuffled order: the paged entry within the tolerance of its plain
    version, and bitwise the contiguous entry on the gathered view; bf16
    on tensor cores at every dh (96 and 160: m-tiles that 4 warps do not
    divide)."""
    from repro_torch.kernels import decode_attention as dec

    assert dec.decode_plan(1024, dh, 8, dtype).tensor_cores == (dtype == torch.bfloat16)
    lens = [1, ps - 1, ps, ps + 1, 2 * ps, 300, 577, 1024]
    q, kp, vp, pt, lengths = _paged_case(card, dtype, ps, lens, dh=dh)
    got = dec.decode_attention_paged(q, kp, vp, pt, lengths, soft_cap=soft_cap)
    want = ref.decode_attention_paged_ref(q, kp, vp, pt, lengths, soft_cap=soft_cap)
    contiguous = dec.decode_attention(q, _gathered(kp, pt), _gathered(vp, pt), lengths,
                                      soft_cap=soft_cap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, contiguous)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_paged_is_bitwise_stable_and_batch_invariant(card, dtype):
    """A row's output does not depend on the other rows, the batch or the
    call: each row alone equals itself among 4, twice over."""
    from repro_torch.kernels import decode_attention as dec

    q, kp, vp, pt, lengths = _paged_case(card, dtype, 16, [37, 300, 576, 1024])
    full = dec.decode_attention_paged(q, kp, vp, pt, lengths)
    assert torch.equal(full, dec.decode_attention_paged(q, kp, vp, pt, lengths))
    for i in range(4):
        alone = dec.decode_attention_paged(q[i:i + 1], kp, vp, pt[i:i + 1], lengths[i:i + 1])
        assert torch.equal(alone, full[i:i + 1]), i


def test_paged_pad_rows_leave_valid_rows_untouched(card):
    """Pad rows (all-zero tables, cur_len 0) write their K/V into the
    scratch page 0, duplicates racing there: the valid rows' outputs are
    bitwise those of the valid rows decoded without pads (K2's paged entry),
    and no page but 0 and the valid rows' written slots changes."""
    from repro_torch.config.base import AttentionConfig
    from repro_torch.models import attention as attn

    acfg = AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=128)
    gen = torch.Generator(device=card).manual_seed(3)
    p = attn.init_attention(gen, 256, acfg, torch.float32, card)
    q, kp, vp, pt, lengths = _paged_case(card, torch.float32, 16, [37, 300], b=2)
    pad_pt = torch.cat([pt, torch.zeros_like(pt)])
    pad_len = torch.cat([lengths, torch.ones_like(lengths)])
    with_pads = ops.decode_attention(torch.cat([q, q])[:, None], kp, vp, lengths=pad_len,
                                     page_table=pad_pt)
    alone = ops.decode_attention(q[:, None], kp, vp, lengths=lengths, page_table=pt)
    torch.cuda.synchronize()
    assert torch.equal(with_pads[:2], alone)
    x = torch.randn((4, 1, 256), generator=gen, device=card)
    cur = torch.tensor([36, 299, 0, 0], device=card)
    planes = {"k": kp.clone(), "v": vp.clone()}
    attn.attention_decode(p, acfg, x, planes, cur, page_table=pad_pt)
    torch.cuda.synchronize()
    changed = (planes["k"] != kp).flatten(2).any(-1)                # [P, ps]
    written = {(0, int(s)) for s in range(16)} | {
        (int(pt[i, int(c) // 16]), int(c) % 16) for i, c in enumerate(cur[:2].tolist())}
    assert {tuple(ix) for ix in changed.nonzero().tolist()} <= written


def _reduced_server(device, slots=6, dtype="float32", prefetch=False, sample=None, trace=None):
    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.serving import SamplerConfig, ServingEngine

    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype=dtype)
    res = ResidencyConfig(mode="rotary", num_slots=slots) if slots else None
    smp = SamplerConfig(temperature=0.8, top_k=20, top_p=0.95, seed=3) if sample else None
    return cfg, ServingEngine(cfg, init_params(cfg, 0, "cpu"), rt=Runtime(cache_len=64),
                              num_slots=3, residency=res, sampler=smp, spec_cap=4,
                              kv_page_size=8, prefetch=prefetch, trace=trace, device=device)


def _serve_all(eng, vocab, n=4, new=10):
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, vocab, int(rng.integers(5, 30))), new, seed=10 + i)
            for i in range(n)]
    eng.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("slots,dtype,prefetch,sample", [
    (6, "float32", False, False), (6, "bfloat16", False, False), (6, "bfloat16", True, False),
    (0, "bfloat16", False, True),
])
def test_serving_window_graphs_equal_eager_windows(card, slots, dtype, prefetch, sample):
    """Each (window size, rows bucket, sampler) captured once and replayed,
    against the same windows run eagerly on the card, over windows that
    miss and roll back (rotary at 6 of 8): the same tokens, bitwise the same
    KV pages, the same EngineStats."""
    out = {}
    for capture in (True, False):
        cfg, eng = _reduced_server(card, slots, dtype, prefetch, sample)
        eng._gs.capture = capture
        toks = _serve_all(eng, cfg.vocab_size)
        stats = {k: v for k, v in dataclasses.asdict(eng.stats).items() if k not in _MEASURED}
        out[capture] = (toks, [{n: c[n].cpu() for n in c} for c in eng.pool_state], stats,
                        eng.graph_captures, eng.graph_replays, eng.stats.misses)
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        for n in ("k", "v"):
            assert torch.equal(a[n][1:], b[n][1:])        # page 0 is the racing scratch page
    assert out[True][2] == out[False][2]
    assert out[True][3] > 0 and out[True][3] + out[True][4] == out[True][2]["windows"]
    assert out[False][3:5] == (0, 0)
    s = out[True][2]
    if slots:
        assert out[True][5] > 0 and s["accepted_tokens"] < s["drafted_tokens"]


def test_serving_warmup_changes_no_output(card):
    """``warmup()`` captures every window size's graph before
    traffic, writing only the scratch page: the same tokens and KV pages as
    an engine that captures on first use, and no capture while serving."""
    out = []
    for warm in (False, True):
        cfg, eng = _reduced_server(card, 6, "bfloat16")
        if warm:
            assert eng.warmup() == 4            # K 1..4 at the full row count (4 for 3 slots)
        before = eng.graph_captures
        toks = _serve_all(eng, cfg.vocab_size)
        out.append((toks, [c["k"][1:].cpu() for c in eng.pool_state], eng.graph_captures - before))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert out[1][2] == 0 and out[0][2] > 0


def test_serving_on_card_matches_cpu(card):
    """f32, every expert resident and rotary at 6 of 8: the card's tokens
    equal the CPU engine's."""
    for slots in (0, 6):
        got = []
        for device in (card, torch.device("cpu")):
            cfg, eng = _reduced_server(device, slots, "float32")
            got.append(_serve_all(eng, cfg.vocab_size))
        assert got[0] == got[1], slots


def test_serving_replay_after_a_moved_plane_raises(card):
    cfg, eng = _reduced_server(card, 6, "float32")
    eng.warmup()
    eng.pool_state[0]["k"] = eng.pool_state[0]["k"].clone()
    with pytest.raises(RuntimeError, match="moved"):
        _serve_all(eng, cfg.vocab_size, n=1, new=3)


def test_traced_engines_pass_the_auditor_and_equal_untraced(card):
    """Traced on the card, every launch a graph replay: a RotaryEngine with
    prefetch and windows of 2 at 3 of 8 slots (misses, relaunches, shadow
    uploads) and a paged ServingEngine at 6 of 8 (misses dropped, pages
    rolled back). Each trace passes the port's auditor, with one unit per
    window or tick and the prefetch spans inside their units' overlap
    windows; tokens and every counter equal an untraced run's."""
    from repro_torch.obs import Tracer, audit

    prompt = np.random.default_rng(0).integers(0, 200, (2, 12)).astype(np.int32)
    runs = {}
    for traced in (True, False):
        trs = (Tracer(), Tracer()) if traced else (None, None)
        _, eng = _reduced_engine(card, 3, prefetch=True, spec_k=2, trace=trs[0])
        toks = eng.generate(prompt, 12)
        cfg, srv = _reduced_server(card, 6, "bfloat16", prefetch=True, trace=trs[1])
        outs = _serve_all(srv, cfg.vocab_size)
        stats = [{k: v for k, v in dataclasses.asdict(e.stats).items() if k not in _MEASURED}
                 for e in (eng, srv)]
        runs[traced] = (toks, outs, stats, trs, eng, srv)
    toks, outs, stats, (tr_eng, tr_srv), eng, srv = runs[True]
    np.testing.assert_array_equal(toks, runs[False][0])
    assert outs == runs[False][1] and stats == runs[False][2]
    assert runs[False][4]._tr is None and runs[False][5]._tr is None
    rep = audit(tr_eng)
    rep.raise_for_violations()
    assert rep.units_checked >= eng.stats.spec_windows > 0 and rep.prefetch_spans > 0
    assert eng.stats.relaunched_steps + eng.stats.replayed_steps > 0
    assert eng.graph_replays > 0
    assert rep.overlap_ms == pytest.approx(eng.stats.overlap_ms, rel=0.01, abs=1e-3)
    rep = audit(tr_srv)
    rep.raise_for_violations()
    assert rep.units_checked == rep.launches == rep.pulls == srv.stats.windows > 0
    assert rep.prefetch_spans > 0 and rep.kv_events > 0 and rep.rotations > 0
    assert srv.stats.misses > 0
    assert srv.graph_replays > 0
    assert rep.overlap_ms == pytest.approx(srv.stats.overlap_ms, rel=0.01, abs=1e-3)


# ---------------------------------------------------------------------------
# the dense model families: K4 at head dims up to 256, K2 at new widths and
# query groups, a dense serving engine's window graphs
# ---------------------------------------------------------------------------
WIDE_HEADS = [(64, 8, 8), (96, 8, 8), (160, 8, 2), (256, 5, 1)]     # (dh, H, Hkv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,h,hkv", WIDE_HEADS)
def test_flash_attention_wide_heads_match_plain(card, dh, h, hkv, dtype):
    """K4's causal entry at the dense archs' head dims (musicgen 64, phi3
    96, pixtral 160, recurrentgemma 256: past 128 the Q fragments come from
    shared memory) over two rows of a ragged length, with and without a
    window and a soft cap, against the plain version; row 1 launched alone
    equals row 1 among 2 bit for bit."""
    b, s = 2, 200
    q = _randn((b, s, h, dh), dtype, 0, card)
    k = _randn((b, s, hkv, dh), dtype, 1, card)
    v = _randn((b, s, hkv, dh), dtype, 2, card)
    for window, soft_cap in ((None, None), (48, None), (None, 20.0)):
        out = ops.flash_attention(q, k, v, causal=True, window=window, soft_cap=soft_cap)
        torch.cuda.synchronize()
        exp = ref.flash_attention_ref(q, k, v, causal=True, window=window, soft_cap=soft_cap)
        torch.testing.assert_close(out.float(), exp.float(), **TOL[dtype])
    full = ops.flash_attention(q, k, v, causal=True)
    alone = ops.flash_attention(q[1:].contiguous(), k[1:].contiguous(), v[1:].contiguous(),
                                causal=True)
    assert torch.equal(alone, full[1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,h,hkv", WIDE_HEADS)
def test_flash_attention_chunk_wide_heads_match_plain(card, dh, h, hkv, dtype):
    """K4's chunk-append entry at the same head dims: C queries at cur_len
    77 against a 256-slot cache whose slots past the live keys hold stale
    values (NaN keys, large values: masked, never scored), against the
    plain version; a query's output equals the same position scored in a
    chunk of one, bit for bit."""
    b, c, cap, cur = 2, 64, 256, 77
    q = _randn((b, c, h, dh), dtype, 0, card)
    k = _randn((b, cap, hkv, dh), dtype, 1, card)
    v = _randn((b, cap, hkv, dh), dtype, 2, card)
    want = ref.flash_attention_chunk_ref(q, k, v, cur)
    k[:, cur + c:] = float("nan")
    v[:, cur + c:] = 1e4
    cl = torch.tensor(cur, device=card)
    out = ops.flash_attention_chunk(q, k, v, cl)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    one = ops.flash_attention_chunk(q[:, 10:11].contiguous(), k, v,
                                    torch.tensor(cur + 10, device=card))
    assert torch.equal(one, out[:, 10:11])


K2_SHAPES = [(96, 1), (96, 4), (160, 1), (160, 4), (128, 9), (128, 12), (64, 9), (256, 12),
             (256, 10)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,g", K2_SHAPES)
def test_decode_attention_dense_widths_and_groups(card, dh, g, dtype):
    """K2 at the dense archs' shapes: dh 96 and 160 (m-tiles of O that 4
    warps do not divide), query groups 1 (phi3, musicgen), 4 (pixtral), 9
    (starcoder2-7b) and 12 (starcoder2-3b) on either tensor-core fragment
    count, and dh 256 g 10 (recurrentgemma: two fragments, the second
    partly empty); bf16 on tensor cores at every width. The contiguous
    entry over rows of lengths 1000 / 77 / 1 against the plain version, row
    1 alone bitwise itself among 3; the paged entry bitwise the contiguous
    entry on the gathered view."""
    from repro_torch.kernels import decode_attention as dec

    hkv, s, ps = 2, 1024, 16
    assert dec.decode_plan(s, dh, g, dtype).tensor_cores == (dtype == torch.bfloat16)
    q, k, v = _decode_inputs(3, s, g * hkv, hkv, dh, dtype, card)
    lengths = torch.tensor([1000, 77, 1], dtype=torch.int32, device=card)
    for cap in (None, 20.0):
        out = dec.decode_attention(q, k, v, lengths, soft_cap=cap)
        torch.cuda.synchronize()
        exp = ref.decode_attention_ref(q, k, v, lengths, soft_cap=cap)
        torch.testing.assert_close(out.float(), exp.float(), **TOL[dtype])
    full = dec.decode_attention(q, k, v, lengths)
    assert torch.equal(dec.decode_attention(q[1:2], k[1:2], v[1:2], lengths[1:2]), full[1:2])
    n_pages = s // ps
    planes = 3 * n_pages + 4
    gen = torch.Generator(device="cpu").manual_seed(dh + g)
    pt = (torch.randperm(planes - 1, generator=gen)[:3 * n_pages] + 1).reshape(3, n_pages)
    pt = pt.to(device=card, dtype=torch.int32)
    kp = _randn((planes, ps, hkv, dh), dtype, 5, card)
    vp = _randn((planes, ps, hkv, dh), dtype, 6, card)
    got = dec.decode_attention_paged(q, kp, vp, pt, lengths)
    want = ref.decode_attention_paged_ref(q, kp, vp, pt, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, dec.decode_attention(q, _gathered(kp, pt), _gathered(vp, pt),
                                                 lengths))


def _dense_server(device, arch="starcoder2-3b", dtype="bfloat16"):
    from repro_torch.config import get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), dtype=dtype)
    return cfg, ServingEngine(cfg, init_params(cfg, 0, "cpu"), rt=Runtime(cache_len=64),
                              num_slots=3, spec_cap=4, kv_page_size=8, device=device)


@pytest.mark.parametrize("arch,dtype", [("starcoder2-3b", "bfloat16"),
                                        ("phi3-mini-3.8b", "float32")])
def test_dense_serving_window_graphs_equal_eager_windows(card, arch, dtype):
    """A dense arch's serving windows (no residency, no KV snapshot)
    captured once per (window size, rows bucket) and replayed, against the
    same windows run eagerly on the card: the same tokens, KV pages and
    stats; every draft accepted; K2's paged entry and K4 launched, no MoE
    kernel."""
    out = {}
    for capture in (True, False):
        cfg, eng = _dense_server(card, arch, dtype)
        eng._gs.capture = capture
        ops.reset_launch_counts()
        toks = _serve_all(eng, cfg.vocab_size)
        counts = ops.launch_counts()
        stats = {k: v for k, v in dataclasses.asdict(eng.stats).items() if k not in _MEASURED}
        out[capture] = (toks, [{n: c[n].cpu() for n in c} for c in eng.pool_state], stats)
        assert counts["decode_attention"] > 0 and counts["flash_attention"] > 0
        assert counts["topk_gate"] == counts["slot_gmm"] == counts["slot_gmm_tiled"] == 0
        assert eng.stats.accepted_tokens == eng.stats.drafted_tokens > 0
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        for n in ("k", "v"):
            assert torch.equal(a[n][1:], b[n][1:])
    assert out[True][2] == out[False][2]


def test_dense_prefill_with_frontend_on_card_matches_cpu(card):
    """pixtral's reduced backbone (dh 16, frontend of 8 embeddings) in f32:
    prefill_model(frontend=) and three decode_model steps on the card
    against the CPU within 1e-4."""
    from repro_torch.config import get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import _to_device
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(reduce_for_smoke(get_config("pixtral-12b")), dtype="float32")
    params = tfm.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    fe = torch.from_numpy(rng.standard_normal((2, 8, cfg.frontend_dim)).astype(np.float32))
    got = {}
    for dev in (card, torch.device("cpu")):
        p = {**_to_device({k: v for k, v in params.items() if k != "layers"}, dev),
             "layers": [_to_device(layer, dev) for layer in params["layers"]]}
        logits, state = tfm.prefill_model(cfg, p, tokens[:, :6].to(dev), 32, frontend=fe.to(dev))
        rows = [logits]
        for t in range(3):
            rows.append(tfm.decode_model(cfg, p, tokens[:, 6 + t].to(dev), state, 14 + t)[0])
        got[dev.type] = torch.stack(rows).cpu()
    torch.testing.assert_close(got["cuda"], got["cpu"], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the recurrent families: recurrentgemma's local attention at its window,
# serving windows that give a row the same bits whatever else is live, and
# the group tick's graphs
# ---------------------------------------------------------------------------
def test_flash_attention_window_shorter_than_the_prompt(card):
    """K4 at recurrentgemma's shape: dh 256, 10 query heads on 1 KV head,
    window 2048 over 3,072 queries (KV tiles behind the band skipped),
    against the plain version; the last 64 queries launched alone against
    their band's keys equal their tile among all 3,072."""
    s, h, dh, w = 3072, 10, 256, 2048
    q = _randn((1, s, h, dh), torch.bfloat16, 0, card)
    k = _randn((1, s, 1, dh), torch.bfloat16, 1, card)
    v = _randn((1, s, 1, dh), torch.bfloat16, 2, card)
    out = ops.flash_attention(q, k, v, causal=True, window=w)
    torch.cuda.synchronize()
    exp = ref.flash_attention_ref(q, k, v, causal=True, window=w)
    torch.testing.assert_close(out.float(), exp.float(), **TOL[torch.bfloat16])
    assert torch.isfinite(out.float()).all()


def _live_row_logits(eng, vocab, others):
    """Row 0's window logits, position by position, for one request alone
    or beside ``others`` more (greedy, windows of 1)."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, int(rng.integers(5, 30))) for _ in range(1 + others)]
    seen = []
    launch = eng._window_launch

    def record(k):
        out = launch(k)
        seen.append(out["logits"][:k, 0].clone())
        return out

    eng._window_launch = record
    first = eng.submit(prompts[0], 10)
    for p in prompts[1:]:
        eng.submit(p, 10)
    eng.run()
    return first.output, torch.cat(seen)[:len(first.output) - 1]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen36-35b-a3b"])
def test_serving_row_bits_do_not_depend_on_the_other_rows(card, arch):
    """The repair of alone != concurrent: a serving window runs at the
    engine's full row count whatever is live, so row 0's logits (a dense
    config and an MoE one, bf16, every matmul on cuBLAS) are bitwise the
    same with 0 and with 3 other live rows."""
    from repro_torch.config import get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), dtype="bfloat16")
    params = init_params(cfg, 0, "cpu")
    got = []
    for others in (0, 3):
        eng = ServingEngine(cfg, params, rt=Runtime(cache_len=64), num_slots=4, spec_cap=1,
                            kv_page_size=8, device=card)
        got.append(_live_row_logits(eng, cfg.vocab_size, others))
    assert got[0][0] == got[1][0]
    assert torch.equal(got[0][1], got[1][1])


def test_group_tick_graphs_equal_eager_steps(card):
    """The group tick on reduced recurrentgemma (bf16): the single step
    captured once and replayed against the same steps run eagerly on the
    card: the same tokens, recurrent states and KV caches bit for bit, and
    each request alone gives its concurrent tokens."""
    from repro_torch.config import get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(reduce_for_smoke(get_config("recurrentgemma-2b")),
                              dtype="bfloat16")
    params = init_params(cfg, 0, "cpu")

    def server():
        return ServingEngine(cfg, params, rt=Runtime(cache_len=64), num_slots=3, device=card)

    out = {}
    for capture in (True, False):
        eng = server()
        assert not eng._paged
        eng._gs.capture = capture
        toks = _serve_all(eng, cfg.vocab_size)
        out[capture] = (toks, [{n: t.cpu() for n, t in c.items()} for c in eng.state],
                        eng.graph_captures, eng.graph_replays)
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert out[True][2] == 1 and out[True][3] > 0 and out[False][2:] == (0, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(5, 30))) for _ in range(4)]
    for i, p in enumerate(prompts):
        eng = server()
        r = eng.submit(p, 10)
        eng.run()
        assert r.output == out[True][0][i]


# ---------------------------------------------------------------------------
# Training on the card (no kernel: K1-K4 have no backward)
# ---------------------------------------------------------------------------
TRAIN_LOSS_TOL = 0.002           # |bf16 loss - f32 loss|, nats (chip_smoke's; the readings
TRAIN_GNORM_TOL = 0.01           # |bf16 grad norm / f32 - 1|  of tools/torch_train_tolerance.py)


@pytest.fixture
def train_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _train_cfg(arch, layers):
    from repro_torch.config import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, segments=((cfg.segments[0][0], layers),))


@pytest.mark.parametrize("impl", ["sorted", "dense"])
def test_train_steps_are_bitwise_deterministic_on_the_card(train_card, impl):
    """qwen2-moe (shared and padded experts) at published widths, 2 layers,
    2 x 256 topic tokens, capacity factor 1.25: two runs of 3 steps from
    one seed give the same losses, gradient norms and parameters, bit for
    bit, and launch no kernel."""
    from repro_torch.config import RunConfig, ShardingConfig
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.tree import leaves

    cfg = _train_cfg("qwen2-moe-a2.7b", 2)
    rt = tfm.Runtime(sharding=ShardingConfig(moe_impl=impl))
    spec = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=256, global_batch=2)
    runs = []
    ops.reset_launch_counts()
    for _ in range(2):
        state = init_train_state(cfg, tfm.init_params(cfg, 0, train_card))
        step_fn = make_train_step(cfg, rt, RunConfig(learning_rate=3e-4, warmup_steps=1))
        metrics = []
        for i in range(3):
            t, l = (torch.from_numpy(a).to(train_card) for a in batch_at_step(spec, i))
            state, m = step_fn(state, t, l)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, [p.detach().clone() for p in leaves(state["params"])]))
        del state
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("arch,layers", [("qwen2-moe-a2.7b", 2), ("starcoder2-3b", 4),
                                         ("pixtral-12b", 2)])
def test_train_loss_matches_f32_on_the_card(train_card, arch, layers):
    """At published widths (a second width beside chip_smoke's qwen36 and
    recurrentgemma), 2 x 512 tokens (after pixtral's 1,024 frontend
    positions: 1,536 take ``chunked_attention``): the bf16 loss and gradient norm
    within TRAIN_LOSS_TOL / TRAIN_GNORM_TOL of an f32 recomputation with the
    same weights upcast and the bf16 routing replayed."""
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.training import global_norm
    from repro_torch.tree import leaves, map_tree

    cfg = _train_cfg(arch, layers)
    n_front = cfg.frontend_len if cfg.frontend else 0
    spec = SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=512, global_batch=2)
    tokens, labels = (torch.from_numpy(a).to(train_card) for a in batch_at_step(spec, 0))
    fe = (_randn((2, n_front, cfg.frontend_dim), torch.float32, 1, train_card)
          if cfg.frontend else None)
    rt = tfm.Runtime()
    params = tfm.init_params(cfg, 0, train_card)
    for p in leaves(params):
        p.requires_grad_(True)
    routes = [moe_mod.Routing() for _ in range(cfg.num_moe_layers)]
    loss, _ = tfm.lm_loss(cfg, params, tokens, labels, rt, fe, routes=routes)
    gnorm = float(global_norm(torch.autograd.grad(loss, leaves(params))))
    p32 = map_tree(lambda t: t.detach().float().requires_grad_(True), params)
    del params
    loss32, _ = tfm.lm_loss(dataclasses.replace(cfg, dtype="float32"), p32, tokens, labels, rt,
                            fe, routes=[moe_mod.Routing(r.ids, replay=True) for r in routes])
    gnorm32 = float(global_norm(torch.autograd.grad(loss32, leaves(p32))))
    assert abs(float(loss.detach()) - float(loss32.detach())) <= TRAIN_LOSS_TOL
    assert abs(gnorm / gnorm32 - 1) <= TRAIN_GNORM_TOL
