"""The port's quantized slot formats against the JAX package's.

``repro_torch.quant`` and the int8 helpers of ``repro_torch.core.slots``
must give byte-equal packed weights, scales and mins to ``repro.quant`` and
``repro.core.slots`` on the same numpy input (both round half to even and
quantize against the f16-rounded affine). Dequantized weights agree to
1 ulp: XLA may contract ``q * s + m`` into a fused multiply-add, the port
rounds the product and the sum apart. The int8 and int4 plain versions of
the grouped matmul agree with the Pallas kernel in interpret mode to f32
1e-5 absolute + 1e-5 relative (the two frameworks sum in another order).
The int4 cases include the input on which the reference's own round-trip
bound fails (``tests/test_quant_properties.py``): the port is held to the
reference's bytes there, not to that bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.core import slots as js
from repro.kernels import moe_gmm as jgmm
from repro_torch import quant as tq
from repro_torch.core import slots as ts
from repro_torch.kernels import ops

F32 = dict(atol=1e-5, rtol=1e-5)
TYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _w(shape, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * rng.uniform(0.05, 5.0)).astype(np.float32)
    w[..., :4, 0] = 0.25                       # a flat run: a group whose max == min
    return w


# the input hypothesis found for test_int4_roundtrip_bounded_by_group_scale (seed 0, rows 14,
# cols 12, group 2, spread 5.0): f16 rounds a group's min up past a small step
BOUND_EXAMPLE = ((14, 12), 2)


def _int4_input(shape, group):
    if (shape, group) == BOUND_EXAMPLE:
        return (np.random.default_rng(0).standard_normal(shape) * 5.0).astype(np.float32)
    return _w(shape, sum(shape) + group)


def _bytes_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape,group", [
    ((64, 48), 64),            # reduced w_gate/w_up: one group of 64
    ((48, 64), 64),            # reduced w_down: the group clamps to 48
    ((3, 64, 48), 16),         # a stack, four groups per column
    ((4, 48, 64), 16),
    ((2, 36, 10), 6),          # a group that is not a power of two
    ((2, 768, 40), 64),        # w_down's depth at full width: 12 groups
    pytest.param(*BOUND_EXAMPLE, id="bound-example-rows14-cols12-group2"),
])
def test_int4_quantizer_is_byte_equal_to_reference(shape, group):
    w = _int4_input(shape, group)
    want = jq.quantize_int4(w, group)
    got = tq.quantize_int4(torch.from_numpy(w), group)
    for a, b in zip(want, got):
        _bytes_equal(a, b)
    if len(shape) == 3:
        for a, b in zip(jq.quantize_int4_batch(w, group),
                        tq.quantize_int4_batch(torch.from_numpy(w), group)):
            _bytes_equal(a, b)
        one = tq.quantize_int4(torch.from_numpy(w[1]), group)   # groups never span experts
        for a, b in zip(one, got):
            _bytes_equal(a, b[1])
    _bytes_equal(np.asarray(jq.unpack_int4(jnp.asarray(want[0]))), tq.unpack_int4(got[0]))
    np.testing.assert_array_max_ulp(np.asarray(jq.dequantize_int4(*map(jnp.asarray, want))),
                                    tq.dequantize_int4(*got).numpy(), maxulp=1)


def test_int4_nibble_order_low_is_the_even_row():
    """Rows 2i and 2i+1 differ: byte i holds row 2i low, row 2i+1 high."""
    w = np.array([[0.0, 2.0], [15.0, 4.0], [3.0, 6.0], [9.0, 8.0]], np.float32)
    packed, scale, mn = tq.quantize_int4(torch.from_numpy(w), 4)
    assert scale[0, 0] == 1.0 and mn[0, 0] == 0.0           # column 0 quantizes to itself
    assert packed[:, 0].tolist() == [0 | 15 << 4, 3 | 9 << 4]
    for a, b in zip(jq.quantize_int4(w, 4), (packed, scale, mn)):
        _bytes_equal(a, b)
    np.testing.assert_array_equal(tq.unpack_int4(packed)[:, 0].numpy(), [0, 15, 3, 9])


@pytest.mark.parametrize("shape", [(64, 48), (5, 48, 64), (3, 2, 16, 8)])
def test_int8_quantizer_is_value_equal_to_reference(shape):
    w = _w(shape, 7)
    q, s = js.quantize_int8(w)
    tq8, ts8 = ts.quantize_int8(torch.from_numpy(w))
    _bytes_equal(q, tq8)
    _bytes_equal(s, ts8)
    if len(shape) >= 3:
        q, s = js.quantize_int8_batch(w)
        tq8, ts8 = ts.quantize_int8_batch(torch.from_numpy(w))
        _bytes_equal(q, tq8)
        _bytes_equal(s, ts8)
        _bytes_equal(js.quantize_int8(w[2])[1], ts8[2])        # per-expert scales
    bshape = (q.shape[0],) + (1,) * (q.ndim - 2) + (q.shape[-1],) if q.ndim > 2 else s.shape
    np.testing.assert_array_equal(
        np.asarray(js.dequantize_int8(jnp.asarray(q), jnp.asarray(s.reshape(bshape)), jnp.float32)),
        ts.dequantize_int8(tq8, ts8.reshape(bshape)).numpy())


def test_sizes_and_link_bytes_match_reference():
    for rows in (2, 6, 36, 48, 64, 768, 2048, 1408):
        for g in (2, 6, 16, 64, 128):
            assert tq.effective_group(rows, g) == jq.effective_group(rows, g), (rows, g)
    for shape in ((64, 48), (48, 64), (128, 2048, 768), (768, 2048)):
        for g in (6, 16, 64):
            if shape[-2] % 2 == 0:
                assert tq.int4_tensor_bytes(shape, g) == jq.int4_tensor_bytes(shape, g)
    for q in (None, "int8", "int4"):
        assert tq.bytes_per_element(q, 2, 64) == jq.bytes_per_element(q, 2, 64)
    full = {"w_gate": (2048, 768), "w_up": (2048, 768), "w_down": (768, 2048)}
    reduced = {"w_gate": (64, 48), "w_up": (64, 48), "w_down": (48, 64)}
    for shapes in (full, reduced):
        for q in (None, "int8", "int4"):
            for g in (16, 64):
                assert (ts.quantized_expert_bytes(shapes, q, 2, g)
                        == js.quantized_expert_bytes(shapes, q, 2, g))
    # one qwen36 expert on the link, at its published widths
    assert ts.quantized_expert_bytes(full, None) == 9_437_184
    assert ts.quantized_expert_bytes(full, "int8") == 4_732_928
    assert ts.quantized_expert_bytes(full, "int4", 2, 64) == 2_654_208


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_slot_gmm_int8_plain_matches_pallas(xdtype):
    """K1 int8 body: the per-channel scale multiplies the f32 product; the
    MISS slot (zero int8, zero scale) computes 0; the output is f32."""
    x_np = _w((5, 3, 64), 1)
    q, s = js.quantize_int8_batch(_w((6, 64, 48), 2))
    q[5] = 0
    s[5] = 0
    lut = np.array([2, 5, 0, 4, 2], np.int32)
    jd, td = TYPES[xdtype]
    xj = jnp.asarray(x_np, jd)
    xt = torch.from_numpy(x_np).to(td)
    want = jgmm.slot_gmm(xj, jnp.asarray(q), jnp.asarray(lut), jnp.asarray(s), interpret=True)
    got = ops.slot_gmm(xt, torch.from_numpy(q), torch.from_numpy(lut), torch.from_numpy(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 3, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert not got[1].abs().sum()


@pytest.mark.parametrize("d,f,group", [(64, 48, 64), (64, 48, 16), (48, 64, 16), (36, 10, 6)])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_slot_gmm_int4_plain_matches_pallas(d, f, group, xdtype):
    """K1 int4 body: nibbles unpacked (low = even row), ``q * s + m`` per
    group before the product, f32 out; the MISS slot computes 0."""
    x_np = _w((5, 4, d), d)
    packed, scale, mn = jq.quantize_int4_batch(_w((6, d, f), f), group)
    packed[5] = 0
    scale[5] = 0
    mn[5] = 0
    lut = np.array([1, 5, 0, 3, 1], np.int32)
    jd, td = TYPES[xdtype]
    want = jgmm.slot_gmm(jnp.asarray(x_np, jd), jnp.asarray(packed), jnp.asarray(lut),
                         jnp.asarray(scale), jnp.asarray(mn), interpret=True)
    got = ops.slot_gmm(torch.from_numpy(x_np).to(td), torch.from_numpy(packed),
                       torch.from_numpy(lut), torch.from_numpy(scale), torch.from_numpy(mn))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 4, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert not got[1].abs().sum()


@pytest.mark.parametrize("quantization,group", [("int8", 64), ("int4", 64), ("int4", 16)])
def test_slot_store_lands_the_reference_planes(quantization, group):
    """write_batch of the packed warehouse rows lands the bytes the
    reference's write_batch lands by quantizing the float rows, reports the
    same bytes moved, and leaves the MISS slot zero in every plane."""
    shapes = {"w_gate": (64, 48), "w_up": (64, 48), "w_down": (48, 64)}
    host = {n: _w((7,) + s, i) for i, (n, s) in enumerate(shapes.items())}
    ref = js.SlotStore(4, shapes, jnp.float32, quantization, group_size=group)
    store = ts.SlotStore(4, shapes, torch.float32, "cpu", quantization, group)
    wh = ts.quantize_experts({n: torch.from_numpy(w) for n, w in host.items()},
                             quantization, group, chunk=3)
    for slots, experts in (([2, 0], [6, 1]), ([3], [4]), ([0, 1], [5, 2])):
        moved_ref = ref.write_batch(slots, {n: w[experts] for n, w in host.items()})
        moved = store.write_batch(slots, {n: p[experts] for n, p in wh.items()})
        assert moved == moved_ref
    want = ref.raw_pytree()
    got = store.raw_dict()
    assert set(got) == set(want)
    for name, plane in got.items():
        _bytes_equal(np.asarray(want[name]), plane)
        assert not plane[4].float().abs().sum(), name             # the MISS slot
    with pytest.raises(ValueError):                               # every plane, or none
        store.write_batch([0], {"w_up": wh["w_up"][:1]})


def test_warehouse_quantized_in_chunks_equals_whole_stack():
    w = torch.from_numpy(_w((7, 48, 64), 3))
    for quantization, whole in (("int8", ts.quantize_int8_batch(w)),
                                ("int4", tq.quantize_int4_batch(w, 16))):
        planes = ts.quantize_experts({"w_down": w}, quantization, 16, chunk=2)
        names = ["w_down", "scale_w_down", "min_w_down"][:len(whole)]
        for name, t in zip(names, whole):
            assert torch.equal(planes[name], t), (quantization, name)
