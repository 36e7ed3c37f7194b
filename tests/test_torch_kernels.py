"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode on the CPU) and against the jnp code the reference's main
path runs; and the CPU dispatch of ``repro_torch.kernels.ops``.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: f32 results agree to 1e-5 absolute + 1e-5 relative (the two
frameworks sum in different orders); bf16 results to 1e-2 + 1e-2 (one bf16
rounding of f32 sums that differ in the last bits). Routing ids are exact.
"""
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
    ops.decode_attention(q, kv, kv, cur_len=3)
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
