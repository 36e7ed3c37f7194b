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


def test_wrapper_refuses_a_bad_launch_loudly(card):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros((1, 4, 2, 160), device=card)               # head_dim above the limit
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


def test_engine_on_card_matches_cpu(card):
    """Reduced f32 qwen36 on the card emits the CPU engine's tokens, through
    every kernel, with misses and replays exercised."""
    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.engine import RotaryEngine
    from repro_torch.models.transformer import Runtime, init_params

    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen36-35b-a3b")), dtype="float32")
    # 2 x 40 prompt tokens x top-2 picks: grouped by slot (the tiled K1 body)
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
    assert all(n > 0 for n in out["cuda"][2].values()), out["cuda"][2]
    assert all(n == 0 for n in out["cpu"][2].values())
