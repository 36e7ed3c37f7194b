"""Sampling primitives for temperature > 0 decode, on the engine's device.

The counterpart of ``repro/models/sampling.py``. The speculative window
(:func:`repro_torch.models.transformer.decode_window`) and the engine's
between-window draw share exactly these functions, so a token drawn inside
a K-position window is bit-identical to the same token drawn by a size-1
window or by the standalone draw (:func:`build_sample_fn`).

PRNG protocol (stateless, position-keyed), as in the reference: every draw
is keyed by ``fold_in(row_key, n)``, ``n`` the cache position whose logits
are sampled, so spec-K and single-token decode use the same key per
position and a rejected position re-draws with the same key.

The keys and bits are JAX's: threefry2x32 with JAX's partitionable
random-bits layout (``jax_threefry_partitionable``, the default of jax
0.9), ``fold_in`` and ``categorical``'s Gumbel-max draw
(``jax/_src/prng.py``, ``jax/_src/random.py``), written as torch integer
ops. The 32-bit words live in int64 tensors masked with ``0xFFFFFFFF``
(torch's uint32 arithmetic is partial on CUDA). A key is an int64 tensor
[..., 2] of those words. Keys and raw bits equal JAX's bit for bit; the
Gumbel noise goes through ``log`` twice, whose last bit may differ between
XLA and torch, so a drawn token can differ from JAX's only at a near tie.

Logit warping (:func:`warp_probs`) keeps the reference's set: top-k keeps
``top_k`` candidates with the lowest index winning ties, top-p sorts
descending with a stable sort and keeps tokens while the mass before them
is below ``top_p``. Everything stays on the device with static shapes, so a
CUDA graph captures a window's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(torch.finfo(torch.float32).tiny)


class SampleParams(NamedTuple):
    """Static warp parameters (hashable: the engine keys window graphs by them)."""

    temperature: float = 1.0
    top_k: int = 0                  # 0 = off
    top_p: float = 1.0


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds), on 32-bit words held in int64
    tensors that broadcast together; JAX's ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: [2] int64 words, the seed taken mod 2^32
    (JAX converts a Python int seed to 32 bits, so the high word is 0)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in`` over keys [..., 2] and data broadcasting to
    ``keys[..., 0]`` (taken mod 2^32, as JAX's uint32 conversion does)."""
    d = torch.as_tensor(data, device=keys.device).to(torch.int64) & MASK
    a, b = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def row_keys(seed: int, rows: int, device=None) -> torch.Tensor:
    """[rows, 2] base keys: ``fold_in(PRNGKey(seed), r)``, one stream per row."""
    return fold_in(prng_key(seed, device), torch.arange(rows, device=device))


def request_key(seed: int, device=None) -> torch.Tensor:
    """[2] base key of one serving request (batch-independent)."""
    return prng_key(seed, device)


def position_keys(keys: torch.Tensor, pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """Per-row draw keys ``fold_in(row_key, pos_row)``: keys [B, 2], ``pos``
    an int or an integer tensor, scalar or [B] (a device scalar stays on the
    device)."""
    b = keys.shape[0]
    p = torch.as_tensor(pos, device=keys.device).to(torch.int64).reshape(-1).expand(b)
    return fold_in(keys, p)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per entry, [B, n] int64 from keys [B, 2]: JAX's
    partitionable layout, threefry of the counter pair (0, i), the two
    output words XORed."""
    cnt = torch.arange(n, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(cnt), cnt)
    return a ^ b


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` f32 [B, n]: the top 23 bits as a mantissa in
    [1, 2), minus 1, scaled to [minval, maxval) in f32."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # fills, not copies from the host: a CUDA graph captures them
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode, f32 [B, n]."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` per row: the argmax of Gumbel noise plus
    the logits [B, V] (the lowest index on ties). Returns int64 [B]."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


def warp_probs(logits: torch.Tensor, sp: SampleParams) -> torch.Tensor:
    """Temperature / top-k / top-p warped probabilities, [B, V] f32, exactly
    0 off the support."""
    x = logits.float() / sp.temperature
    v = x.shape[-1]
    if 0 < sp.top_k < v:
        order = torch.argsort(-x, dim=-1, stable=True)            # lowest index on ties
        keep = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        keep.scatter_(-1, order[:, :sp.top_k], True)
        x = torch.where(keep, x, torch.full_like(x, float("-inf")))
    p = torch.softmax(x, dim=-1)
    if sp.top_p < 1.0:
        order = torch.argsort(-p, dim=-1, stable=True)
        p_sorted = torch.gather(p, -1, order)
        cum = torch.cumsum(p_sorted, dim=-1)
        keep_sorted = cum - p_sorted < sp.top_p                   # the head is always kept
        keep = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
        keep.scatter_(-1, order, keep_sorted)
        p = torch.where(keep, p, torch.zeros_like(p))
        p = p / p.sum(dim=-1, keepdim=True)
    return p


def draw(keys: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One categorical token per row from warped ``probs`` [B, V] with
    per-row ``keys`` [B, 2]; zero-probability tokens are never drawn."""
    logp = torch.where(probs > 0, torch.log(probs), torch.full_like(probs, float("-inf")))
    return categorical(keys, logp)


def sample_step(logits: torch.Tensor, keys: torch.Tensor, pos: Union[int, torch.Tensor],
                sp: SampleParams) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp, fold, draw for one position: the shared in-window / standalone
    draw. Returns ``(tokens [B] int64, probs [B, V], tok_probs [B])``."""
    p = warp_probs(logits, sp)
    nxt = draw(position_keys(keys, pos), p)
    return nxt, p, torch.gather(p, -1, nxt[:, None])[:, 0]


def build_sample_fn(sp: SampleParams):
    """``fn(logits [B, V], keys [B, 2], pos) -> tokens [B]``: the engine's
    between-window draw, the same ops and keys as the in-window draw."""
    def fn(logits: torch.Tensor, keys: torch.Tensor, pos) -> torch.Tensor:
        return sample_step(logits, keys, pos, sp)[0]

    return fn
