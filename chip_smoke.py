#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (nothing is caught):

1. require a CUDA device; print the card's name and power limit;
2. build the four kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all at once) and print each one's ptxas report;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and time kernel, plain version, one
   library call computing the same function, and the card's bound;
4. run the main path: ``RotaryEngine.generate`` on ``qwen36-35b-a3b`` at its
   published widths, cut to the first 8 of its 48 layers (the depth is the
   only cut: 8 layers of host warehouse are 9.7 GB, the whole model's would
   be 58 GB, made at random on every run), rotary residency with 96 of 128
   expert slots, 2 requests of 512 prompt tokens and 64 new tokens at batch
   1, greedy, cache_len 1024; the kernels' launch counters are zeroed just
   before and read just after, and every kernel must have launched;
5. check the engine's prefill logits and its decode logits against a plain
   full-residency forward of the same weights on the card (``kernels/ref.py``
   called directly), and that every miss was corrected on the host; then a
   control: the first request again, fed the same tokens, with the host miss
   correction switched off, must fail that check (so the check can see a
   broken engine);
6. print the kernels' JSON line, the card line, and last the result line.

Tolerances. Kernel vs plain version (phase 3), outputs in bf16: |kernel -
plain| <= 2e-2 + 2e-2 |plain| (f32 sums in another order, one more bf16
rounding of outputs of magnitude ~1); the gate's ids exactly, wherever the
k-th and (k+1)-th probabilities differ. Engine vs reference (phase 5): the
engine computes in bf16 like the model it serves, so it is held to the f32
forward of the same weights ("truth") as tightly as a plain bf16 forward
is: per request, the RMS over all positions and vocabulary entries of
(engine - truth) may exceed that of (plain bf16 - truth) by at most a factor
1.5 plus 0.01, the largest per-position error by at most a factor 1.5 plus
0.05, and the engine's greedy id must equal the truth's wherever the
truth's top-2 margin exceeds twice the plain bf16 forward's largest error.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor peak (data sheet)
LAYERS = 8
PROMPT, NEW, REQUESTS, CACHE = 512, 64, 2, 1024
SLOTS = 96
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)
ERR_RATIO, RMS_SLACK, MAX_SLACK = 1.5, 0.01, 0.05
REPLACES = {
    "slot_gmm": "src/repro/kernels/moe_gmm.py:111",
    "slot_gmm_tiled": "src/repro/kernels/moe_gmm.py:111",
    "decode_attention": "src/repro/kernels/decode_attention.py:70",
    "topk_gate": "src/repro/kernels/topk_gate.py:81",
    "flash_attention": "src/repro/kernels/flash_attention.py:88",
}
SOURCE = {
    "slot_gmm": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "slot_gmm_tiled": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "topk_gate": "src/repro_torch/kernels/csrc/topk_gate.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50) -> float:
    """Mean ms per call over ``iters`` calls between CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check_close(name, got, want, **tol) -> float:
    import torch

    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{name}: {m}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions at the main path's shapes
# ---------------------------------------------------------------------------
def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_gate as tk

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # --- K1 slot_gmm: decode (8 picks, C=1) and a prefill grouping at T=512 --
    d, f, s1 = 2048, 768, SLOTS + 1
    w_up = randn(s1, d, f, scale=d ** -0.5)
    w_down = randn(s1, f, d, scale=f ** -0.5)
    w_up[SLOTS] = 0
    w_down[SLOTS] = 0
    err = 0.0
    luts = [torch.randperm(SLOTS, generator=g, device=dev)[:8].to(torch.int32)
            for _ in range(16)]
    luts[0][3] = SLOTS                                         # one pick reads MISS
    x_dec = randn(8, 1, d)
    h_dec = randn(8, 1, f)
    for lut in luts[:4]:
        err = max(err, check_close("slot_gmm decode up", gmm.slot_gmm(x_dec, w_up, lut),
                                   ref.slot_gmm_ref(x_dec, w_up, lut), **KERNEL_TOL))
        err = max(err, check_close("slot_gmm decode down", gmm.slot_gmm(h_dec, w_down, lut),
                                   ref.slot_gmm_ref(h_dec, w_down, lut), **KERNEL_TOL))
    ids = torch.randint(0, 128, (PROMPT * 8,), generator=g, device=dev)
    slot_of = torch.randperm(128, generator=g, device=dev)      # 96 resident experts
    slot_of = torch.where(slot_of < SLOTS, slot_of, torch.full_like(slot_of, SLOTS))
    picks = slot_of[ids]
    counts = torch.bincount(picks[picks < SLOTS], minlength=SLOTS).cpu()
    used = torch.nonzero(counts).flatten().to(dev, torch.int32)
    c_max = int(counts.max())
    x_pre = randn(used.numel(), c_max, d)
    h_pre = randn(used.numel(), c_max, f)
    err_pre = max(check_close("slot_gmm prefill up", gmm.slot_gmm(x_pre, w_up, used),
                              ref.slot_gmm_ref(x_pre, w_up, used), **KERNEL_TOL),
                  check_close("slot_gmm prefill down", gmm.slot_gmm(h_pre, w_down, used),
                              ref.slot_gmm_ref(h_pre, w_down, used), **KERNEL_TOL))
    cyc = iter(range(10 ** 9))

    def lut_next():
        return luts[next(cyc) % len(luts)]        # cycle slot sets: weights come cold from HBM

    distinct = sum(int(torch.unique(l[l < SLOTS]).numel()) for l in luts) / len(luts)
    nbytes = distinct * d * f * 2 + 8 * d * 2 + 8 * f * 2 + 8 * 4
    b_ms, b_by = bound(nbytes, 2 * 8 * d * f)
    rows["slot_gmm"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: gmm.slot_gmm(x_dec, w_up, lut_next())),
        plain_ms=time_ms(lambda: ref.slot_gmm_ref(x_dec, w_up, lut_next())),
        library_ms=time_ms(lambda: torch.bmm(x_dec, w_up.index_select(0, lut_next().long()))),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"x [8,1,{d}] @ w [{s1},{d},{f}] bf16 through an 8-entry LUT (decode gate/up)",
    )
    rows_used = int(counts.sum())                  # the picks' rows; padding is not work
    pre_bytes = used.numel() * d * f * 2 + rows_used * (d + f) * 2
    b_ms, b_by = bound(pre_bytes, 2 * rows_used * d * f)
    rows["slot_gmm_tiled"] = dict(
        max_abs_err=err_pre,
        ms=time_ms(lambda: gmm.slot_gmm(x_pre, w_up, used), 20),
        plain_ms=time_ms(lambda: ref.slot_gmm_ref(x_pre, w_up, used), 20),
        library_ms=time_ms(lambda: torch.bmm(x_pre, w_up.index_select(0, used.long())), 20),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"x [{used.numel()},{c_max},{d}] @ w [{s1},{d},{f}] bf16, the picks of {PROMPT} "
              f"tokens grouped by slot ({rows_used} rows; prefill gate/up)",
    )

    # --- K2 decode_attention: B=1, H=32, Hkv=4, dh=128, S=1024 ----------------
    h, hkv, dh, s = 32, 4, 128, CACHE
    caches = [(randn(1, s, hkv, dh), randn(1, s, hkv, dh)) for _ in range(LAYERS)]
    q = randn(1, h, dh)
    err = 0.0
    for length in (1, 100, 576, 1024):
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        k, v = caches[length % LAYERS]
        for cap in (None, 30.0):
            err = max(err, check_close(
                f"decode_attention len={length}", dec.decode_attention(q, k, v, lens, soft_cap=cap),
                ref.decode_attention_ref(q, k, v, lens, soft_cap=cap), **KERNEL_TOL))
    length = PROMPT + NEW                                       # the last decode step's work
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    lay = iter(range(10 ** 9))

    def kv():
        return caches[next(lay) % LAYERS]

    def sdpa():
        k, v = kv()
        return F.scaled_dot_product_attention(
            q[:, :, None], k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2),
            enable_gqa=True)

    nbytes = 2 * length * hkv * dh * 2 + 2 * h * dh * 2 + 4
    b_ms, b_by = bound(nbytes, 4 * length * h * dh)
    rows["decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: dec.decode_attention(q, *kv(), lens)),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, *kv(), lens)),
        library_ms=time_ms(sdpa),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q [1,{h},{dh}] vs cache [1,{s},{hkv},{dh}] bf16 at length {length}",
    )

    # --- K3 topk_gate: T in {1, 512}, E=128, k=8, forced ties -------------------
    err = 0.0
    for t in (1, PROMPT):
        lg = torch.randn((t, 128), generator=g, device=dev)
        lg[:, [5, 9, 70]] = 6.0
        got_ids, got_w = tk.topk_gate(lg, 8, normalize=True)
        want_ids, want_w = ref.topk_gate_ref(lg, 8, normalize=True)
        probs = torch.softmax(lg, -1).sort(dim=-1, descending=True).values
        distinct_rows = (probs[:, 7] - probs[:, 8]) > 0
        if not torch.equal(got_ids[distinct_rows], want_ids[distinct_rows]):
            raise AssertionError(f"topk_gate T={t}: ids differ from the plain version")
        if not (got_ids[:, :3] == torch.tensor([5, 9, 70], device=dev)).all():
            raise AssertionError(f"topk_gate T={t}: ties not broken lowest index first")
        err = max(err, check_close(f"topk_gate T={t}", got_w, want_w, atol=1e-6, rtol=1e-5))
    lg1 = torch.randn((1, 128), generator=g, device=dev)

    def lib_gate():
        w, i = torch.topk(torch.softmax(lg1, -1), 8)
        return i, w / w.sum(-1, keepdim=True)

    b_ms, b_by = bound(128 * 4 + 8 * 8, 128 * 4)
    rows["topk_gate"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: tk.topk_gate(lg1, 8)),
        plain_ms=time_ms(lambda: ref.topk_gate_ref(lg1, 8)),
        library_ms=time_ms(lib_gate),
        bound_ms=b_ms, bound_by=b_by,
        shape="logits [1,128] f32, k=8, renormalized (decode)",
    )

    # --- K4 flash_attention: B=1, S=512, H=32, Hkv=4, dh=128, causal -------
    qf, kf, vf = randn(1, PROMPT, h, dh), randn(1, PROMPT, hkv, dh), randn(1, PROMPT, hkv, dh)
    err = check_close("flash_attention", fa.flash_attention(qf, kf, vf),
                      ref.flash_attention_ref(qf, kf, vf), **KERNEL_TOL)
    pairs = PROMPT * (PROMPT + 1) // 2
    nbytes = (2 * PROMPT * h * dh + 2 * PROMPT * hkv * dh) * 2
    b_ms, b_by = bound(nbytes, 4 * pairs * h * dh)
    qt, kt, vt = qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2)
    rows["flash_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention(qf, kf, vf), 20),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(qf, kf, vf), 20),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q [1,{PROMPT},{h},{dh}] k/v [1,{PROMPT},{hkv},{dh}] bf16, causal (prefill)",
    )
    for name, r in rows.items():
        log(f"  {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3e}, "
            f"kernel_ms {r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, "
            f"library_ms {r['library_ms']:.4f}, bound_ms {r['bound_ms']:.5f} ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phase 5: the plain full-residency forward
# ---------------------------------------------------------------------------
def reference_logits(cfg, engine, tokens, dtype):
    """Logits at every position of ``tokens`` [1, S] from a plain forward with
    every expert resident, in ``dtype``, on the engine's weights cast to it,
    calling ``kernels/ref.py`` directly."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_norm

    def cast(tree):          # bf16: the weights as they are (routers stay f32)
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.float() if dtype == torch.float32 else tree

    dev = engine.device
    m = cfg.moe
    emb = cast(engine.embed_params)
    x = tfm.embed_tokens(emb, torch.as_tensor(tokens, device=dev))
    s, d = x.shape[1], x.shape[2]
    pos = torch.arange(s, device=dev)[None, :]
    for li, p in enumerate(engine.layers):
        p = cast(p)
        h = apply_norm(cfg.norm, p["ln1"], x)
        q, k, v = attn._project_qkv(p["attn"], cfg.attention, h, pos)
        x = x + ref.flash_attention_ref(q, k, v, causal=True).reshape(1, s, -1) @ p["attn"]["wo"]
        h2 = apply_norm(cfg.norm, p["ln2"], x).reshape(s, d)
        ids, w = ref.topk_gate_ref(h2.float() @ p["moe"]["router"], m.top_k,
                                   normalize=m.norm_topk_prob)
        experts = cast({n: t.to(dev) for n, t in engine.host_experts[li].items()})
        flat = ids.reshape(-1).long()
        counts = torch.bincount(flat, minlength=m.num_experts)
        used = torch.nonzero(counts).flatten()
        c_max = int(counts.max())
        order = torch.argsort(flat, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        row = torch.arange(order.numel(), device=dev) - starts[flat[order]]
        grp = torch.full((m.num_experts,), -1, dtype=torch.long, device=dev)
        grp[used] = torch.arange(used.numel(), device=dev)
        xs = torch.zeros((used.numel(), c_max, d), dtype=x.dtype, device=dev)
        xs[grp[flat[order]], row] = h2[order // m.top_k]
        hid = (F.silu(ref.slot_gmm_ref(xs, experts["w_gate"], used))
               * ref.slot_gmm_ref(xs, experts["w_up"], used))
        ys = ref.slot_gmm_ref(hid, experts["w_down"], used)
        outs = torch.empty((flat.numel(), d), dtype=x.dtype, device=dev)
        outs[order] = ys[grp[flat[order]], row]
        y = (outs.float().reshape(s, m.top_k, d) * w[..., None]).sum(1).to(x.dtype)
        x = x + y.reshape(1, s, d)
        del experts, xs, hid, ys, outs
    return tfm.lm_logits(cfg, emb, x)[0].float()


def judge(label, got, truth, plain) -> bool:
    """Log how far ``got`` [positions, vocab] is from the f32 ``truth``
    beside a plain bf16 forward's distance, and return whether it holds the
    tolerance stated at the top of this file."""
    import numpy as np

    e_eng = np.abs(got - truth).max(axis=1)                        # per position
    e_pl = np.abs(plain - truth).max(axis=1)
    rms_eng = float(np.sqrt(np.mean((got - truth) ** 2)))
    rms_pl = float(np.sqrt(np.mean((plain - truth) ** 2)))
    top2 = np.sort(truth, axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 2 * e_pl.max()
    agree = got.argmax(1) == truth.argmax(1)
    log(f"  {label}: vs the f32 truth (logit RMS {float(np.sqrt(np.mean(truth ** 2))):.4f}): "
        f"engine RMS err {rms_eng:.5f} (limit {ERR_RATIO * rms_pl + RMS_SLACK:.5f}), "
        f"per-position max median {np.median(e_eng):.4f} max {e_eng.max():.4f} (limit "
        f"{ERR_RATIO * e_pl.max() + MAX_SLACK:.4f}); plain bf16 forward RMS err {rms_pl:.5f}, "
        f"median {np.median(e_pl):.4f} max {e_pl.max():.4f}; greedy ids agree with the truth "
        f"at {int(agree[sure].sum())}/{int(sure.sum())} positions with margin > "
        f"{2 * e_pl.max():.3f}, at {int(agree.sum())}/{len(got)} in all")
    return bool(rms_eng <= ERR_RATIO * rms_pl + RMS_SLACK
                and e_eng.max() <= ERR_RATIO * e_pl.max() + MAX_SLACK and agree[sure].all())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port package under {ROOT / 'src'}; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 1 ---------------------------------------------------------------
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2 ---------------------------------------------------------------
    from repro_torch.kernels.build import build

    t0 = time.perf_counter()
    logs = build()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")

    # phase 3 ---------------------------------------------------------------
    log("[3] kernels vs plain versions at the main path's shapes")
    rows = kernel_phase(dev)

    # phase 4 ---------------------------------------------------------------
    import numpy as np

    from repro_torch.config import ResidencyConfig, get_config
    from repro_torch.core.engine import RotaryEngine
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Runtime, init_params

    full = get_config("qwen36-35b-a3b")
    cfg = dataclasses.replace(full, segments=((("attn_moe",), LAYERS),))
    log(f"[4] main path: {cfg.name} at published widths, {LAYERS} of {full.num_layers} layers, "
        f"rotary residency {SLOTS}/{cfg.moe.num_experts} slots, {REQUESTS} requests x "
        f"({PROMPT} prompt + {NEW} new), batch 1, greedy, cache_len {CACHE}")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, dev, expert_device="cpu")
    engine = RotaryEngine(cfg, params, ResidencyConfig(mode="rotary", num_slots=SLOTS),
                          rt=Runtime(cache_len=CACHE), batch=1, seed=0, device=dev)
    del params
    log(f"  set-up {time.perf_counter() - t0:.1f} s (weights on the card, warehouse to pinned "
        f"host memory, first residency); link {engine.cost.host_link_gbs:.1f} GB/s measured")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)
               for _ in range(REQUESTS)]
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for prompt in prompts:
        t0 = time.perf_counter()
        logits = engine.prefill(prompt)
        t_prefill = time.perf_counter() - t0
        step_logits, toks = [logits], []
        t0 = time.perf_counter()
        for _ in range(NEW):
            toks.append(int(engine.decode(step_logits[-1], 1)[0, 0]))
            step_logits.append(engine.last_logits)
        t_decode = time.perf_counter() - t0
        runs.append((prompt, toks, np.stack([l[0] for l in step_logits[:-1]]),
                     t_prefill, t_decode))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    host_computed = sum(l.host_computed for l in st.layers.values())
    for i, (_, toks, _, tp, td) in enumerate(runs):
        log(f"  request {i}: prefill {tp * 1e3:.1f} ms, decode {NEW / td:.2f} tok/s, "
            f"first tokens {toks[:8]}")
    log(f"  misses {st.misses}, replayed steps {st.replayed_steps}, host_computed "
        f"{host_computed}, uploaded {st.bytes_uploaded / 2**20:.1f} MB, sync pulls "
        f"{st.sync_pulls}, peak device memory {peak / 2**30:.2f} GiB")
    log(f"  kernel launches on the main path: {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    # phase 5 ---------------------------------------------------------------
    log("[5] engine vs plain full-residency forward on the card")
    if host_computed != st.misses:
        raise AssertionError(f"host_computed {host_computed} != misses {st.misses}")
    refs = []
    for i, (prompt, toks, got, _, _) in enumerate(runs):
        if not np.isfinite(got).all() or got.shape != (NEW, cfg.vocab_size):
            raise AssertionError(f"request {i}: logits not finite or of shape {got.shape}")
        seq = np.concatenate([prompt[0], np.asarray(toks[:-1], np.int32)])[None]
        truth = reference_logits(cfg, engine, seq, torch.float32)[PROMPT - 1:].cpu().numpy()
        plain = reference_logits(cfg, engine, seq, torch.bfloat16)[PROMPT - 1:].cpu().numpy()
        refs.append((truth, plain))
        if not judge(f"request {i}", got, truth, plain):
            raise AssertionError(f"request {i}: engine logits farther from the truth than bf16")
    # control: request 0 again, fed the same tokens, its misses left uncorrected
    engine.rescfg = dataclasses.replace(engine.rescfg, host_compute_misses=False)
    prompt, toks = runs[0][0], runs[0][1]
    rows_ctl = [engine.prefill(prompt)[0]]
    for tok in toks[:-1]:
        forced = np.zeros((1, cfg.vocab_size), np.float32)
        forced[0, tok] = 1.0                       # decode takes the argmax: this token
        engine.decode(forced, 1)
        rows_ctl.append(engine.last_logits[0])
    if judge("control (request 0, misses uncorrected)", np.stack(rows_ctl), *refs[0]):
        raise AssertionError("the logit check passed an engine that drops its misses")

    # phase 6 ---------------------------------------------------------------
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    log(f"[6] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
