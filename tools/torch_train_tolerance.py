#!/usr/bin/env python3
"""How far a bf16 training step sits from f32 on the card, sound and with a
planted bf16 fault: the readings that ``chip_smoke.py``'s step-0 limits
(``TRAIN_LOSS_TOL``, ``TRAIN_GNORM_TOL``) are set from, and the control that
shows those limits catch a lost f32 upcast.

    python3 tools/torch_train_tolerance.py [--cases train-qwen36,...] [--out FILE]

Each case builds its weights from seed 0 at published widths and runs
``chip_smoke.train_step0_vs_f32`` (a bf16 ``lm_loss`` and its gradients,
then the same in f32 with the weights upcast and the bf16 routing replayed)
once as the port is, then once under each fault, planted for that call
only by replacing one function of the port in memory (no file changes):

* ``loss_bf16``: the loss chunk without its f32 upcast (the logits, the
  log-sum-exp and the chunk's sums stay bf16);
* ``scores_bf16``: attention's scores and softmax stay bf16;
* ``norm_bf16``: the block and final norms compute in bf16.

A fault touches the bf16 run alone (an f32 model is f32 either way).
The cases: chip_smoke's two training paths (its depth, batch, sequence,
remat and MoE dispatch) and the three of
``tests/test_torch_gpu.py::test_train_loss_matches_f32_on_the_card``
(2 x 512 tokens, the default ``Runtime``). Prints the card's ``nvidia-smi``
name and power limit, a line per reading (|loss - f32| in nats, grad norm
/ f32 - 1, and whether both are within chip_smoke's limits), and one JSON
line per case (also to ``--out``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, arch, layers (0: all), batch, tokens a row, chip_smoke's runtime?)
CASES = (
    ("train-qwen36", "qwen36-35b-a3b", 4, 4, 512, True),
    ("train-recurrentgemma-2b", "recurrentgemma-2b", 0, 4, 512, True),
    ("gpu-test-qwen2-moe", "qwen2-moe-a2.7b", 2, 2, 512, False),
    ("gpu-test-starcoder2-3b", "starcoder2-3b", 4, 2, 512, False),
    ("gpu-test-pixtral-12b", "pixtral-12b", 2, 2, 512, False),
)


def _loss_bf16(hc, tc, head):
    import torch

    logits = hc @ head                                  # the f32 upcast lost
    gold = torch.gather(logits, -1, torch.clamp(tc, min=0).long()[..., None])[..., 0]
    valid = (tc >= 0).to(logits.dtype)
    return ((torch.logsumexp(logits, dim=-1) - gold) * valid).sum(), valid.sum()


def _scores_bf16(qg, k, soft_cap):
    import torch

    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(qg.shape[-1])
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    return s


def _norm_bf16(kind, p, x, eps=1e-6):
    import torch

    if kind == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * p["scale"]
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _faults():
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm

    return {"loss_bf16": (tfm, "_chunk_loss", _loss_bf16),
            "scores_bf16": (attn, "_scores", _scores_bf16),
            "norm_bf16": (tfm, "apply_norm", _norm_bf16)}


@contextlib.contextmanager
def planted(module, name, fn, dtype):
    """``module.name`` replaced by ``fn`` for calls on ``dtype`` tensors."""
    orig = getattr(module, name)

    def pick(*args, **kwargs):
        first = next(a for a in args if hasattr(a, "dtype"))
        return (fn if first.dtype == dtype else orig)(*args, **kwargs)

    setattr(module, name, pick)
    try:
        yield
    finally:
        setattr(module, name, orig)


def run_case(dev, case, faults):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.config import ShardingConfig, get_config
    from repro_torch.data import SyntheticSpec, batch_at_step
    from repro_torch.models import transformer as tfm

    label, arch, layers, batch, seq, smoke_rt = case
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, segments=((cfg.segments[0][0], layers),))
    rt = (tfm.Runtime(sharding=ShardingConfig(remat_policy="dots_saveable", moe_impl="sorted"))
          if smoke_rt else tfm.Runtime())
    spec = (SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                          kind="topic", seed=0) if smoke_rt
            else SyntheticSpec(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    tokens, labels = (torch.from_numpy(a).to(dev) for a in batch_at_step(spec, 0))
    fe = None
    if cfg.frontend:
        fe = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)).to(dev)
    params = tfm.init_params(cfg, 0, dev)
    rows = []
    for fault in ("none",) + tuple(faults):
        module, name, fn = _faults()[fault] if fault != "none" else (None, None, None)
        with (planted(module, name, fn, torch.bfloat16) if module else contextlib.nullcontext()):
            r = cs.train_step0_vs_f32(cfg, params, tokens, labels, rt, fe)
        gc.collect()
        torch.cuda.empty_cache()
        dl, dg = abs(r["loss"] - r["loss32"]), r["gnorm"] / r["gnorm32"] - 1
        ok = dl <= cs.TRAIN_LOSS_TOL and abs(dg) <= cs.TRAIN_GNORM_TOL
        rows.append(dict(fault=fault, loss_diff=dl, gnorm_rel=dg, within_limits=ok, **r))
        print(f"{label} [{cfg.num_layers} layers, {batch} x {seq}] {fault:11s}: |loss - f32| "
              f"{dl:.6f} nats (limit {cs.TRAIN_LOSS_TOL}), grad norm / f32 - 1 {dg:+.6f} "
              f"(limit {cs.TRAIN_GNORM_TOL}): {'within' if ok else 'OUTSIDE'}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(case=label, arch=cfg.name, layers=cfg.num_layers, batch=batch, seq=seq,
                rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    ap.add_argument("--faults", default="loss_bf16,scores_bf16,norm_bf16")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_tolerance: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    faults = [f for f in args.faults.split(",") if f]
    by_label = {c[0]: c for c in CASES}
    for label in (c for c in args.cases.split(",") if c):
        line = json.dumps(run_case(torch.device("cuda"), by_label[label], faults))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
