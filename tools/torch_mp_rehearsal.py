#!/usr/bin/env python3
"""A CPU rehearsal of ``chip_smoke.py``'s model-axis worlds.

    PYTHONPATH=src python3 tools/torch_mp_rehearsal.py [--paths mp-train-qwen36,sp-train-qwen3-4b,
                                                                mp-rotary-qwen36]
                                                        [--dtype bfloat16]

Runs ``chip_smoke``'s ``mp-train-qwen36`` and ``sp-train-qwen3-4b`` exactly
as it does (the unsharded twin in this process, then the ranks of
``chip_smoke._mpt_rank`` through ``distributed/world.py``, then
``chip_smoke._mpt_check``), but on CPU ranks (gloo) and at the reduced
widths of ``configs.reduce_for_smoke`` in ``--dtype``: the same meshes
(data 2 x model 2; data 1 x model 3), tokens and steps, each rank's
``torch.cuda`` timers and memory calls stubbed. It prints each world's
readings against the twin (step 0's loss and cross-entropy |diff|, its
grad norm, the parameters' relative RMS after step 0, FSDP against the
run without it) and fails where ``chip_smoke``'s tolerances (MP_LOSS_TOL,
MP_GNORM_TOL, MP_RMS_TOL, MP_FSDP_TOL) would. chip_smoke's tolerances were set from these readings.

``mp-rotary-qwen36`` (not in the default list) runs ``chip_smoke._rot_rank``
on the ranks of its mesh (data 1 x model 2) and then ``chip_smoke._rot_check``
(the unsharded RotaryEngine as the twin, the f32 truth), at 6 of the reduced
config's 8 experts a slot group: it prints the ranks' logits' worst and
median relative RMS against the twin, the reading ROT_RMS_TOL was set from.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _stub(dtype: str):
    """chip_smoke on the CPU: its device, a reduced config, no-op CUDA calls."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import reduce_for_smoke

    cs.DIST_DEVICE = "cpu"
    cs.ROT_SLOTS = 6                              # of the reduced config's 8 experts
    cs.ROT_RUNS = tuple((label, cs.ROT_SLOTS if slots else 0, k)
                        for label, slots, k in cs.ROT_RUNS)
    base = cs._dist_cfg
    cs._dist_cfg = lambda spec: dataclasses.replace(reduce_for_smoke(base(spec)), dtype=dtype)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    return cs


def _rank(rank, nprocs, spec, path, dtype):
    return _stub(dtype)._mpt_rank(rank, nprocs, spec, path)


def _rot_rank(rank, nprocs, spec, dtype):
    return _stub(dtype)._rot_rank(rank, nprocs, spec)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="mp-train-qwen36,sp-train-qwen3-4b")
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()
    cs = _stub(args.dtype)
    import numpy as np
    import torch

    from repro_torch.distributed.world import run_world

    specs = {s.label: s for s in cs.DIST_PATHS}
    dev = torch.device("cpu")
    ok = True
    for label in args.paths.split(","):
        spec = specs[label]
        t0 = time.perf_counter()
        if label == "mp-rotary-qwen36":
            ranks = run_world(_rot_rank, int(np.prod(spec.mesh)), args=(spec, args.dtype),
                              device="cpu", timeout=1200)
            try:
                got = cs._rot_check(dev, spec, ranks)
            except AssertionError as exc:
                ok = False
                print(f"{label}: FAILED: {exc}")
                continue
            print(f"{label} ({args.dtype}, reduced widths, {time.perf_counter() - t0:.1f} s): "
                  f"logits RMS {got['rms_rel']:.2e} of the twin's (median "
                  f"{got['rms_median']:.2e}); greedy ids agree {got['agree']}")
            continue
        with tempfile.TemporaryDirectory(prefix="mp_rehearsal_") as d:
            path = os.path.join(d, "twin.pt")
            twin = cs._mp_twin(dev, spec, path)
            ranks = run_world(_rank, int(np.prod(spec.mesh)), args=(spec, path, args.dtype),
                              device="cpu", timeout=1200)
        try:
            got = cs._mpt_check(dev, spec, ranks, twin)
        except AssertionError as exc:
            ok = False
            print(f"{label}: FAILED: {exc}")
            continue
        print(f"{label} ({args.dtype}, reduced widths, {time.perf_counter() - t0:.1f} s): "
              f"step 0 loss |diff| {got['d_loss0']:.2e}, cross-entropy |diff| "
              f"{got['d_xent0']:.2e}, grad norm ratio - 1 {got['d_norm0']:.2e}, parameters RMS {got['twin_rms']:.2e} of the twin's"
              + (f"; FSDP losses |diff| {got['fsdp_d_loss']:.2e}, RMS {got['fsdp_rms']:.2e}"
                 if "fsdp_rms" in got else ""))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
