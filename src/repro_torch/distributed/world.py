"""Start a world of ranks: the one way the tests and ``chip_smoke.py`` run
code on several processes.

``run_world(fn, nprocs, args=..., device=...)`` (``device`` "cuda" unless
the caller asks for "cpu") spawns ``nprocs`` fresh
interpreters (``multiprocessing``'s ``spawn``: nothing is inherited but the
arguments), each of which starts a process group through a
``torch.distributed.FileStore`` in a temporary directory (never a fixed TCP
port, so worlds started side by side cannot meet), calls ``fn(rank,
nprocs, *args)`` and writes its result, or its traceback, to a file there.
The caller gets the results by rank. A rank that raises, dies or outlives
``timeout`` (seconds, for the whole world) ends the world: every rank still
running is killed and :class:`WorldError` names the rank and carries its
traceback. ``fn`` and ``args`` must pickle (a module-level function).

The backend is chosen explicitly and printed (:func:`choose_backend`):
``gloo`` for CPU ranks; ``nccl`` when each rank has its own card; ``gloo``
when the ranks share fewer cards than there are ranks, because NCCL refuses
two ranks on one device. gloo takes CUDA tensors for ``all_reduce``,
``all_gather`` and ``reduce_scatter_single`` (the collectives the sharded
paths and ZeRO-1 make), staging them through host memory
(``tools/torch_gloo_probe.py`` checks every collective on the card).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


class WorldError(RuntimeError):
    """A rank of a world failed or the world outlived its timeout."""


def choose_backend(device: str, nprocs: int) -> Tuple[str, str]:
    """(backend, reason) for ``nprocs`` ranks on ``device`` ("cpu" or "cuda")."""
    if device == "cpu":
        return "gloo", "CPU ranks"
    if device != "cuda":
        raise ValueError(f"ranks run on 'cpu' or 'cuda', got {device!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("CUDA ranks asked for, but no card is present")
    if cards >= nprocs:
        return "nccl", f"one card a rank ({cards} cards)"
    return "gloo", (f"{nprocs} ranks share {cards} card(s); NCCL refuses two ranks on "
                    f"one device, gloo stages CUDA tensors through the host")


def _rank_main(fn: Callable, rank: int, nprocs: int, directory: str, backend: str,
               device: str, timeout: float, args: Sequence[Any]) -> None:
    import torch.distributed as dist
    result = {"ok": False, "error": "did not finish"}
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
        store = dist.FileStore(os.path.join(directory, "store"), nprocs)
        dist.init_process_group(backend, store=store, rank=rank, world_size=nprocs,
                                timeout=timedelta(seconds=timeout))
        result = {"ok": True, "value": fn(rank, nprocs, *args)}
    except BaseException:                       # reported to the caller, then exit 1
        result = {"ok": False, "error": traceback.format_exc()}
    finally:
        path = os.path.join(directory, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
        if dist.is_initialized() and result["ok"]:
            dist.destroy_process_group()
    sys.exit(0 if result["ok"] else 1)


def _read(directory: str, rank: int) -> Optional[dict]:
    path = os.path.join(directory, f"rank{rank}.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def run_world(fn: Callable, nprocs: int, *, args: Sequence[Any] = (), device: str = "cuda",
              timeout: float = 120.0) -> List[Any]:
    """``fn(rank, nprocs, *args)`` on ``nprocs`` ranks, the backend
    :func:`choose_backend`'s; returns the ranks' results in rank order.
    The ranks run on the card unless ``device="cpu"`` asks for the CPU; with
    no card present a CUDA world raises before any rank starts."""
    backend, why = choose_backend(device, nprocs)
    print(f"world: {nprocs} ranks on {device}, backend {backend} ({why})", flush=True)
    directory = tempfile.mkdtemp(prefix="repro_world_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, directory, backend, device, timeout, tuple(args)))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                r = failed[0]
                got = _read(directory, r)
                why = got["error"] if got else f"exit code {procs[r].exitcode}, no result"
                raise WorldError(f"rank {r} of {nprocs} failed:\n{why}")
            running = [r for r, p in enumerate(procs) if p.exitcode is None]
            if not running:
                break
            if time.monotonic() > deadline:
                raise WorldError(f"the world of {nprocs} ranks outlived its {timeout:.0f} s "
                                 f"timeout; ranks {running} were still running")
            time.sleep(0.02)
        return [_read(directory, r)["value"] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(directory, ignore_errors=True)
