"""Which collectives gloo takes on CUDA tensors, on this machine.

Two ranks share one card through ``distributed/world.py`` (gloo, as the
sharded paths of ``chip_smoke.py`` run), and each tries every collective
the port's sharded paths could make, on CUDA tensors in f32 and bf16:
``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter_single`` (``reduce_scatter_tensor`` where the former is
missing) and ``all_to_all_single``. A call that raises is reported with its
error; one that returns is checked against the sum or concatenation it
should give. One line per (collective, type), then a JSON object.

    python3 tools/torch_gloo_probe.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _probe(rank: int, nprocs: int) -> dict:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.arange(8, dtype=torch.float32, device=dev).to(dtype)
        mine = base + 100 * rank
        every = [base + 100 * r for r in range(nprocs)]
        total = sum(e.float() for e in every).to(dtype)
        cases = {}

        def all_reduce():
            x = mine.clone()
            dist.all_reduce(x)
            return torch.equal(x, total)

        def all_gather():
            parts = [torch.empty_like(mine) for _ in range(nprocs)]
            dist.all_gather(parts, mine)
            return all(torch.equal(p, e) for p, e in zip(parts, every))

        def all_gather_into_tensor():
            x = torch.empty(nprocs * 8, dtype=dtype, device=dev)
            dist.all_gather_into_tensor(x, mine)
            return torch.equal(x, torch.cat(every))

        def reduce_scatter():
            scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
            x = torch.empty(8 // nprocs, dtype=dtype, device=dev)
            scatter(x, mine)
            return torch.equal(x, total.reshape(nprocs, -1)[rank])

        def all_to_all_single():
            x = torch.empty_like(mine)
            dist.all_to_all_single(x, mine)
            want = torch.cat([e.reshape(nprocs, -1)[rank] for e in every])
            return torch.equal(x, want)

        for fn in (all_reduce, all_gather, all_gather_into_tensor, reduce_scatter,
                   all_to_all_single):
            try:
                torch.cuda.synchronize()
                cases[fn.__name__] = "ok" if fn() else "wrong result"
                torch.cuda.synchronize()
            except Exception as exc:              # the answer this probe is after
                cases[fn.__name__] = f"raises {type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
        out[str(dtype).replace("torch.", "")] = cases
    return out


def main() -> int:
    import torch

    from repro_torch.distributed.world import run_world

    if not torch.cuda.is_available():
        print("torch_gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    ranks = run_world(_probe, 2, device="cuda", timeout=300)
    for dtype, cases in ranks[0].items():
        for name, got in cases.items():
            same = all(r[dtype][name] == got for r in ranks)
            print(f"  {name:>24} {dtype:>9}: {got}{'' if same else ' (ranks differ)'}")
    print(json.dumps(ranks[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
