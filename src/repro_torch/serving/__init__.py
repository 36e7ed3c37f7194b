"""Serving on the card: request-level continuous batching over a paged KV
pool (``ServingEngine``), the port of ``repro.serving``.

``KVPagePool`` owns the pages (page 0 the scratch page, worst-case
reservations at admission, lazy allocation after); ``Scheduler`` owns
admission (EDF under page-pool pressure, power-of-two prefill buckets), the
request lifecycle timestamps behind TTFT and inter-token latency, and the
per-row speculative lengths; ``Sampler`` / ``SamplerConfig`` and the accept
rules (``sampler.greedy_accept``, ``sampler.stochastic_accept``) are the
host side of sampling, whose draws run on the device
(``repro_torch.models.sampling``) keyed per request and position.
"""
from repro_torch.serving.kv_pool import KVPagePool, PagePoolError  # noqa: F401
from repro_torch.serving.sampler import Sampler, SamplerConfig  # noqa: F401
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: F401


def __getattr__(name: str):
    # ``core.engine`` imports this package's sampler, and the serving engine
    # imports ``core.engine``: the engine loads on first use
    if name == "ServingEngine":
        from repro_torch.serving.engine import ServingEngine
        return ServingEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
