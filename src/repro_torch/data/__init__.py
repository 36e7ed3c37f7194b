"""Deterministic synthetic token streams and the prefetching loader."""
from repro_torch.data.pipeline import Loader  # noqa: F401
from repro_torch.data.synthetic import SyntheticSpec, batch_at_step, stream  # noqa: F401
