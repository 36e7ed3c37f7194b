"""Shared fixtures. Smoke tests see ONE cpu device (the 512-device flag is set
only inside repro.launch.dryrun, never globally)."""
import jax
import numpy as np
import pytest

from repro.config import get_config
from repro.configs import reduce_for_smoke
from repro.models import init_params

jax.config.update("jax_platform_name", "cpu")

_PARAMS_CACHE = {}


def params_for(arch: str):
    """Session-cached reduced params (init is the slow part on 1 core)."""
    if arch not in _PARAMS_CACHE:
        cfg = reduce_for_smoke(get_config(arch))
        _PARAMS_CACHE[arch] = (cfg, init_params(cfg, jax.random.PRNGKey(0)))
    return _PARAMS_CACHE[arch]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips without one"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
