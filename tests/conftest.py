"""Test configuration: an 8-device virtual CPU mesh + float64.

The CPU backend is forced unless ``JAX_PLATFORMS`` names the platforms
itself: ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`` runs
the tests marked ``gpu`` on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from sclmd_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# The fast tier is XLA-COMPILE-bound (almost all of it jit compiles of
# the same integrator/bath programs), so runs benefit enormously from
# the persistent compilation cache. The cache lives IN the repo
# (tests/.xla_cache, committed): a fresh checkout's first suite run
# replays the committed compiles instead of redoing them. Entries are
# keyed on jax version/backend/flags — a mismatch silently falls back
# to a normal compile, so a stale cache can only cost time, never
# correctness. JAX_COMPILATION_CACHE_DIR overrides the directory.
XLA_CACHE_DIR = os.path.join(os.path.dirname(__file__), ".xla_cache")
enable_compile_cache(XLA_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (for tests marked
    ``gpu``; decided here, never at collection time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests/ -m gpu")
