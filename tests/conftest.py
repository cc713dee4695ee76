"""Test configuration: run everything on CPU with 8 virtual devices.

Mirrors the reference's absence of any GPU/TPU requirement for correctness
(the reference is CPU-only C++) while letting every collective in
fealess_tpu.parallel run on a virtual 8-device mesh — the standard JAX
analog of a fake backend (SURVEY.md §4d).

Must run before jax is imported anywhere, hence the env mutation at module
import time (pytest imports conftest first).
"""

import os

# Force CPU: the session env may preset JAX_PLATFORMS to the TPU backend,
# where f32 matmuls default to bf16 MXU passes — tests must be exact.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# A pytest plugin (jaxtyping) imports jax BEFORE this conftest, freezing
# jax_platforms from the pre-existing env; override the live config too.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is XLA-compile-bound (~12 min
# cold); warm re-runs skip every big compile.  Failures to read/write are
# non-fatal warnings (jax_raise_persistent_cache_errors defaults False).
_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
jax.config.update("jax_compilation_cache_dir", os.path.abspath(_CACHE_DIR))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.15)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.default_backend() == "cpu", jax.default_backend()

REFERENCE_DIR = "/root/reference"


@pytest.fixture()
def rng():
    """Fresh deterministic generator per test — results must not depend on
    test execution order."""
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; its card fixture skips the "
        "test without one")


def has_reference() -> bool:
    return os.path.isdir(REFERENCE_DIR)
