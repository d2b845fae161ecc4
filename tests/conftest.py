"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

The platform is JAX_PLATFORMS when it is set and the CPU otherwise, forced
through jax.config before any backend is initialized. Hardware-independent
tests (sharding included) run on xla_force_host_platform_device_count=8.
Tests that need the GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips them when no GPU is present; they run on the card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

from audio_codec_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# persistent compile cache: full-codec XLA compiles take ~1-2 min on CPU
enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none. Decided here,
    at run time, so every worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda -m gpu on the card")


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: `pytest tests/` runs the fast gate; slow-marked
    modules run when targeted explicitly, via -m, or LC3TPU_FULL_TESTS=1."""
    if config.option.markexpr or os.environ.get("LC3TPU_FULL_TESTS"):
        return
    if any(a.endswith(".py") or "::" in a for a in config.args):
        return  # a file/test was named explicitly: run exactly what was asked
    skip = pytest.mark.skip(
        reason="slow tier: run with -m slow or LC3TPU_FULL_TESTS=1")
    for it in items:
        if "slow" in it.keywords:
            it.add_marker(skip)
