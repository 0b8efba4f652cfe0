"""Test configuration: CPU with 8 virtual devices (for sharding tests) and
double precision (regression gates match the reference's DOUBLE build,
reference Makefile:27), set BEFORE jax initialises.

`JAX_PLATFORMS` is only defaulted: tests marked `gpu` need the card and
run with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`; elsewhere
they skip."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "collective_call_terminate" not in flags:
    # virtual devices time-share one core: shards reach collectives at
    # very different times on load-imbalanced configs, and XLA's CPU
    # rendezvous ABORTS the process after 40s by default (rendezvous.cc).
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
              " --xla_cpu_collective_call_terminate_timeout_seconds=7200")
os.environ["XLA_FLAGS"] = flags
os.environ.setdefault("GANDALF_PRECISION", "double")

import jax  # noqa: E402

from gandalf_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import, so every xdist worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    return jax.devices()[0]
