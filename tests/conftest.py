"""Test configuration: force an 8-device virtual CPU mesh so sharding tests
run without an accelerator.  Must run before jax is imported anywhere."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# persistent compilation cache: the suite is dominated by recompiles of
# the same kernels across test processes.  JAX_COMPILATION_CACHE_DIR wins
# where set; otherwise a host-keyed directory (XLA:CPU AOT entries from a
# different CPU generation can SIGILL when loaded).
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from blasr_tpu.hostcache import host_cache_dir  # noqa: E402

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", host_cache_dir(
        os.path.join(os.path.dirname(__file__), ".jax_cache")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def small_genome():
    from blasr_tpu.sim import random_genome
    return random_genome(200_000, seed=42, n_contigs=2)


@pytest.fixture(scope="session")
def small_index(small_genome):
    from blasr_tpu.index import build_genome_index
    return build_genome_index(small_genome, k=12)
