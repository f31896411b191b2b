"""Persistent-compilation-cache location and host keys.

The program keeps JAX's compile cache where ``JAX_COMPILATION_CACHE_DIR``
says, and otherwise in the fixed ``<repo>/.jax_cache``
(:func:`compile_cache_dir`): a fixed path, because the path is part of
the cache's key.

XLA:CPU caches ahead-of-time compiled code keyed by HLO only; an entry
compiled on a host with different CPU features loads with a warning and
can SIGILL at run time (cpu_aot_loader "machine type ... doesn't match").
:func:`host_cache_dir` keys the CPU test suite's cache directory, and
``native`` its ``-march=native`` libraries, by a host CPU signature, so a
moved directory is simply cold instead of lethal.
"""

from __future__ import annotations

import hashlib
import os
import platform

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def host_cache_key() -> str:
    """Short digest of the CPU identity (ISA feature flags + arch)."""
    sig = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    sig += ":" + line.split(":", 1)[1].strip()
                    break
    except OSError:
        sig += ":" + platform.processor()
    return hashlib.sha256(sig.encode()).hexdigest()[:12]


def host_cache_dir(base: str) -> str:
    """<base>-<hostkey>: a persistent cache path safe across machines."""
    return f"{base}-{host_cache_key()}"


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` where set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (every compiled program of at least ``min_compile_secs``)."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
