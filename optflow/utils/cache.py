"""Persistent XLA compilation cache.

The batched TV-L1 program and the feature pre-aligner are large programs;
a cold process pays their compilation before the first solve (the
reference binary has the same cold-start shape in its OpenCV CUDA module
builds, just at build time). JAX's persistent cache, keyed on (HLO,
compiler version, platform), makes every later process warm; this helper
turns it on with one call from all entry points (CLI, bench scripts,
tests, pod runner).

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads the variable itself
  and no other directory is set here;
- otherwise :data:`DEFAULT_DIR`, a fixed directory inside the checkout
  (git-ignored). It is the same path for every process, so one process
  finds what another compiled.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str:
    """Idempotently enable the on-disk XLA compilation cache; returns the
    directory in use."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache everything that takes noticeable time; tiny programs are
    # cheap to recompile and would only churn the directory.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
