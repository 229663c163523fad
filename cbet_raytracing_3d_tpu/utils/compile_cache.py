"""Persistent XLA compilation cache.

The reference pays its compile cost once, at nvcc build time (Makefile:11-12);
every run of `cbet-gpu` starts from a ready binary.  Under JAX the analog is
the persistent compilation cache: serialized executables keyed on HLO hash,
written to disk and reused across processes.

Call :func:`enable_persistent_cache` before the first compile (bench.py,
chip_smoke.py and the CLI do).  Placement:

* ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache directory — JAX
  reads it itself, and nothing here sets another;
* otherwise ``<checkout>/.jax_cache`` (listed in ``.gitignore``): a fixed
  path, so the cache hits across processes of one checkout.

Safe by construction: entries are keyed on the full HLO + compile options +
jaxlib/backend version hash, so a stale entry can only miss, never corrupt.
"""

from __future__ import annotations

import os

#: the default cache directory, at the root of the checkout
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory.  Idempotent."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache even fast compiles: a fresh process then starts warm
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
