"""Persistent XLA compilation cache bootstrap.

Compiling the engine's programs for the GPU costs seconds to minutes per
process; the persistent cache turns repeat invocations (CLI runs, bench
passes, resumed jobs) into cache hits.  Enabled on package import:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX uses it, and nothing else is set
  here;
* otherwise, unless JAX is pinned to the CPU: the fixed ``.jax_cache/``
  directory inside the checkout (a fixed path, since the path is part of
  the cache's key);
* CPU runs stay uncached: cached CPU AOT artifacts carry machine-feature
  flags that can mismatch across hosts (SIGILL risk warnings from
  cpu_aot_loader), and CPU compiles are fast anyway.

``WLD_NO_COMPILE_CACHE=1`` disables it.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> None:
    if os.environ.get("WLD_NO_COMPILE_CACHE") == "1":
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX reads it itself
    try:
        import jax

        if getattr(jax.config, "jax_compilation_cache_dir", None):
            return  # configured in code by the caller
        platforms = (getattr(jax.config, "jax_platforms", None) or "")
        if platforms.split(",")[0] == "cpu":
            return
        CACHE_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except Exception:  # never fail import over cache setup
        pass
