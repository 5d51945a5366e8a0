"""Persistent XLA compilation cache for the entry points.

jax's in-memory jit cache dies with the interpreter, so every process would
otherwise recompile the solve (seconds per shape, more for large f64
programs). The reference pays its compile cost once at build time
(MakefileSYCL); the drivers (cli.py, bench.py, sweep.py, chip_smoke.py)
enable jax's persistent compilation cache instead.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (no
other directory is ever configured then); otherwise the fixed directory
``<checkout>/.jax_cache`` (listed in .gitignore). The path is part of the
cache key, so it must not move between runs. Opt out with
HPCCG_NO_COMPILE_CACHE=1. Library imports do NOT enable it — only the
executable entry points call this.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str | None:
    """Turn on jax's persistent compilation cache. Returns the cache dir in
    effect, or None when disabled by HPCCG_NO_COMPILE_CACHE."""
    if os.environ.get("HPCCG_NO_COMPILE_CACHE"):
        return None
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    # cache everything that took real compile time; tiny compiles are
    # cheaper to redo than to hash/serialize
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
