"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, `chip_smoke.py`, `bench.py`,
`scripts/measure_quality.py`): if `JAX_COMPILATION_CACHE_DIR` is set, JAX
reads it itself and nothing is set in code; otherwise the cache lives at
the fixed `<checkout>/.jax_cache` (listed in `.gitignore`). The path is
part of the cache key, so a fixed path is what lets a second process hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use. Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
