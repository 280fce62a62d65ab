"""Profiling helper (aux subsystem C16): a jax.profiler trace context."""

from __future__ import annotations

from contextlib import contextmanager

import jax


@contextmanager
def trace(log_dir: str):
    """jax.profiler trace context; view with tensorboard/xprof or read
    with jax.profiler.ProfileData."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
