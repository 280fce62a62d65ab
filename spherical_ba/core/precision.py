"""Float32-faithful contractions for geometry/solver math.

On a GPU from Ampere on, an f32 `einsum`/`dot`/`@` at default precision
may run on the tensor cores in TF32, which keeps a 10-bit mantissa
(~1e-3 relative error). That is fatal for rotation chains, normal
equations and Schur systems, so every geometry- or solver-critical
contraction in this package goes through these helpers, which ask for
HIGHEST (full f32). The descriptor distance matmul (ops/match.py) sets
HIGHEST itself, because TF32 moves distances across the Lowe ratio cut.

These contractions are tiny (3/6/9-dim inner axes) and bandwidth-bound,
so HIGHEST precision costs next to nothing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

einsum = partial(jnp.einsum, precision=HIGHEST)


def matmul(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)
