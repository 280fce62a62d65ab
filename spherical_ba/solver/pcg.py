"""Preconditioned conjugate gradients for the framework's large SPD
systems — the counterpart of the reference's Ceres ITERATIVE_SCHUR
linear solver choice (spherical_bundle_adjuster.cpp:335: the reference
itself solves its reduced camera system ITERATIVELY; round-1 of this repo
used dense Cholesky, which is O(C^3) and caps at ~tens of keyframes).

Used with MATRIX-FREE operators: the caller supplies `matvec` (one
application of the system matrix, e.g. the Schur complement applied via
per-landmark gather/segment-sum passes, or the pose-graph Hessian applied
via per-edge products) and `precond` (typically block-Jacobi: batched
6x6 Cholesky solves). Nothing quadratic in the parameter count is ever
materialized, so camera counts of 10^2-10^3 and pose graphs of 10^3+
nodes fit comfortably; under `shard_map` the matvec carries the one
`psum` per iteration and the PCG state stays replicated.

All dot products run at HIGHEST precision (reduced-precision reductions
lose the small residual norms that drive convergence).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core.precision import HIGHEST


def _dot(a, b):
    return jnp.sum(a * b, dtype=jnp.float32)


class PcgResult(NamedTuple):
    x: jax.Array
    iters: jax.Array      # iterations actually run
    rel_residual: jax.Array  # ||r|| / ||b|| at exit


def pcg(
    matvec: Callable,
    b: jax.Array,
    precond: Callable | None = None,
    max_iters: int = 100,
    tol: float = 1e-6,
) -> PcgResult:
    """Solve A x = b for SPD A with preconditioned conjugate gradients.

    matvec(x) -> A x; precond(r) -> M^{-1} r (identity if None). `b` is any
    float array (the solver treats it as a flat vector). Terminates when
    ||r|| <= tol * ||b|| or after max_iters. Safe under jit/vmap/shard_map
    (lax.while_loop; if matvec psums, every device sees identical scalars
    and the loop stays in lockstep).
    """
    if precond is None:
        precond = lambda r: r

    b_norm = jnp.sqrt(_dot(b, b))
    thresh2 = (tol * b_norm) ** 2

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = _dot(r0, z0)

    def cond(state):
        _, r, _, _, _, k = state
        return (k < max_iters) & (_dot(r, r) > thresh2)

    def body(state):
        x, r, z, p, rz, k = state
        ap = matvec(p)
        pap = _dot(p, ap)
        alpha = rz / jnp.where(pap > 0, pap, 1.0)
        alpha = jnp.where(pap > 0, alpha, 0.0)  # breakdown guard
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / jnp.where(rz > 0, rz, 1.0)
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x, r, _, _, _, k = jax.lax.while_loop(cond, body, (x0, r0, z0, p0, rz0, 0))
    rel = jnp.sqrt(_dot(r, r)) / jnp.maximum(b_norm, 1e-30)
    return PcgResult(x=x, iters=k, rel_residual=rel)


def block_jacobi_precond(diag_blocks):
    """Block-Jacobi preconditioner from (N, B, B) SPD diagonal blocks.

    Returns precond(r) operating on r of shape (N*B,) or (N, B): batched
    closed-form Cholesky solves (smallmat.cholesky_unrolled — the unrolled
    form fuses elementwise instead of calling a batched factorization)."""
    from ..core import smallmat

    n, bdim, _ = diag_blocks.shape
    L = smallmat.cholesky_unrolled(
        diag_blocks + 1e-9 * jnp.eye(bdim, dtype=diag_blocks.dtype)
    )

    def apply(r):
        rb = r.reshape(n, bdim)
        out = smallmat.cholesky_solve_unrolled(L, rb)
        return out.reshape(r.shape)

    return apply
