"""Closed-form small-matrix linear algebra (2x2 / 3x3 / 6x6 blocks).

Adjugate/Cramer forms are pure elementwise math that fuses into the
surrounding computation, where `jnp.linalg.solve`/`inv` on tiny batched
systems call a generic batched LU per instance. Used by the
LM stages (3x3, 2x2 normal equations) and the Schur solvers (3x3 landmark
blocks, 2x2 depth blocks).

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp

from .precision import einsum as hp_einsum


def inv2(A, eps=0.0):
    """(..., 2, 2) inverse via adjugate; eps regularizes the determinant."""
    a = A[..., 0, 0]
    b = A[..., 0, 1]
    c = A[..., 1, 0]
    d = A[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det) if eps else det
    inv_det = 1.0 / det
    row0 = jnp.stack([d, -b], axis=-1)
    row1 = jnp.stack([-c, a], axis=-1)
    return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]


def solve2(A, b):
    """Solve (..., 2, 2) x = (..., 2) by Cramer's rule."""
    a00 = A[..., 0, 0]
    a01 = A[..., 0, 1]
    a10 = A[..., 1, 0]
    a11 = A[..., 1, 1]
    det = a00 * a11 - a01 * a10
    inv_det = 1.0 / det
    x0 = (b[..., 0] * a11 - b[..., 1] * a01) * inv_det
    x1 = (a00 * b[..., 1] - a10 * b[..., 0]) * inv_det
    return jnp.stack([x0, x1], axis=-1)


def _cofactor3(A):
    """Cofactor matrix (transpose of adjugate) of (..., 3, 3)."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    return jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )


def det3(A):
    a = A
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def inv3(A):
    """(..., 3, 3) inverse via adjugate."""
    cof = _cofactor3(A)
    det = det3(A)
    adj = jnp.swapaxes(cof, -1, -2)
    return adj / det[..., None, None]


def solve3(A, b):
    """Solve (..., 3, 3) x = (..., 3) via adjugate."""
    cof = _cofactor3(A)
    det = det3(A)
    # x = adj(A) b / det; adj = cof^T  =>  x_i = sum_j cof[j, i] b_j
    return hp_einsum("...ji,...j->...i", cof, b) / det[..., None]


def cholesky_unrolled(A):
    """Cholesky of a small static-n SPD matrix, fully unrolled.

    Elementwise-fused (no LAPACK-style batched factorization call).
    A: (..., n, n), n <= ~12.
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s2 = A[..., i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv_d
    rows = [
        jnp.stack(
            [L[i][j] if j <= i else jnp.zeros_like(L[i][i]) for j in range(n)],
            axis=-1,
        )
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def cholesky_solve_unrolled(L, b):
    """Solve L L^T x = b with unrolled forward/back substitution.

    L: (..., n, n) lower-triangular; b: (..., n)."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)


def smallest_eigvec_psd(A, iters: int = 3, shift_scale: float = 1e-6):
    """Unit eigenvector of the smallest eigenvalue of a small PSD matrix.

    Inverse iteration with a trace-scaled shift, Cholesky-unrolled. For the
    8-point normal matrices (rank <= 8 in exact arithmetic: the null
    eigenvalue is ~0 while lambda_{n-1} is O(N)), the convergence ratio
    (lambda_n + eps) / (lambda_{n-1} + eps) is tiny — 2-3 iterations beat
    batched jnp.linalg.eigh in both speed and null-vector accuracy.
    """
    n = A.shape[-1]
    tr = jnp.trace(A, axis1=-2, axis2=-1)
    eps = shift_scale * jnp.maximum(tr, 1e-30) / n
    L = cholesky_unrolled(A + eps[..., None, None] * jnp.eye(n, dtype=A.dtype))
    v = jnp.ones(A.shape[:-2] + (n,), A.dtype) / jnp.sqrt(jnp.asarray(n, A.dtype))
    for _ in range(iters):
        v = cholesky_solve_unrolled(L, v)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    return v


def solve_psd(A, b):
    """Solve a small (n <= ~64) symmetric positive-definite system via
    explicit Cholesky (jnp.linalg.cholesky + triangular solves) — faster
    and more stable than generic LU for the reduced camera systems."""
    L = jnp.linalg.cholesky(A)
    import jax

    y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )
