"""Direct unit tests for the closed-form small-matrix kernels (ADVICE r1:
cholesky_unrolled / cholesky_solve_unrolled / smallest_eigvec_psd are
load-bearing for every RANSAC trial and were only covered indirectly)."""

import numpy as np
import jax.numpy as jnp

from spherical_ba.core import smallmat


def random_spd(rng, n, batch=(), scale=1.0):
    a = rng.normal(size=batch + (n, n))
    return np.einsum("...ij,...kj->...ik", a, a) * scale + 1e-3 * np.eye(n)


class TestInvSolve:
    def test_inv2_matches_numpy(self):
        rng = np.random.default_rng(0)
        A = random_spd(rng, 2, (32,))
        out = np.asarray(smallmat.inv2(jnp.asarray(A, jnp.float32)))
        np.testing.assert_allclose(out, np.linalg.inv(A), rtol=2e-4, atol=2e-5)

    def test_solve2_solve3_match_numpy(self):
        rng = np.random.default_rng(1)
        for n, solve in ((2, smallmat.solve2), (3, smallmat.solve3)):
            A = random_spd(rng, n, (16,))
            b = rng.normal(size=(16, n))
            out = np.asarray(solve(jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32)))
            np.testing.assert_allclose(
                out, np.linalg.solve(A, b[..., None])[..., 0], rtol=2e-4, atol=2e-4
            )

    def test_inv3_matches_numpy(self):
        rng = np.random.default_rng(2)
        A = random_spd(rng, 3, (16,))
        out = np.asarray(smallmat.inv3(jnp.asarray(A, jnp.float32)))
        np.testing.assert_allclose(out, np.linalg.inv(A), rtol=2e-4, atol=2e-4)


class TestCholesky:
    def test_cholesky_unrolled_matches_jnp(self):
        rng = np.random.default_rng(3)
        for n in (3, 6, 9, 12):
            A = random_spd(rng, n, (8,))
            L = np.asarray(smallmat.cholesky_unrolled(jnp.asarray(A, jnp.float32)))
            L_ref = np.linalg.cholesky(A)
            np.testing.assert_allclose(L, L_ref, rtol=3e-4, atol=3e-4)

    def test_cholesky_solve_unrolled(self):
        rng = np.random.default_rng(4)
        A = random_spd(rng, 9, (8,))
        b = rng.normal(size=(8, 9))
        L = smallmat.cholesky_unrolled(jnp.asarray(A, jnp.float32))
        x = np.asarray(smallmat.cholesky_solve_unrolled(L, jnp.asarray(b, jnp.float32)))
        np.testing.assert_allclose(
            x, np.linalg.solve(A, b[..., None])[..., 0], rtol=1e-3, atol=1e-3
        )


class TestSmallestEigvec:
    def test_random_spd_9x9(self):
        """Rayleigh-quotient check: the returned vector's energy must sit at
        the bottom of the spectrum. (Exact eigenvector alignment is only
        guaranteed given a spectral gap — for near-degenerate bottom pairs
        any bottom-subspace vector is equally good for the 8-point use.)"""
        rng = np.random.default_rng(5)
        A = random_spd(rng, 9, (16,))
        v = np.asarray(smallmat.smallest_eigvec_psd(jnp.asarray(A, jnp.float32)))
        w, V = np.linalg.eigh(A)
        rq = np.einsum("bi,bij,bj->b", v, A, v)
        # within the bottom-two eigenvalue band (plus f32 slack)
        assert np.all(rq <= w[:, 1] + 1e-3 * w[:, -1]), (
            f"rayleigh {rq} vs spectrum bottom {w[:, :2]}"
        )
        # and when the bottom gap is clear, the actual eigenvector is found
        gap = (w[:, 1] - w[:, 0]) / w[:, -1] > 0.05
        dots = np.abs(np.einsum("bi,bi->b", v, V[..., :, 0]))
        assert np.all(dots[gap] > 1 - 1e-3), f"min |<v, v_ref>| = {dots[gap].min()}"

    def test_rank_deficient_9x9(self):
        """The 8-point case: rank-8 normal matrices with an exact null
        vector — inverse iteration must recover it to high accuracy."""
        rng = np.random.default_rng(6)
        for _ in range(8):
            B = rng.normal(size=(8, 9))
            A = B.T @ B  # rank 8, exact null space dim 1
            v = np.asarray(
                smallmat.smallest_eigvec_psd(jnp.asarray(A, jnp.float32))
            )
            # residual in the null direction: A v should be ~0
            r = np.linalg.norm(A @ v) / np.linalg.norm(A)
            assert r < 1e-5, f"null-vector residual {r}"
