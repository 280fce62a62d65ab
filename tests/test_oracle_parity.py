"""End-to-end compat-pipeline vs f64-oracle pose parity (BASELINE.md
target #1: "match reference recovered pose within ATE bound").

Feeds N synthetic two-view problems through BOTH
  * the JAX compat pipeline (consensus initial guess + 3-stage BCD,
    models/twoview.adjust_from_matches with reference_compat=True), and
  * the native f64 oracle (csrc/sba_native.cpp), which independently
    implements the reference's exact algorithm
    (spherical_bundle_adjuster.cpp:47-217),
on the identical matched bearings, and bounds the recovered-pose delta.

Two regimes are asserted (bounds measured, see PARITY.md "End-to-end"):

1. same-init: oracle BCD seeded with the pipeline's own consensus init.
   This isolates the full refinement chain (depth/rot/tran stages incl.
   the first-two-depths and negated-Euler quirks) — measured max 0.15 deg
   over 12 pairs; asserted < 0.5.
2. fully-independent: oracle 8-point (full match set) + oracle BCD.
   The RANSAC subsampling can't bit-match the reference's unseeded
   std::random_shuffle, and compat-mode BCD has shallow basins whose
   choice is init-sensitive (same-init agreement plus multi-degree
   full-pipeline deltas on the same pair proves the basins, not the
   stages, differ) — so the MEDIAN delta is asserted (< 0.5 deg;
   measured 0.05), and the max is only sanity-bounded.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spherical_ba.core import rotation
from spherical_ba.models.twoview import adjust_from_matches
from spherical_ba.utils import native
from spherical_ba.utils.config import PipelineConfig

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)

N_PAIRS = 12
CAP = 128


def geodesic_deg(R1, R2):
    return np.degrees(np.arccos(np.clip((np.trace(R1.T @ R2) - 1) / 2, -1, 1)))


def make_pair(rng):
    """Bench-scale problem: eulers in +-5 deg (the bench's accuracy regime,
    bench.py make_batch_gt), random translation, depths 2-6."""
    n = int(rng.integers(48, 120))
    euler = rng.uniform(-0.09, 0.09, 3)
    t = rng.uniform(-0.3, 0.3, 3)
    b1 = rng.normal(size=(n, 3))
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    d1 = rng.uniform(2, 6, n)
    R = np.asarray(rotation.euler_to_matrix(jnp.asarray(euler)), np.float64)
    x2 = (R @ (b1 * d1[:, None]).T).T - t
    b2 = x2 / np.linalg.norm(x2, axis=-1, keepdims=True)
    pad = CAP - n
    b1p = jnp.asarray(np.pad(b1, ((0, pad), (0, 0))), jnp.float32)
    b2p = jnp.asarray(np.pad(b2, ((0, pad), (0, 0))), jnp.float32)
    valid = jnp.asarray(np.arange(CAP) < n)
    return b1, b2, b1p, b2p, valid, n


def _cheirality_np(b1, b2, euler, t):
    """Numpy transcription of epipolar.resolve_translation_sign: flip t if
    the midpoint-triangulated depth sign vote under X2 = R X1 - t is
    negative."""
    Rm = np.asarray(rotation.euler_to_matrix(jnp.asarray(euler)), np.float64).T
    a = b1 @ Rm.T
    c = b2
    s = np.sum(a * c, axis=-1)
    at = a @ t
    ct = c @ t
    den = np.maximum(1.0 - s * s, 1e-6)
    d1 = (at - s * ct) / den
    d2 = (s * at - ct) / den
    vote = np.sum(np.sign(d1) + np.sign(d2))
    return -t if vote < 0 else t


def run_both(seed=7):
    rng = np.random.default_rng(seed)
    cfg = PipelineConfig()  # reference_compat=True default
    same_init, independent = [], []
    for i in range(N_PAIRS):
        b1, b2, b1p, b2p, valid, n = make_pair(rng)
        r_jax, t_jax, _, guess, _tel = adjust_from_matches(
            b1p, b2p, valid, jax.random.PRNGKey(i), cfg
        )
        assert bool(guess.ok)
        R_jax = np.asarray(rotation.angle_axis_to_matrix(r_jax))

        # regime 1: oracle BCD from the pipeline's own consensus init
        e0 = np.asarray(guess.euler, np.float64)
        t0 = np.asarray(guess.translation, np.float64)
        rot_o, _, _ = native.oracle_bcd(
            b1, b2, -e0, t0, np.ones((n, 2)), compat=True
        )
        R_o = np.asarray(rotation.angle_axis_to_matrix(jnp.asarray(rot_o)))
        same_init.append(geodesic_deg(R_jax, R_o))

        # regime 2: fully-independent oracle pipeline (full-set 8-point,
        # both valid twisted-pair branches; best-branch delta). The
        # oracle's t = U[:, 2] sign is the same coin flip the pipeline
        # resolves by cheirality (epipolar.resolve_translation_sign) — tie
        # it down the same way so regime 2 compares basins, not coin flips.
        e1, e2, t_o, v1, v2 = native.oracle_eight_point(b1, b2)
        best = np.inf
        for e, v in ((e1, v1), (e2, v2)):
            if not v:
                continue
            t_b = _cheirality_np(b1, b2, e, t_o)
            ro, _, _ = native.oracle_bcd(
                b1, b2, -e, t_b, np.ones((n, 2)), compat=True
            )
            R_ob = np.asarray(rotation.angle_axis_to_matrix(jnp.asarray(ro)))
            best = min(best, geodesic_deg(R_jax, R_ob))
        independent.append(best)
    return np.asarray(same_init), np.asarray(independent)


class TestEndToEndOracleParity:
    def test_pose_parity_bounds(self):
        same_init, independent = run_both()
        # refinement-chain parity from identical init: tight everywhere
        assert same_init.max() < 0.5, same_init
        # full-pipeline parity: median-tight (init basins are the only
        # divergence mechanism; see module docstring)
        assert float(np.median(independent)) < 0.5, independent
        assert independent.max() < 20.0, independent
