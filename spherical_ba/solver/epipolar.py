"""Batched essential-matrix estimation and consensus initial guess.

Vectorized re-design of the reference's RANSAC-like loop
(spherical_bundle_adjuster.cpp:47-181): all 80 trials run as ONE vmapped
batch — each trial weights a Gumbel-top-k 25% subsample, builds the 9x9
normal matrix of the epipolar constraints (one contraction), takes the
null eigenvector (batched eigh), rank-2-projects via batched 3x3 SVD, and
decomposes E into (R1, R2, t). The winner is the candidate minimizing the
20-80%-trimmed mean distance to all other candidate Euler vectors — the
reference's mode-finding consensus (:160-178), vectorized.

Constraint convention (spherical_bundle_adjuster.cpp:56-68):
row_i = flatten(outer(b_left_i, b_right_i)), i.e. b_left^T E b_right = 0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rotation, smallmat
from ..core.precision import einsum as hp_einsum, matmul as hp_matmul
from ..utils.config import RansacConfig


class InitialGuess(NamedTuple):
    euler: jax.Array      # (3,) winning rotation as Euler (rx, ry, rz)
    translation: jax.Array  # (3,) unit translation from the winning trial
    num_candidates: jax.Array  # scalar int: valid (R, t) candidates found
    ok: jax.Array         # scalar bool: at least one valid candidate


def essential_from_bearings(b1, b2, weights):
    """Weighted 8-point essential matrix from bearing vectors.

    b1, b2: (N, 3); weights: (N,) {0, 1} subsample mask.
    Returns E (3, 3), rank-2 projected.
    """
    a = (b1[:, :, None] * b2[:, None, :]).reshape(-1, 9)  # (N, 9)
    aw = a * weights[:, None]
    ata = jnp.dot(aw.T, a, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)  # (9, 9)
    # null vector = eigenvector of the smallest eigenvalue (Cholesky
    # inverse iteration — faster and more accurate than batched eigh for
    # the near-rank-8 normal matrix; smallmat.smallest_eigvec_psd)
    e = smallmat.smallest_eigvec_psd(ata).reshape(3, 3)
    # rank-2 projection: zero the smallest singular value
    u, s, vt = jnp.linalg.svd(e, full_matrices=False)
    s2 = s.at[2].set(0.0)
    return hp_matmul(u * s2[None, :], vt)


def decompose_essential(E):
    """E -> (R1, R2, t), the cv::decomposeEssentialMat convention
    (used at spherical_bundle_adjuster.cpp:84-85): SVD with det-corrected
    U/Vt, R1 = U W Vt, R2 = U W^T Vt, t = U[:, 2] (unit norm)."""
    u, _, vt = jnp.linalg.svd(E, full_matrices=True)
    u = jnp.where(jnp.linalg.det(u) < 0, -u, u)
    vt = jnp.where(jnp.linalg.det(vt) < 0, -vt, vt)
    w = jnp.asarray([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    r1 = hp_matmul(hp_matmul(u, w), vt)
    r2 = hp_matmul(hp_matmul(u, w.T), vt)
    t = u[:, 2]
    return r1, r2, t


def _trial_pose(b1, b2, weights):
    """Fused 8-point estimate -> (R1, R2, t) without re-factorizing.

    The rank-2 projection SVD of E and decomposeEssentialMat's SVD factor
    the SAME matrix (the projected E's SVD is (U, diag(s1, s2, 0), Vt) by
    construction), so one SVD serves both — and the 9x9 null vector comes
    from Cholesky inverse iteration instead of a full batched eigh
    (smallmat.smallest_eigvec_psd; 2x faster initial_guess measured).
    """
    a = (b1[:, :, None] * b2[:, None, :]).reshape(-1, 9)
    aw = a * weights[:, None]
    ata = jnp.dot(aw.T, a, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    e = smallmat.smallest_eigvec_psd(ata).reshape(3, 3)
    u, _, vt = jnp.linalg.svd(e, full_matrices=True)
    u = jnp.where(jnp.linalg.det(u) < 0, -u, u)
    vt = jnp.where(jnp.linalg.det(vt) < 0, -vt, vt)
    w = jnp.asarray([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], e.dtype)
    r1 = hp_matmul(hp_matmul(u, w), vt)
    r2 = hp_matmul(hp_matmul(u, w.T), vt)
    return r1, r2, u[:, 2]


def eight_point_trial(b1, b2, weights, max_euler_valid):
    """One 8-point trial -> stacked (2, ...) candidates (R1 and R2 branches).

    Returns euler (2, 3), t (2, 3) (same t for both, as in the reference),
    valid (2,) — |euler|_inf < max_euler_valid (:101-115)."""
    r1, r2, t = _trial_pose(b1, b2, weights)
    e1 = rotation.matrix_to_euler(r1)
    e2 = rotation.matrix_to_euler(r2)
    euler = jnp.stack([e1, e2])
    valid = jnp.max(jnp.abs(euler), axis=-1) < max_euler_valid
    return euler, jnp.stack([t, t]), valid


def consensus_scores(euler, valid, trim_lo: float, trim_hi: float):
    """Trimmed-mean mode-consensus score per candidate (:160-178).

    Per candidate i: sort its Euclidean distances to ALL candidates, trim
    to ranks [floor(trim_lo * n), floor(trim_hi * n)), average. Parity
    note: the reference's inner loop `for j in [0, r_vec_size)` INCLUDES
    j == i, so each candidate's self-distance 0 sits at rank 0 of its
    sorted window; for n < 5, floor(0.2 * n) == 0 and the self-zero
    survives the trim — in the reference too. Replicated exactly; locked
    by tests/test_solver.py::test_consensus_matches_reference_transcription.

    euler: (C, 3) candidate banks (padded); valid: (C,) mask. Returns
    (score (C,) with +inf on invalid slots, n_cand scalar int).
    """
    n_cand = jnp.sum(valid.astype(jnp.int32))
    diff = euler[:, None, :] - euler[None, :, :]
    dist = jnp.linalg.norm(diff, axis=-1)  # (C, C)
    big = jnp.asarray(jnp.inf, dist.dtype)
    dist = jnp.where(valid[None, :], dist, big)
    dist_sorted = jnp.sort(dist, axis=-1)
    rank = jnp.arange(dist.shape[-1])
    lo = jnp.floor(trim_lo * n_cand.astype(jnp.float32)).astype(jnp.int32)
    hi = jnp.floor(trim_hi * n_cand.astype(jnp.float32)).astype(jnp.int32)
    keep = (rank[None, :] >= lo) & (rank[None, :] < hi)
    kept_vals = jnp.where(keep & jnp.isfinite(dist_sorted), dist_sorted, 0.0)
    denom = jnp.maximum(jnp.sum(keep, axis=-1), 1).astype(jnp.float32)
    score = jnp.sum(kept_vals, axis=-1) / denom
    return jnp.where(valid, score, big), n_cand


def candidate_inlier_counts(b_left, b_right, match_valid, eulers, ts, thresh_rad):
    """Epipolar inlier count per candidate — classic RANSAC scoring over
    ALL matches (the data contact the reference's mode-finding consensus
    never makes, spherical_bundle_adjuster.cpp:160-178).

    eulers: (C, 3), ts: (C, 3) candidate banks; returns (C,) int32 counts
    of matches whose angular epipolar residual vs E_c = [t_c]x R_c is
    below thresh_rad. One fused (C, M) computation — C*M ~ 160*512 is VPU
    noise."""
    R = jax.vmap(rotation.euler_to_matrix)(eulers)  # (C, 3, 3)
    zeros = jnp.zeros_like(ts[:, 0])
    tx = jnp.stack(
        [
            jnp.stack([zeros, -ts[:, 2], ts[:, 1]], -1),
            jnp.stack([ts[:, 2], zeros, -ts[:, 0]], -1),
            jnp.stack([-ts[:, 1], ts[:, 0], zeros], -1),
        ],
        -2,
    )  # (C, 3, 3)
    E = hp_einsum("cij,cjk->cik", tx, R)
    n = hp_einsum("cik,mk->cmi", E, b_right)  # (C, M, 3)
    n_norm = jnp.linalg.norm(n, axis=-1)
    sin_res = jnp.abs(hp_einsum("mi,cmi->cm", b_left, n)) / jnp.maximum(
        n_norm, 1e-12
    )
    ok = (sin_res <= jnp.sin(thresh_rad)) & match_valid[None, :]
    return jnp.sum(ok.astype(jnp.int32), axis=-1)


def resolve_translation_sign(b_left, b_right, match_valid, euler, t):
    """Cheirality vote: return t or -t, whichever makes the triangulated
    match depths mostly positive.

    The essential matrix's null vector (and hence decomposeEssentialMat's
    t = U[:, 2]) carries an arbitrary sign that depends on which matches a
    RANSAC trial sampled; the reference feeds that coin-flip t straight to
    Ceres (spherical_bundle_adjuster.cpp:179-180, :331), and with the
    wrong sign the d >= 0 barrier fights the geometry and the BCD lands
    degrees off. Resolved here by the standard cheirality test: midpoint-
    triangulate each match under the model X2 = R X1 - t (the consensus
    euler's rotation) and flip t when the depth sign vote is negative.
    Near-pure rotation (t ~ 0) the vote is weak but the sign is then
    irrelevant.
    """
    Rm = rotation.euler_to_matrix(euler).T  # model rotation (R^T recovery)
    a = hp_einsum("ij,mj->mi", Rm, b_left)  # rotated left bearings
    c = b_right
    s = jnp.sum(a * c, axis=-1)
    at = hp_einsum("mi,i->m", a, t)
    ct = hp_einsum("mi,i->m", c, t)
    den = jnp.maximum(1.0 - s * s, 1e-6)
    d1 = (at - s * ct) / den
    d2 = (s * at - ct) / den
    vote = jnp.sum(jnp.where(match_valid, jnp.sign(d1) + jnp.sign(d2), 0.0))
    return jnp.where(vote < 0, -t, t)


def kabsch_rotation_hypothesis(b_left, b_right, match_valid, n_irls: int = 2):
    """Rotation-only pose hypothesis: weighted bearing Procrustes/Kabsch.

    The 8-point essential matrix degenerates on (near-)pure-rotation pairs
    — E = [t]x R -> 0 as |t| -> 0, so every trial's null vector is noise
    and the consensus candidates scatter (QUALITY.md pitch-60 tail;
    the reference has no rotation-only model at all,
    spherical_bundle_adjuster.cpp:118-181). This closed-form hypothesis
    solves argmax_R sum_i w_i b_right_i . (R b_left_i) — the orthogonal
    Procrustes problem over the matched bearings — with a few Cauchy-IRLS
    reweighting rounds for outlier robustness, and pairs it with the
    cheirality-free t = 0 translation. It competes with the essential-
    matrix candidates in multi-start refinement (initial_guess_topk);
    on rotation-dominant scenes it is exact where 8-point is degenerate,
    and on translation-rich scenes its start simply loses the residual
    vote.

    Returns (euler (3,), ok): euler in the candidate-bank convention
    (the matrix_to_euler of R^{-1} — candidates represent the INVERSE of
    the model rotation, matching the 8-point decomposition which recovers
    R^T; see _solve_from_init's init notes).
    """

    def fit(w):
        # C = sum_i w_i b_r b_l^T; R* = U diag(1, 1, det(U V^T)) V^T
        c = hp_einsum("m,mi,mj->ij", w, b_right, b_left)
        u, _, vt = jnp.linalg.svd(c)
        d = jnp.sign(jnp.linalg.det(u) * jnp.linalg.det(vt))
        return hp_matmul(u * jnp.stack([1.0, 1.0, d])[None, :], vt)

    w = match_valid.astype(jnp.float32)
    for _ in range(n_irls):
        R = fit(w)
        rb = hp_einsum("ij,mj->mi", R, b_left)
        cosang = jnp.clip(jnp.sum(rb * b_right, axis=-1), -1.0, 1.0)
        ang = jnp.arccos(cosang)
        med = masked_median(ang, match_valid)
        scale = jnp.maximum(1.5 * med, jnp.deg2rad(0.05))
        w = match_valid.astype(jnp.float32) / (1.0 + (ang / scale) ** 2)
    R = fit(w)
    euler = rotation.matrix_to_euler(R.T)
    ok = jnp.sum(match_valid.astype(jnp.int32)) >= 3
    return euler, ok


def masked_median(x, valid):
    """Median of x over valid slots (static shapes: inf-padded sort)."""
    n = jnp.sum(valid.astype(jnp.int32))
    xs = jnp.sort(jnp.where(valid, x, jnp.inf))
    mid = jnp.clip((n - 1) // 2, 0, x.shape[0] - 1)
    return xs[mid]


def residual_inlier_mask(
    residual, match_valid, thresh_rad: float, k_med: float = 3.0,
    min_keep: int = 9,
):
    """Adaptive residual gate: keep matches with residual below
    max(thresh_rad, k_med * median(residual over valid)).

    The median term adapts to the quality of the pose estimate the
    residuals were computed against (inlier residuals scale with pose
    error, and the median is robust to <50% outliers); the fixed floor
    stops an excellent estimate from rejecting matches over noise. If
    fewer than `min_keep` matches survive, the original mask is returned
    unchanged (a degenerate gate must not starve the solver)."""
    med = masked_median(residual, match_valid)
    thr = jnp.maximum(jnp.asarray(thresh_rad, residual.dtype), k_med * med)
    gated = match_valid & (residual <= thr)
    enough = jnp.sum(gated.astype(jnp.int32)) >= min_keep
    return jnp.where(enough, gated, match_valid)


def epipolar_inlier_mask(
    b_left, b_right, match_valid, euler, translation,
    thresh_rad: float, k_med: float = 3.0, min_keep: int = 9,
):
    """Match mask gated by the consensus winner's epipolar residuals.

    The reference scores RANSAC candidates but feeds ALL matches to the
    solver (spherical_bundle_adjuster.cpp:118-181 discards the inlier
    information); unrejected gross outliers are what limits its pose
    accuracy. This gate reconstructs the winner's essential matrix
    E = [t]x R (the cv::decomposeEssentialMat convention the candidates
    came from, so b_left^T E b_right ~ 0 for inliers by construction) and
    drops matches whose angular epipolar residual
        asin(|b_l . n| / |n|),  n = E b_r
    exceeds the adaptive threshold (see residual_inlier_mask — the
    consensus winner is a noisy 25%-subsample 8-point estimate, so inlier
    residuals scale with its own error). Matches near the epipole
    (|n| ~ 0) get residual 0 — their plane is undefined, not violated.
    """
    R = rotation.euler_to_matrix(euler)
    tx = jnp.asarray(
        [
            [0.0, -translation[2], translation[1]],
            [translation[2], 0.0, -translation[0]],
            [-translation[1], translation[0], 0.0],
        ],
        b_left.dtype,
    )
    E = hp_matmul(tx, R)
    n = hp_einsum("ij,mj->mi", E, b_right)  # epipolar plane normal per match
    n_norm = jnp.linalg.norm(n, axis=-1)
    sin_res = jnp.abs(jnp.sum(b_left * n, axis=-1)) / jnp.maximum(n_norm, 1e-12)
    sin_res = jnp.where(n_norm < 1e-6, 0.0, sin_res)
    ang = jnp.arcsin(jnp.clip(sin_res, 0.0, 1.0))
    return residual_inlier_mask(ang, match_valid, thresh_rad, k_med, min_keep)


def ransac_trials(b_left, b_right, match_valid, key, cfg: RansacConfig):
    """All RANSAC trials as ONE vmapped batch -> flat candidate banks.

    Subsample semantics match the reference (spherical_bundle_adjuster.cpp
    :130-143): each trial draws `floor(valid_count * sample_fraction)`
    distinct VALID matches uniformly at random (fresh shuffle per trial).
    `valid_count` is the dynamic number of valid matches — NOT the static
    match capacity (the round-3 bug: with valid << capacity every trial
    selected the full valid set and all 80 trials were identical). A floor
    of 9 samples keeps the 8-point system over-determined when the valid
    count is small.

    Returns (euler (2T, 3), t (2T, 3), valid (2T,)) — the R1/R2 branches of
    each trial flattened into one candidate bank.
    """
    m = b_left.shape[0]
    v = jnp.sum(match_valid.astype(jnp.int32))
    n_sample = (v.astype(jnp.float32) * cfg.sample_fraction).astype(jnp.int32)
    n_sample = jnp.minimum(jnp.maximum(n_sample, 9), v)
    keys = jax.random.split(key, cfg.num_trials)

    def one_trial(k):
        # Gumbel order statistics = uniform sample of n_sample distinct
        # valid indices; n_sample is dynamic, so select by thresholding at
        # the n_sample-th largest score instead of lax.top_k (ties have
        # measure zero for continuous Gumbel noise).
        g = jax.random.gumbel(k, (m,))
        g = jnp.where(match_valid, g, -jnp.inf)
        thr = jnp.sort(g)[m - jnp.clip(n_sample, 1, m)]
        w = ((g >= thr) & match_valid).astype(jnp.float32)
        return eight_point_trial(b_left, b_right, w, cfg.max_euler_valid)

    euler, t, valid = jax.vmap(one_trial)(keys)  # (T, 2, 3) x2, (T, 2)
    euler = euler.reshape(-1, 3)
    t = t.reshape(-1, 3)
    valid = valid.reshape(-1)
    # With fewer than 9 valid matches the trials are degenerate rank-wise;
    # guard by also requiring enough matches overall.
    valid = valid & (v >= 9)
    return euler, t, valid


@partial(jax.jit, static_argnames=("cfg",))
def initial_guess(
    b_left, b_right, match_valid, key, cfg: RansacConfig = RansacConfig()
) -> InitialGuess:
    """Consensus relative-pose initial guess over all matches.

    b_left/b_right: (M, 3) bearing banks (padded); match_valid: (M,) mask.
    key: jax PRNG key (the reference's unseeded-but-deterministic shuffle,
    random_array at spherical_bundle_adjuster.hpp:182-211, becomes an
    explicit key for reproducibility under vmap/pjit).
    """
    euler, t, valid = ransac_trials(b_left, b_right, match_valid, key, cfg)
    score, n_cand = consensus_scores(euler, valid, cfg.trim_lo, cfg.trim_hi)
    if cfg.scoring == "inlier_count":
        counts = candidate_inlier_counts(
            b_left, b_right, match_valid, euler, t,
            jnp.deg2rad(cfg.inlier_thresh_deg),
        )
        counts = jnp.where(valid, counts, -1)
        # primary: most epipolar inliers; tie-break: the trimmed-mode score
        # (scaled into (0, 1) so it never outranks one inlier). Caveat:
        # epipolar counts don't punish rotation error about the candidate's
        # own t axis, and the twisted pair shares E exactly — on rotation-
        # dominant scenes prefer multi_start (BaConfig) over this scoring.
        tie = jnp.clip(score / (jnp.max(jnp.where(valid, score, 0.0)) + 1e-6), 0.0, 1.0)
        tie = jnp.where(jnp.isfinite(tie), tie, 1.0)
        win = jnp.argmax(counts.astype(jnp.float32) - 0.5 * tie)
    else:
        win = jnp.argmin(score)
    ok = n_cand > 0
    e_win = euler[win]
    t_win = t[win]
    if cfg.cheirality:
        t_win = resolve_translation_sign(
            b_left, b_right, match_valid, e_win, t_win
        )
    return InitialGuess(
        euler=jnp.where(ok, e_win, jnp.zeros(3)),
        translation=jnp.where(ok, t_win, jnp.asarray([1.0, 0.0, 0.0])),
        num_candidates=n_cand,
        ok=ok,
    )


@partial(jax.jit, static_argnames=("cfg", "k"))
def initial_guess_topk(
    b_left, b_right, match_valid, key, cfg: RansacConfig = RansacConfig(),
    k: int = 4,
):
    """Top-k consensus candidates (ascending trimmed-mode score) for
    multi-start refinement: the BCD/joint solvers are local and the
    mode-consensus winner occasionally sits degrees off in a wrong basin
    (PARITY.md "End-to-end"); refining from k candidates and selecting by
    robust final residual removes that failure mode.

    With cfg.rotation_hypothesis (default True), the LAST start slot is
    the closed-form rotation-only Kabsch hypothesis (t = 0) instead of the
    k-th consensus candidate — the 8-point model is degenerate on
    (near-)pure-rotation pairs, and a guaranteed rotation-only start
    closes that basin (kabsch_rotation_hypothesis).

    Returns (eulers (k, 3), translations (k, 3), ok) — invalid slots are
    filled with the best candidate (or identity when none exists)."""
    euler, t, valid = ransac_trials(b_left, b_right, match_valid, key, cfg)
    score, n_cand = consensus_scores(euler, valid, cfg.trim_lo, cfg.trim_hi)
    _, order = jax.lax.top_k(-score, k)  # k smallest scores
    ok = n_cand > 0
    slot_ok = jnp.arange(k) < n_cand  # per-slot validity
    best = order[0]
    idx = jnp.where(slot_ok, order, best)
    e_sel = euler[idx]
    t_sel = t[idx]
    if cfg.cheirality:
        t_sel = jax.vmap(
            lambda e, tt: resolve_translation_sign(
                b_left, b_right, match_valid, e, tt
            )
        )(e_sel, t_sel)
    e_k = jnp.where(ok, e_sel, jnp.zeros((k, 3)))
    t_k = jnp.where(ok, t_sel, jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (k, 3)))
    if cfg.rotation_hypothesis and k >= 2:
        e_rot, rot_ok = kabsch_rotation_hypothesis(b_left, b_right, match_valid)
        # the hypothesis needs no consensus candidate to be usable: when it
        # is valid it rescues even the no-candidate case (pure rotation can
        # leave every 8-point trial invalid)
        e_k = e_k.at[k - 1].set(jnp.where(rot_ok, e_rot, e_k[k - 1]))
        t_k = t_k.at[k - 1].set(
            jnp.where(rot_ok, jnp.zeros(3), t_k[k - 1])
        )
        ok = ok | rot_ok
    return e_k, t_k, ok
