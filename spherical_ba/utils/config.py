"""Typed configuration exposing every constant the reference hard-codes
(SURVEY.md §5 'Config/flag system' enumerates each with file:line).

Frozen dataclasses so configs are hashable -> usable as jit static args.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SurfConfig:
    """SURF detector/descriptor (reference: OpenCV defaults at
    feature_matcher.cpp:13-15)."""

    hessian_threshold: float = 100.0
    n_octaves: int = 4
    n_octave_layers: int = 3
    max_keypoints: int = 512      # static per-image keypoint capacity
    upright: bool = False         # True skips orientation assignment (U-SURF)
    descriptor_dim: int = 64
    subpixel_refine: bool = True
    descriptor_interp: str = "nearest"  # "nearest" (OpenCV-style) | "bilinear"
    # Laplacian-sign strategy: "dense" (per-layer dense trace-sign maps,
    # one gather per keypoint — OpenCV-faithful detection-layer
    # quantization) or "gather" (24 corner reads per keypoint at the
    # refined size; the A/B reference path).
    laplacian_mode: str = "dense"


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching (reference: FLANN kNN k=2 + Lowe ratio 0.3,
    feature_matcher.cpp:42-59). We use exact brute-force top-2 via one
    matmul — strictly better recall than FLANN's approximate KD-tree."""

    ratio_thresh: float = 0.3
    max_matches: int = 512        # static match capacity
    mutual_check: bool = False    # reference matches one-way only


# Denser 22.5-deg band ladder: fixes the intermediate-pitch match cliff of
# the reference's 45-deg ladder (QUALITY.md; at GT pitch 30 deg the two
# views land between the reference's band centers and see differently-
# distorted crops — matches collapse 26.7 -> 4.3. The dense ladder keeps
# every latitude within 11.25 deg of a band center: 23.7 matches, 0.76 deg
# trimmed error at the same ratio 0.5). Costs 2x front-end time (16 bands
# vs 8); select with FrontendConfig(band_pitches_deg=DENSE_BAND_PITCHES).
DENSE_BAND_PITCHES: Tuple[float, ...] = (
    67.5, 45.0, 22.5, 0.0, -22.5, -45.0, -67.5, -90.0
)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Band-rotation front-end (reference spherical_surf.cpp:125-240).

    The default 4-pitch ladder is the reference's (parity + speed); see
    DENSE_BAND_PITCHES for the quality preset that removes the
    intermediate-pitch cliff."""

    band_pitches_deg: Tuple[float, ...] = (45.0, 0.0, -45.0, -90.0)
    # Band geometry: rows [3H/8, 5H/8) of the pitch-rotated sphere
    # (spherical_surf.cpp:131-132). Expressed as fractions of H.
    band_row_start_frac: float = 3.0 / 8.0
    band_height_frac: float = 1.0 / 4.0
    cube_size: int = 600          # cubemap front-end (test/feature_test.cpp:198)
    resample_mode: str = "floor"  # reference parity; "bilinear" for quality
    # Ladder selection (QUALITY.md "pitch cliff": the reference's 45-deg
    # ladder collapses to 4.3 matches / 36.7% outliers when the relative
    # pitch falls between band centers, e.g. GT pitch 30 deg):
    #   "parity" — the reference's 4-pitch ladder (band_pitches_deg);
    #   "dense"  — the 22.5-deg DENSE_BAND_PITCHES ladder (~1.7x frontend
    #              cost, no cliff);
    #   "auto"   — run the parity ladder and fall back to the dense ladder
    #              when it finds fewer than auto_min_matches valid matches.
    #              Single-pair path: lax.cond (dense executes only when
    #              needed; under an outer vmap both branches run — pin a
    #              ladder there). Batched path: run_two_view_batch runs
    #              auto as a host-side two-pass (parity on the batch, dense
    #              re-run only for failed pairs), so the batch default does
    #              NOT pay the vmapped-cond double cost.
    # Default "auto": the data-driven choice — parity speed on equatorial
    # scenes, dense robustness on the cliff (bench.py pitch cells).
    band_ladder: str = "auto"
    auto_min_matches: int = 16


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Consensus initial guess (spherical_bundle_adjuster.cpp:118-181)."""

    num_trials: int = 80          # :130
    sample_fraction: float = 0.25  # :133
    max_euler_valid: float = 1.57  # validity bound, rad (:107,:112)
    trim_lo: float = 0.2          # trimmed-mean consensus window (:174)
    trim_hi: float = 0.8
    seed: int = 0                 # reference PRNG is unseeded-deterministic
    # Candidate scoring: "trimmed_mode" replicates the reference's
    # mode-finding consensus (:160-178 — distance-to-other-candidates, no
    # data contact); "inlier_count" finishes the RANSAC the reference
    # implies: winner = candidate whose essential matrix has the most
    # epipolar inliers among ALL matches (classic RANSAC scoring; immune
    # to the wrong-basin inits that mode-finding picks when candidate
    # clusters are diffuse). Ties fall back to the trimmed-mode score.
    scoring: str = "trimmed_mode"
    inlier_thresh_deg: float = 1.5
    # Resolve the sign of the winning trial's translation by a cheirality
    # (positive-depth) vote. The SVD's t = U[:, 2] sign is an arbitrary
    # function of which matches a trial sampled; the reference feeds that
    # coin-flip t to Ceres unresolved (:179-180, :331) and its pose
    # quality flips with it. True un-breaks the nondeterminism; False
    # reproduces the raw reference behavior.
    cheirality: bool = True
    # Rotation-only Kabsch hypothesis (multi-start only): reserve the last
    # start slot for the closed-form weighted bearing-Procrustes rotation
    # with t = 0. The 8-point essential matrix degenerates as |t| -> 0
    # (E -> 0), which is exactly the large-rotation pitch-60 tail
    # (QUALITY.md); the Procrustes solution is exact there. Competes in
    # multi-start residual selection, so translation-rich scenes are
    # unaffected. Only consulted by initial_guess_topk (corrected mode);
    # the compat single-winner path never sees it (reference parity).
    rotation_hypothesis: bool = True


@dataclasses.dataclass(frozen=True)
class BaConfig:
    """Bundle adjustment solver (spherical_bundle_adjuster.cpp:183-217,
    334-338, 843-1063)."""

    max_iterations: int = 50      # per BCD stage (:336)
    # Ceres Solver::Options::function_tolerance default (the reference
    # leaves it unset): terminate a stage once an accepted step improves
    # cost by less than ftol * cost.
    function_tolerance: float = 1e-6
    huber_delta: float = 1.0      # rot/tran stages (:943,:1000)
    barrier_lambda: float = 1.0   # d-stage depth barrier lambda*exp(-c*d) (:1057)
    barrier_c: float = 1.0        # (:1058)
    d_lower_bound: float = 0.0    # (:1060-1061)
    init_depth: float = 1.0       # init_d = expected_d for all matches (:325)
    # LM damping schedule
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 2.0
    # Reference quirk compat (SURVEY.md C11): rot/tran stages use the first
    # two matches' left depths for EVERY residual (:941-942, :998-999), and
    # the init feeds -euler as angle-axis (:330). Default replicates the
    # reference for pose parity; set False for the corrected formulation.
    reference_compat: bool = True
    # BCD schedule: stages in order; reference runs d -> rot -> tran once.
    bcd_rounds: int = 1
    joint_refine: bool = False    # extra joint (d, r, t) Schur LM polish
    # Pre-BA outlier rejection: gate matches on the consensus winner's
    # epipolar residuals before refinement. The reference scores RANSAC
    # candidates but keeps every match in the solve
    # (spherical_bundle_adjuster.cpp:118-181); this finishes that RANSAC.
    # Off by default for reference parity; the corrected pipeline enables
    # it (gross match outliers dominate its image-level pose error).
    outlier_reject: bool = False
    outlier_thresh_deg: float = 1.5
    outlier_min_keep: int = 9
    # Stage-2 (refined-pose reprojection gate) iterations: each round
    # re-gates on residuals against the latest pose and re-solves; round 2
    # catches outliers that slipped a gate computed from a still-dirty
    # pose. Diminishing returns beyond 2.
    outlier_rounds: int = 2
    # Multi-start (corrected mode only): refine from the top-k consensus
    # candidates in parallel (vmap) and keep the start with the lowest
    # trimmed angular residual over all matches. The BCD/joint solvers are
    # local; a single consensus init occasionally locks a wrong basin
    # degrees off the optimum. 0 disables (single winner, reference flow).
    multi_start: int = 0
    # Rotation-dominant start selection (multi-start only): when the BEST
    # start explains the matches as a pure rotation to within this median
    # angular residual (deg), the scene is rotation-dominant and the
    # winner is chosen by the rotation-only median instead of the full
    # reprojection score. Rationale: with free depths + translation, the
    # full score rewards poses that absorb structured match bias into a
    # phantom translation (measured: a 3-deg-off pose outscoring the true
    # pose 0.25 vs 1.09 on a pure-rotation pitch-60 pair); the rotation-
    # only criterion has no such gauge. On translation-rich scenes no
    # start fits as pure rotation (median >= parallax angle) and the full
    # score decides as before. 0 disables.
    rot_dominant_select_deg: float = 0.75


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    surf: SurfConfig = SurfConfig()
    match: MatchConfig = MatchConfig()
    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BaConfig = BaConfig()
    # Evaluation: inlier threshold 2 deg (test/feature_test.cpp:208) and
    # 10% trim for the mean angular error (:102-105).
    eval_inlier_thresh_rad: float = 2.0 / 180.0 * math.pi
    eval_trim_frac: float = 0.1
    dtype: str = "float32"

    def quality(self) -> "PipelineConfig":
        """Quality preset: the documented mode selection for scenes whose
        relative pitch may fall between the reference's 45-deg band
        centers (QUALITY.md "pitch cliff": at GT pitch 30 deg the parity
        ladder collapses to 4.3 matches / 36.7% outliers; the dense
        22.5-deg ladder keeps every latitude within 11.25 deg of a band
        center). Use when input orientation is unconstrained; the default
        parity ladder is kept for reference-pose parity and runs half the
        bands (`ladder_dense` in bench.py measures both).

        Also switches RANSAC scoring to inlier_count (data-driven winner
        selection) — the quality mode is not bound by compat quirks.
        """
        return dataclasses.replace(
            self,
            frontend=dataclasses.replace(self.frontend, band_ladder="dense"),
            ransac=dataclasses.replace(self.ransac, scoring="inlier_count"),
        )

    def parity(self) -> "PipelineConfig":
        """Reference-parity preset: the reference's own 4-pitch ladder
        with no dense fallback (spherical_surf.cpp:137-153) — ~1.7x
        faster frontend; ships the documented pitch cliff."""
        return dataclasses.replace(
            self,
            frontend=dataclasses.replace(self.frontend, band_ladder="parity"),
        )
