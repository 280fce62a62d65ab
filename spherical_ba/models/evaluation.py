"""Front-end evaluation harness — the counterpart of
test/feature_test.cpp (C15): score matched keypoints against a known
ground-truth rotation.

Metrics per front-end (test/feature_test.cpp:102-121):
  * match count, outlier count / % at an angular threshold (2 deg default)
  * 10%-trimmed mean angular error
  * total keypoints

A match is an inlier iff angle(R_gt @ b_left, b_right) <= threshold
(get_diff, test/feature_test.cpp:36-62).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import sphere
from ..core.precision import matmul as hp_matmul
from ..utils.config import PipelineConfig
from .frontend import FrontendResult


class EvalMetrics(NamedTuple):
    num_matches: jax.Array
    num_outliers: jax.Array
    outlier_pct: jax.Array
    trimmed_mean_err_rad: jax.Array
    total_keypoints: jax.Array


@partial(jax.jit, static_argnames=("cfg", "width", "height"))
def evaluate_matches(
    fr: FrontendResult,
    R_gt,
    width: int,
    height: int,
    cfg: PipelineConfig = PipelineConfig(),
) -> EvalMetrics:
    b_l = sphere.pixel_to_bearing(fr.left_xy, width, height)
    b_r = sphere.pixel_to_bearing(fr.right_xy, width, height)
    b_l_rot = hp_matmul(b_l, R_gt.T.astype(b_l.dtype))
    diff = sphere.angular_distance(b_l_rot, b_r)  # (M,)

    valid = fr.match_valid
    n = jnp.sum(valid.astype(jnp.int32))
    big = jnp.asarray(jnp.inf, diff.dtype)
    diff_m = jnp.where(valid, diff, big)

    outliers = jnp.sum((diff_m > cfg.eval_inlier_thresh_rad) & valid)
    pct = jnp.where(n > 0, outliers.astype(jnp.float32) * 100.0 / n, 0.0)

    # 10%-trimmed mean over the valid diffs (feature_test.cpp:102-105):
    # drop floor(0.1*n) from each end of the sorted valid values.
    sorted_d = jnp.sort(diff_m)
    rank = jnp.arange(diff.shape[0])
    ten = jnp.floor(0.1 * n.astype(jnp.float32)).astype(jnp.int32)
    keep = (rank >= ten) & (rank < n - ten)
    kept = jnp.where(keep & jnp.isfinite(sorted_d), sorted_d, 0.0)
    denom = jnp.maximum(jnp.sum(keep), 1).astype(jnp.float32)
    tmean = jnp.sum(kept) / denom

    return EvalMetrics(
        num_matches=n,
        num_outliers=outliers,
        outlier_pct=pct,
        trimmed_mean_err_rad=tmean,
        total_keypoints=fr.total_keypoints,
    )


def compare_frontends(im_left, im_right, R_gt, cfg: PipelineConfig = PipelineConfig()):
    """A/B/C comparison of all three front-ends on one GT pair — the
    feature_test main flow (test/feature_test.cpp:174-211)."""
    from .frontend import FRONTENDS

    h, w = im_left.shape[0], im_left.shape[1]
    out = {}
    for name, fn in FRONTENDS.items():
        fr = fn(im_left, im_right, cfg)
        out[name] = evaluate_matches(fr, R_gt, w, h, cfg)
    return out


def angle_axis_to_matrix_host(aa):
    """(..., 3) angle-axis -> (..., 3, 3) rotation, float64 on the host."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa, axis=-1, keepdims=True)
    k = aa / np.maximum(th, 1e-30)
    K = np.zeros(aa.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s = np.sin(th)[..., None]
    c = (1.0 - np.cos(th))[..., None]
    return np.eye(3) + s * K + c * (K @ K)


def geodesic_deg_host(Ra, Rb):
    """Angle (deg) of Ra^T Rb, float64 on the host (no device matmul, so
    no TF32 or arccos noise at small angles)."""
    tr = np.einsum("...ij,...ij->...", np.asarray(Ra, np.float64),
                   np.asarray(Rb, np.float64))
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def pose_errors_host(poses_est, poses_gt):
    """Per-camera (rotation error deg, translation error) of (C, 6)
    [aa | t] poses against ground truth, float64 on the host."""
    pe = np.asarray(poses_est, np.float64)
    pg = np.asarray(poses_gt, np.float64)
    ang = geodesic_deg_host(
        angle_axis_to_matrix_host(pe[:, :3]), angle_axis_to_matrix_host(pg[:, :3])
    )
    terr = np.linalg.norm(pe[:, 3:] - pg[:, 3:], axis=-1)
    return ang, terr
