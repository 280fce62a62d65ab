"""Sequence pipeline: multi-keyframe spherical SfM over an ordered list of
ERP frames — the capstone composition the reference stops short of
(it is two-view only; BASELINE.json configs #3-#5).

Stages:
  1. pairwise odometry — two-view BA between consecutive frames (vmapped
     over the whole sequence at once: frames[:-1] vs frames[1:]);
  2. optional loop closures — two-view BA between given (i, j) pairs;
  3. pose graph — chain odometry + closures, damped GN (solver.pose_graph);
  4. global refinement — triangulate matched pairs into landmarks and run
     the multi-keyframe Schur BA (models.multiview), optionally sharded
     over a device mesh (parallel.dist_ba).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rotation, sphere
from ..solver import pose_graph as pg
from ..utils.config import PipelineConfig
from . import multiview as mv
from . import tracks
from . import twoview


class SequenceResult(NamedTuple):
    poses: jax.Array          # (N, 6) world->camera [angle-axis | t]
    pairwise_rot: jax.Array   # (N-1, 3) odometry rotations (angle-axis)
    pairwise_tran: jax.Array  # (N-1, 3)
    pg_costs: jax.Array       # pose-graph cost trace
    ba_costs: jax.Array       # global BA cost trace (empty if skipped)
    pg_poses: jax.Array       # (N, 6) poses after the pose graph, before
    # global BA (so artifacts can attribute quality per stage)


@partial(jax.jit, static_argnames=("cfg", "frontend"))
def pairwise_odometry(frames, key, cfg: PipelineConfig, frontend: str = "band"):
    """Two-view BA on every consecutive pair, one vmapped batch.

    frames: (N, H, W, C). Returns (rot_aa (N-1, 3), tran (N-1, 3),
    ok (N-1,), results)."""
    keys = jax.random.split(key, frames.shape[0] - 1)
    fn = jax.vmap(partial(twoview.run_two_view, cfg=cfg, frontend=frontend))
    res = fn(frames[:-1], frames[1:], keys)
    return res.rotation_aa, res.translation, res.ok, res


def build_multiview_problem(poses, pair_results, width, height, max_obs_per_track=6):
    """Landmark-major observation table from pairwise matches with
    CROSS-PAIR TRACK MERGING (models.tracks): matches sharing a frame-k
    keypoint chain into one P>=3-observation landmark; assembly is one
    jit, no host loops. pair_results is a batched TwoViewResult."""
    return tracks.build_multiview_problem(
        poses,
        pair_results.left_xy,
        pair_results.right_xy,
        pair_results.match_valid,
        pair_results.rotation_aa,
        pair_results.translation,
        width,
        height,
        max_obs_per_track=max_obs_per_track,
    )


def run_sequence(
    frames,
    key,
    cfg: PipelineConfig = PipelineConfig(),
    frontend: str = "band",
    closures: Sequence[tuple] = (),
    global_ba="auto",
    ba_iters: int = 15,
    mesh=None,
    closure_weight: float = 2.0,
    pg_robust_delta: float = 0.05,
    pg_iters: int = 20,
    pg_tran_weight: float = 0.2,
) -> SequenceResult:
    """Full sequence SfM. frames: (N, H, W, C) stacked ERP frames.

    closures: optional (i, j) index pairs to add as loop-closure edges
    (each solved with an extra two-view BA).

    global_ba: True / False / "auto". The global merged-track Schur BA
    refines poses well when observations carry parallax; on
    ROTATION-DOMINANT sequences (median odometry baseline ~ 0) the
    triangulated landmarks are parallax-free noise and fitting them
    DEGRADES the pose-graph rotations (measured 0.17 -> 0.48 deg ATE at
    n=30, worse at n=100). "auto" (default) runs the BA only when the
    median odometry |t| exceeds min_ba_baseline — the sequence-level
    analog of the two-view rotation-dominant selection
    (BaConfig.rot_dominant_select_deg)."""
    h, w = frames.shape[1], frames.shape[2]
    rot_aa, tran, ok, pair_res = pairwise_odometry(frames, key, cfg, frontend)

    closure_edges = []
    closure_nm = []
    for (i, j) in closures:
        res = twoview.run_two_view(frames[i], frames[j], key, cfg, frontend)
        closure_edges.append((i, j, res.rotation_aa, res.translation))
        closure_nm.append(float(res.num_matches))

    # Information weighting: a two-view edge's rotation
    # std scales ~1/sqrt(matches), so weight each edge by sqrt(match
    # count), normalized so the mean odometry weight stays 1.0 (keeps
    # closure_weight's meaning). A failed solve (ok=False / few matches)
    # degrades toward zero pull instead of biasing its neighborhood.
    nm = np.sqrt(np.maximum(np.asarray(pair_res.num_matches, np.float64), 1.0))
    nm = nm * np.where(np.asarray(ok), 1.0, 0.1)
    norm = max(float(nm.mean()), 1e-6)
    odo_w = (nm / norm).astype(np.float32)
    cw = [
        float(np.sqrt(max(c, 1.0)) / norm) for c in closure_nm
    ]

    g = pg.chain_with_loop_closures(
        rot_aa, tran, closure_edges, closure_weight=closure_weight,
        odometry_weights=odo_w, closure_weights=cw,
    )
    # tran_weight < 1: the rotation rows carry the information on ERP
    # sequences (edge translations from near-pure-rotation two-view are
    # noise whose residuals would otherwise dominate the cost ~100:1 and
    # leave the rotation part inert)
    g_opt, pg_costs = pg.optimize_pose_graph(
        g, num_iters=pg_iters, robust_delta=pg_robust_delta,
        tran_weight=pg_tran_weight,
    )

    ba_costs = jnp.zeros((0,))
    poses = g_opt.poses
    min_ba_baseline = 0.1
    if global_ba == "auto":
        med_t = float(np.median(np.linalg.norm(np.asarray(tran), axis=-1)))
        global_ba = med_t >= min_ba_baseline
    if global_ba:
        prob = build_multiview_problem(poses, pair_res, w, h)
        if mesh is not None:
            from ..parallel import dist_ba

            prob, ba_costs = dist_ba.solve_multiview_sharded(
                prob, mesh, num_iters=ba_iters
            )
        else:
            prob, ba_costs = mv.solve_multiview(prob, num_iters=ba_iters)
        poses = prob.poses

    return SequenceResult(
        poses=poses,
        pairwise_rot=rot_aa,
        pairwise_tran=tran,
        pg_costs=pg_costs,
        ba_costs=ba_costs,
        pg_poses=g_opt.poses,
    )
