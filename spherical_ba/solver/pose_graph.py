"""Pose-graph optimization over relative-pose constraints (loop closure).

The layer above per-pair BA for long 360 sequences (BASELINE.json config
#4): nodes are keyframe poses (angle-axis r, translation t; camera maps a
world point X to R(r) X - t, matching the BA convention), edges are
measured relative poses from two-view BA plus loop-closure detections.

Edge residual for (i, j) with measurement (R_ij, t_ij):
    rotation:    log(R_ij^T (R_j R_i^T))              (3)
    translation: (t_j_pred - t_ij_world) residual expressed via the pose
                 composition p_j = R_ij p_i - t_ij; using the camera
                 convention, the predicted relative pose of edge (i, j) is
                 R_rel = R_j R_i^T,  t_rel = t_j - R_rel t_i,
    res = [ log(R_ij^T R_rel), t_rel - t_ij ] in R^6, optionally scaled by
    per-edge weights (information).

Solved by damped Gauss-Newton over PER-EDGE 6x6 Jacobian blocks (one
vmapped jacfwd of the 6-residual w.r.t. the two incident poses — O(E)
memory, never the dense (E*6, 6N) stacked Jacobian). The normal equations
are then either:
  * assembled densely with `segment_sum` scatters and Cholesky-solved
    (exact; fine to ~100 nodes), or
  * solved MATRIX-FREE with block-Jacobi PCG (solver.pcg) where H @ x is
    two gathers + two segment-sums per application — O(E + N) memory,
    scales to the 100-1000+ keyframe north star (BASELINE.md) in one jit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rotation, smallmat
from ..core.precision import einsum as hp_einsum
from ..core.precision import matmul as hp_matmul
from . import pcg as pcg_mod


class PoseGraph(NamedTuple):
    poses: jax.Array      # (N, 6) [angle-axis | translation]
    edge_i: jax.Array     # (E,) int32 source node
    edge_j: jax.Array     # (E,) int32 target node
    edge_rot: jax.Array   # (E, 3) measured relative rotation (angle-axis)
    edge_tran: jax.Array  # (E, 3) measured relative translation
    edge_weight: jax.Array  # (E,) confidence (0 disables an edge slot)


def relative_pose(pose_i, pose_j):
    """Predicted relative pose of edge (i, j): R_rel = R_j R_i^T,
    t_rel = t_j - R_rel t_i (camera convention p = R X - t)."""
    Ri = rotation.angle_axis_to_matrix(pose_i[..., :3])
    Rj = rotation.angle_axis_to_matrix(pose_j[..., :3])
    R_rel = hp_matmul(Rj, jnp.swapaxes(Ri, -1, -2))
    t_rel = pose_j[..., 3:] - hp_einsum("...ij,...j->...i", R_rel, pose_i[..., 3:])
    return R_rel, t_rel


def edge_residual(pose_i, pose_j, meas_rot_aa, meas_tran):
    """6-residual per edge: SO(3) log of rotation error + translation gap."""
    R_rel, t_rel = relative_pose(pose_i, pose_j)
    R_meas = rotation.angle_axis_to_matrix(meas_rot_aa)
    R_err = hp_matmul(jnp.swapaxes(R_meas, -1, -2), R_rel)
    r_err = rotation.matrix_to_angle_axis(R_err)
    return jnp.concatenate([r_err, t_rel - meas_tran], axis=-1)


def graph_residuals(poses_flat, g: PoseGraph):
    poses = poses_flat.reshape(-1, 6)
    pi = poses[g.edge_i]
    pj = poses[g.edge_j]
    res = edge_residual(pi, pj, g.edge_rot, g.edge_tran)  # (E, 6)
    return res * g.edge_weight[:, None]


def total_cost(g: PoseGraph):
    res = graph_residuals(g.poses.reshape(-1), g)
    return 0.5 * jnp.sum(res * res)


def _edge_blocks(poses, g: PoseGraph, robust_delta=None, tran_weight=1.0):
    """Weighted residuals and per-edge Jacobian blocks.

    Returns res (E, 6), Ji (E, 6, 6) = d res/d pose_i, Jj (E, 6, 6) =
    d res/d pose_j — the only Jacobians that exist for a binary-factor
    graph; the round-1 jacfwd over the stacked vector materialized the
    same information as a dense (E*6, 6N) matrix.

    robust_delta: optional Huber scale (IRLS): each edge's residual and
    Jacobians are scaled by sqrt(rho'(|res|^2)) so a grossly wrong
    odometry/closure measurement (a failed two-view solve) degrades to a
    bounded pull instead of dragging its neighborhood (the standard
    robust-pose-graph formulation)."""

    # Per-block weighting: rotation rows vs translation rows. On
    # (near-)pure-rotation datasets the measured edge translations are
    # noise (|t| unobservable), yet their residuals are metrically ~100x
    # the rotation residuals and DOMINATED the cost — the optimizer spent
    # its freedom fitting junk translations while the rotation part (the
    # product metric) sat inert (60 GN iterations
    # moved cost 0.7%). tran_weight < 1 restores the rotation rows'
    # authority; 1.0 reproduces the unweighted formulation.
    w6 = jnp.concatenate([jnp.ones(3), jnp.full((3,), tran_weight)])

    def one(pi, pj, mr, mt, w):
        res = edge_residual(pi, pj, mr, mt) * w6
        Ji, Jj = jax.jacfwd(edge_residual, argnums=(0, 1))(pi, pj, mr, mt)
        return res, Ji * w6[:, None], Jj * w6[:, None]

    res, Ji, Jj = jax.vmap(one)(
        poses[g.edge_i], poses[g.edge_j], g.edge_rot, g.edge_tran, g.edge_weight
    )
    if robust_delta is not None:
        # Robustness on the UNWEIGHTED residual: round-5 fix — applying
        # Huber to the information-weighted residual saturated exactly the
        # high-weight loop closures (weight 8 x a 0.03 rad drift residual
        # = 0.25 >> delta, scaled down ~5x) while near-zero odometry edges
        # stayed quadratic: the graph treated its most informative edges
        # as outliers and the optimization sat inert. The kernel must judge a measurement by
        # its own misfit, not by how much we trust it.
        s = jnp.sum(res * res, axis=-1)
        w_rob = jnp.sqrt(
            jnp.where(
                s <= robust_delta * robust_delta,
                1.0,
                robust_delta / jnp.sqrt(jnp.maximum(s, 1e-32)),
            )
        )
        res = res * w_rob[:, None]
        Ji = Ji * w_rob[:, None, None]
        Jj = Jj * w_rob[:, None, None]
    w = g.edge_weight[:, None]
    return res * w, Ji * w[..., None], Jj * w[..., None]


def _grad_and_diag(g: PoseGraph, res, Ji, Jj, n):
    """Gradient (N, 6) and block-diagonal of H (N, 6, 6) via segment_sum."""
    gi = hp_einsum("eri,er->ei", Ji, res)
    gj = hp_einsum("eri,er->ei", Jj, res)
    grad = jax.ops.segment_sum(gi, g.edge_i, num_segments=n) + jax.ops.segment_sum(
        gj, g.edge_j, num_segments=n
    )
    hii = hp_einsum("eri,erj->eij", Ji, Ji)
    hjj = hp_einsum("eri,erj->eij", Jj, Jj)
    Hdiag = jax.ops.segment_sum(hii, g.edge_i, num_segments=n) + jax.ops.segment_sum(
        hjj, g.edge_j, num_segments=n
    )
    return grad, Hdiag


def _gn_step_dense(g, res, Ji, Jj, lam, fix_first_pose, n):
    """Exact dense solve of the damped normal equations, assembled from
    the per-edge blocks with segment_sum scatters (O(E + N^2) memory)."""
    grad, Hdiag = _grad_and_diag(g, res, Ji, Jj, n)
    hij = hp_einsum("eri,erj->eij", Ji, Jj)  # (E, 6, 6) coupling blocks
    pair_idx = g.edge_i * n + g.edge_j
    Hoff = jax.ops.segment_sum(hij, pair_idx, num_segments=n * n).reshape(n, n, 6, 6)
    H = Hoff + jnp.swapaxes(Hoff, -1, -2).transpose(1, 0, 2, 3)
    H = H.at[jnp.arange(n), jnp.arange(n)].add(Hdiag)
    H = H.transpose(0, 2, 1, 3).reshape(n * 6, n * 6)
    gflat = grad.reshape(-1)

    H = H + lam * jnp.diag(jnp.maximum(jnp.diagonal(H), 1e-8))
    if fix_first_pose:
        mask = jnp.concatenate([jnp.zeros(6), jnp.ones(n * 6 - 6)])
        H = H * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        gflat = gflat * mask
    H = H + 1e-9 * jnp.eye(n * 6)
    return -smallmat.solve_psd(H, gflat).reshape(n, 6)


def _gn_step_pcg(g, res, Ji, Jj, lam, fix_first_pose, n, cg_iters, cg_tol):
    """Matrix-free damped-GN step: H @ x as two gathers + two segment_sums
    per CG application; block-Jacobi preconditioner from the (N, 6, 6)
    diagonal. Nothing O(N^2) is materialized."""
    grad, Hdiag = _grad_and_diag(g, res, Ji, Jj, n)
    dvec = lam * jnp.maximum(
        jnp.diagonal(Hdiag, axis1=-2, axis2=-1), 1e-8
    )  # (N, 6) LM damping, same scheme as the dense path
    if fix_first_pose:
        node_mask = jnp.concatenate([jnp.zeros((1, 6)), jnp.ones((n - 1, 6))])
    else:
        node_mask = jnp.ones((n, 6))

    def matvec(x_flat):
        x = x_flat.reshape(n, 6) * node_mask
        t = hp_einsum("erk,ek->er", Ji, x[g.edge_i]) + hp_einsum(
            "erk,ek->er", Jj, x[g.edge_j]
        )
        y = jax.ops.segment_sum(
            hp_einsum("eri,er->ei", Ji, t), g.edge_i, num_segments=n
        ) + jax.ops.segment_sum(
            hp_einsum("eri,er->ei", Jj, t), g.edge_j, num_segments=n
        )
        y = (y + dvec * x) * node_mask
        # gauge: identity on the fixed pose so the system stays SPD
        y = y + x_flat.reshape(n, 6) * (1.0 - node_mask)
        return y.reshape(-1)

    blocks = Hdiag + dvec[..., None] * jnp.eye(6)
    blocks = jnp.where(
        node_mask[:, :1, None] > 0, blocks, jnp.eye(6, dtype=blocks.dtype)
    )
    precond = pcg_mod.block_jacobi_precond(blocks)

    b = -(grad * node_mask).reshape(-1)
    out = pcg_mod.pcg(matvec, b, precond, max_iters=cg_iters, tol=cg_tol)
    return out.x.reshape(n, 6) * node_mask


@partial(
    jax.jit,
    static_argnames=("num_iters", "fix_first_pose", "linear_solver", "cg_iters",
                     "robust_delta", "tran_weight"),
)
def optimize_pose_graph(
    g: PoseGraph,
    num_iters: int = 25,
    lam0: float = 1e-3,
    fix_first_pose: bool = True,
    linear_solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
    robust_delta=None,
    tran_weight: float = 1.0,
):
    """Damped GN over all poses; returns (optimized graph, cost trace).

    linear_solver: "dense" (exact Cholesky, O(N^2) memory), "pcg"
    (matrix-free block-Jacobi CG, O(E + N)), or "auto" (dense up to 64
    nodes, pcg beyond)."""
    n = g.poses.shape[0]
    if linear_solver == "auto":
        linear_solver = "dense" if n <= 64 else "pcg"

    def step(carry, _):
        poses, lam = carry
        gg = g._replace(poses=poses)
        res, Ji, Jj = _edge_blocks(poses, gg, robust_delta, tran_weight)
        cost0 = 0.5 * jnp.sum(res * res)
        if linear_solver == "dense":
            dp = _gn_step_dense(gg, res, Ji, Jj, lam, fix_first_pose, n)
        else:
            dp = _gn_step_pcg(
                gg, res, Ji, Jj, lam, fix_first_pose, n, cg_iters, cg_tol
            )
        new_poses = poses + dp
        res1, _, _ = _edge_blocks(new_poses, gg, robust_delta, tran_weight)
        cost1 = 0.5 * jnp.sum(res1 * res1)
        accept = cost1 < cost0
        poses = jnp.where(accept, new_poses, poses)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
        return (poses, lam), jnp.minimum(cost0, cost1)

    (poses, _), costs = jax.lax.scan(
        step,
        (g.poses, jnp.asarray(lam0, g.poses.dtype)),
        None,
        length=num_iters,
    )
    return g._replace(poses=poses), costs


def chain_with_loop_closures(
    odometry_rot, odometry_tran, closures=(), closure_weight=1.0,
    odometry_weights=None, closure_weights=None,
):
    """Build a PoseGraph from sequential odometry edges (i -> i+1) plus
    (i, j, rot_aa, tran) loop-closure tuples; initializes poses by chaining
    odometry. Convenience for sequence pipelines and tests.

    odometry_weights: optional (N-1,) per-edge information weights (e.g.
    sqrt(match count) — a two-view edge estimated from 4x the matches has
    half the rotation std); default 1.0 each.
    closure_weights: optional per-closure weights, multiplied by
    closure_weight; default 1.0 each."""
    n = odometry_rot.shape[0] + 1
    # p_{k+1} = R_k p_k - t_k => R_{k+1} = R_k R_prev; chain in the same
    # camera convention as relative_pose(). One lax.scan with the rotation
    # MATRIX in the carry (composing angle-axis directly is lossy), so a
    # 1000-frame chain builds in one trace — no O(N) host loop.
    Rk_all = jax.vmap(rotation.angle_axis_to_matrix)(odometry_rot)

    def chain(carry, inp):
        R_prev, t_prev = carry
        Rk, tk = inp
        R_new = hp_einsum("ij,jk->ik", Rk, R_prev)
        t_new = tk + hp_einsum("ij,j->i", Rk, t_prev)
        return (R_new, t_new), (R_new, t_new)

    _, (Rs, ts) = jax.lax.scan(
        chain,
        (jnp.eye(3, dtype=odometry_rot.dtype), jnp.zeros(3, odometry_rot.dtype)),
        (Rk_all, odometry_tran),
    )
    aa = jax.vmap(rotation.matrix_to_angle_axis)(Rs)
    poses = jnp.concatenate(
        [jnp.zeros((1, 6), odometry_rot.dtype), jnp.concatenate([aa, ts], -1)]
    )

    ei = list(range(n - 1))
    ej = list(range(1, n))
    er = [odometry_rot[k] for k in range(n - 1)]
    et = [odometry_tran[k] for k in range(n - 1)]
    if odometry_weights is not None:
        ow = np.asarray(odometry_weights, dtype=np.float32)
        assert ow.shape == (n - 1,), ow.shape
        ew = [float(x) for x in ow]
    else:
        ew = [1.0] * (n - 1)
    for idx, (i, j, raa, t) in enumerate(closures):
        ei.append(i)
        ej.append(j)
        er.append(jnp.asarray(raa))
        et.append(jnp.asarray(t))
        cw = 1.0 if closure_weights is None else float(closure_weights[idx])
        ew.append(closure_weight * cw)
    return PoseGraph(
        poses=poses,
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        edge_rot=jnp.stack(er),
        edge_tran=jnp.stack(et),
        edge_weight=jnp.asarray(ew, jnp.float32),
    )
