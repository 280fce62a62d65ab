"""Multi-keyframe spherical bundle adjustment with explicit Schur
complement — the scaling generalization of the reference's two-view solve
(BASELINE.json north star; the reference itself is two-view only, so this
is the framework's beyond-reference capability, built on the same residual
convention).

Problem layout (static shapes, chosen for sharding):
  * poses: (C, 6) — angle-axis r and translation t per keyframe camera;
    camera i maps a world point X to p_i = R(r_i) @ X - t_i  (the
    two-view residual X2 = R X1 - t with camera 0 = world, reference
    spherical_bundle_adjuster.cpp:844-868, generalized).
  * landmarks: (L, 3) world points.
  * observations in landmark-major layout (L, P): each landmark has up to
    P observing cameras: obs_cam (L, P) int32, obs_bearing (L, P, 3),
    obs_valid (L, P) bool. This layout makes landmark marginalization a
    dense per-landmark computation (vmappable, shardable along L).

Residual per observation: chordal bearing error
    res = b_obs - (R X - t) / ||R X - t||        (3-dim)

Gauss-Newton + Schur: per-landmark 3x3 blocks are marginalized in one
vmapped pass; the reduced camera system S is then solved by either

  * "dense": explicit assembly (segment-sum of (L, P, P, 6, 6) camera-pair
    blocks into (C*6, C*6)) + Cholesky — exact, O(C^2) memory / O(C^3)
    solve, right up to a few dozen keyframes;
  * "pcg": MATRIX-FREE block-Jacobi PCG (solver.pcg) where S @ x is
    applied as gather -> per-landmark 3x3 solve -> segment-sum, O(L*P)
    per application with nothing quadratic in C ever materialized — the
    counterpart of the reference's own ITERATIVE_SCHUR choice
    (spherical_bundle_adjuster.cpp:335) and the path to the 100-1000+
    keyframe north star.

Under `parallel.dist_ba`, L is sharded over the mesh and camera-level
aggregates are `psum`-reduced across devices (axis_name threads through both
linear solvers; the PCG matvec carries one (C, 6) psum per iteration).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rotation, smallmat
from ..core.precision import einsum as hp_einsum


class MultiViewProblem(NamedTuple):
    poses: jax.Array        # (C, 6) [angle-axis | translation]
    landmarks: jax.Array    # (L, 3)
    obs_cam: jax.Array      # (L, P) int32
    obs_bearing: jax.Array  # (L, P, 3) unit bearings in camera frame
    obs_valid: jax.Array    # (L, P) bool
    lm_valid: jax.Array     # (L,) bool


def transform_point(pose, X):
    """p = R(aa) @ X - t for pose = [aa | t]."""
    return rotation.rotate_angle_axis(pose[..., :3], X) - pose[..., 3:]


def obs_residual(pose, X, b_obs):
    """Chordal bearing residual for one observation.

    The normalization is p * rsqrt(|p|^2 + eps), NOT p / max(|p|, eps):
    norm() has a NaN gradient at p == 0 exactly, and invalid observation
    slots (zero landmark seen by the gauge-fixed zero pose) sit exactly
    there — their zero weight cannot save the step because 0 * NaN = NaN
    under jacfwd."""
    p = transform_point(pose, X)
    n2 = jnp.sum(p * p, axis=-1, keepdims=True)
    pred = p * jax.lax.rsqrt(n2 + 1e-18)
    return b_obs - pred


def total_cost(prob: MultiViewProblem):
    poses = prob.poses[prob.obs_cam]             # (L, P, 6)
    X = prob.landmarks[:, None, :]               # (L, 1, 3)
    res = obs_residual(poses, jnp.broadcast_to(X, prob.obs_bearing.shape), prob.obs_bearing)
    w = (prob.obs_valid & prob.lm_valid[:, None]).astype(res.dtype)
    return 0.5 * jnp.sum(w[..., None] * res * res)


def _per_landmark_system(prob: MultiViewProblem):
    """Per-landmark Jacobian blocks for all observations.

    Returns res (L,P,3), Jc (L,P,3,6), Jl (L,P,3,3), w (L,P)."""

    def one_obs(pose, X, b):
        def r_of(pose_and_X):
            p, xx = pose_and_X
            return obs_residual(p, xx, b)

        res = obs_residual(pose, X, b)
        Jp, Jx = jax.jacfwd(lambda p, xx: obs_residual(p, xx, b), argnums=(0, 1))(
            pose, X
        )
        return res, Jp, Jx

    def one_lm(cams, X, bs):
        poses = prob.poses[cams]  # (P, 6)
        return jax.vmap(one_obs, in_axes=(0, None, 0))(poses, X, bs)

    res, Jc, Jl = jax.vmap(one_lm)(prob.obs_cam, prob.landmarks, prob.obs_bearing)
    w = (prob.obs_valid & prob.lm_valid[:, None]).astype(res.dtype)
    return res, Jc, Jl, w


class SchurParts(NamedTuple):
    """Per-landmark marginalization products shared by both camera-system
    solvers. In sharded mode, L-indexed fields are LOCAL to the shard while
    the (C, ...) aggregates are already psum-reduced (global)."""

    Wc: jax.Array        # (L, P, 6, 3) camera-landmark coupling blocks
    Hll_inv: jax.Array   # (L, 3, 3) damped inverted landmark blocks
    WHinv: jax.Array     # (L, P, 6, 3) Wc @ Hll_inv
    gl: jax.Array        # (L, 3) landmark gradients
    S_diag: jax.Array    # (C, 6, 6) segment-summed per-obs Hcc blocks
    g: jax.Array         # (C, 6) reduced gradient g_cam - W Hll_inv gl
    coup_diag: jax.Array  # (C, 6, 6) p == q coupling (S block-diagonal part)


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _schur_parts(prob: MultiViewProblem, lam, axis_name=None) -> SchurParts:
    """Marginalize landmark blocks and reduce all camera-level aggregates
    (one fused psum in sharded mode)."""
    C = prob.poses.shape[0]
    res, Jc, Jl, w = _per_landmark_system(prob)

    ww = w[..., None, None]
    Hll = hp_einsum("lpri,lprj->lij", Jl * ww[..., 0][..., None], Jl)      # (L,3,3)
    gl = hp_einsum("lpri,lpr->li", Jl * ww[..., 0][..., None], res)        # (L,3)
    Wc = hp_einsum("lpri,lprj->lpij", Jc * ww, Jl)                          # (L,P,6,3)
    Hcc_diag = hp_einsum("lpri,lprj->lpij", Jc * ww, Jc)                    # (L,P,6,6)
    gc_obs = hp_einsum("lpri,lpr->lpi", Jc * ww, res)                       # (L,P,6)

    dEye = jnp.eye(3, dtype=Hll.dtype)
    Hll_d = Hll + lam * dEye[None] * jnp.maximum(
        jnp.diagonal(Hll, axis1=-2, axis2=-1).max(-1)[:, None, None], 1e-8
    )
    Hll_inv = smallmat.inv3(Hll_d + 1e-9 * dEye[None])
    Hll_inv = jnp.where(prob.lm_valid[:, None, None], Hll_inv, 0.0)

    cam_flat = prob.obs_cam.reshape(-1)
    S_diag = jax.ops.segment_sum(
        Hcc_diag.reshape(-1, 6, 6), cam_flat, num_segments=C
    )
    g_cam = jax.ops.segment_sum(gc_obs.reshape(-1, 6), cam_flat, num_segments=C)

    WHinv = hp_einsum("lpij,ljk->lpik", Wc, Hll_inv)  # (L,P,6,3)
    g_pairs = jax.ops.segment_sum(
        hp_einsum("lpik,lk->lpi", WHinv, gl).reshape(-1, 6),
        cam_flat,
        num_segments=C,
    )
    coup_diag = jax.ops.segment_sum(
        hp_einsum("lpik,lpjk->lpij", WHinv, Wc).reshape(-1, 6, 6),
        cam_flat,
        num_segments=C,
    )
    S_diag = _psum(S_diag, axis_name)
    g_cam = _psum(g_cam, axis_name)
    g_pairs = _psum(g_pairs, axis_name)
    coup_diag = _psum(coup_diag, axis_name)
    return SchurParts(
        Wc=Wc,
        Hll_inv=Hll_inv,
        WHinv=WHinv,
        gl=gl,
        S_diag=S_diag,
        g=g_cam - g_pairs,
        coup_diag=coup_diag,
    )


def _camera_mask(C, fix_first_pose):
    if fix_first_pose:
        return jnp.concatenate([jnp.zeros((1, 6)), jnp.ones((C - 1, 6))])
    return jnp.ones((C, 6))


def _solve_cameras_dense(parts: SchurParts, prob, lam, fix_first_pose, axis_name=None):
    """Explicit (C*6, C*6) assembly + Cholesky (exact; O(C^2) memory).
    The (L, P, P, 6, 6) pair tensor lives only in this path."""
    C = prob.poses.shape[0]
    L, P = prob.obs_cam.shape
    pair = hp_einsum("lpik,lqjk->lpqij", parts.WHinv, parts.Wc)  # (L,P,P,6,6)
    cam_p = jnp.broadcast_to(prob.obs_cam[:, :, None], (L, P, P))
    cam_q = jnp.broadcast_to(prob.obs_cam[:, None, :], (L, P, P))
    pair_idx = (cam_p * C + cam_q).reshape(-1)
    S_pairs = jax.ops.segment_sum(
        pair.reshape(-1, 6, 6), pair_idx, num_segments=C * C
    ).reshape(C, C, 6, 6)
    S_pairs = _psum(S_pairs, axis_name)

    S = -S_pairs
    S = S.at[jnp.arange(C), jnp.arange(C)].add(parts.S_diag)
    S = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    g = parts.g.reshape(C * 6)

    S = S + lam * jnp.diag(jnp.maximum(jnp.diagonal(S), 1e-8))
    mask = _camera_mask(C, fix_first_pose).reshape(-1)
    S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    g = g * mask
    S = S + 1e-9 * jnp.eye(C * 6)
    return -smallmat.solve_psd(S, g).reshape(C, 6)


def _solve_cameras_pcg(
    parts: SchurParts, prob, lam, fix_first_pose, cg_iters, cg_tol, axis_name=None
):
    """Matrix-free block-Jacobi PCG on the reduced camera system:
    S @ x applied as gather -> 3x3-solve -> segment-sum (O(L*P) work, no
    C^2 anywhere). In sharded mode the matvec psums its (C, 6) result —
    the one collective per CG iteration."""
    from ..solver import pcg as pcg_mod

    C = prob.poses.shape[0]
    cam_flat = prob.obs_cam.reshape(-1)
    node_mask = _camera_mask(C, fix_first_pose)

    # exact block-diagonal of S (diag part minus p == q coupling); the
    # p != q same-camera couplings are absent from the preconditioner and
    # the damping diag — an approximation the accept/reject LM absorbs.
    D = parts.S_diag - parts.coup_diag
    dvec = lam * jnp.maximum(jnp.diagonal(D, axis1=-2, axis2=-1), 1e-8)

    def matvec(x_flat):
        x = x_flat.reshape(C, 6) * node_mask
        y1 = hp_einsum("cij,cj->ci", parts.S_diag, x)
        xo = x[prob.obs_cam]                                   # (L,P,6)
        u = hp_einsum("lpij,lpi->lj", parts.Wc, xo)            # (L,3)
        v = hp_einsum("lij,lj->li", parts.Hll_inv, u)          # (L,3)
        z = hp_einsum("lpij,lj->lpi", parts.Wc, v)             # (L,P,6)
        y2 = jax.ops.segment_sum(z.reshape(-1, 6), cam_flat, num_segments=C)
        y2 = _psum(y2, axis_name)
        # NB: y1 (replicated S_diag) stays OUTSIDE the psum.
        y = (y1 - y2 + dvec * x) * node_mask
        y = y + x_flat.reshape(C, 6) * (1.0 - node_mask)
        return y.reshape(-1)

    blocks = D + dvec[..., None] * jnp.eye(6)
    blocks = jnp.where(
        node_mask[:, :1, None] > 0, blocks, jnp.eye(6, dtype=blocks.dtype)
    )
    precond = pcg_mod.block_jacobi_precond(blocks)
    b = -(parts.g * node_mask).reshape(-1)
    out = pcg_mod.pcg(matvec, b, precond, max_iters=cg_iters, tol=cg_tol)
    return out.x.reshape(C, 6) * node_mask


def gauss_newton_step(
    prob: MultiViewProblem,
    lam,
    fix_first_pose=True,
    linear_solver: str = "dense",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
    axis_name=None,
):
    """One damped GN step with Schur elimination of landmarks.

    Returns (new_poses, new_landmarks). All heavy math is batched over
    (L, P) — the sharding axis is L; pass axis_name under shard_map to
    psum the camera-level aggregates."""
    parts = _schur_parts(prob, lam, axis_name)
    if linear_solver == "dense":
        dc_blocks = _solve_cameras_dense(parts, prob, lam, fix_first_pose, axis_name)
    else:
        dc_blocks = _solve_cameras_pcg(
            parts, prob, lam, fix_first_pose, cg_iters, cg_tol, axis_name
        )

    # back-substitute landmarks: dl = -Hll_inv (gl + sum_p Wc_p^T dc_{cam_p})
    dc_per_obs = dc_blocks[prob.obs_cam]                  # (L,P,6)
    rhs = parts.gl + hp_einsum("lpij,lpi->lj", parts.Wc, dc_per_obs)
    dl = -hp_einsum("lij,lj->li", parts.Hll_inv, rhs)

    new_poses = prob.poses + dc_blocks
    new_landmarks = jnp.where(
        prob.lm_valid[:, None], prob.landmarks + dl, prob.landmarks
    )
    return new_poses, new_landmarks


@partial(
    jax.jit,
    static_argnames=("num_iters", "fix_first_pose", "linear_solver", "cg_iters"),
)
def solve_multiview(
    prob: MultiViewProblem,
    num_iters: int = 20,
    lam0: float = 1e-3,
    fix_first_pose: bool = True,
    linear_solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
):
    """LM loop (accept/reject) over Schur GN steps. Returns
    (solved problem, per-iteration cost trace).

    linear_solver: "dense" (exact, to a few dozen cameras), "pcg"
    (matrix-free, 100-1000+ cameras), or "auto" (dense up to 32)."""
    if linear_solver == "auto":
        linear_solver = "dense" if prob.poses.shape[0] <= 32 else "pcg"

    def step(carry, _):
        poses, landmarks, lam = carry
        p = prob._replace(poses=poses, landmarks=landmarks)
        cost0 = total_cost(p)
        new_poses, new_landmarks = gauss_newton_step(
            p, lam, fix_first_pose, linear_solver, cg_iters, cg_tol
        )
        cost1 = total_cost(
            prob._replace(poses=new_poses, landmarks=new_landmarks)
        )
        accept = cost1 < cost0
        poses = jnp.where(accept, new_poses, poses)
        landmarks = jnp.where(accept, new_landmarks, landmarks)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
        return (poses, landmarks, lam), jnp.minimum(cost0, cost1)

    (poses, landmarks, _), costs = jax.lax.scan(
        step,
        (prob.poses, prob.landmarks, jnp.asarray(lam0, prob.poses.dtype)),
        None,
        length=num_iters,
    )
    return prob._replace(poses=poses, landmarks=landmarks), costs
