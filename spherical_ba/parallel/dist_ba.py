"""Distributed multi-keyframe Schur-complement BA and batched two-view BA
over a device mesh.

Sharding strategy:
  * landmarks (the L axis of the (L, P) observation table) are SHARDED
    across the mesh — landmark marginalization is embarrassingly parallel;
  * poses are REPLICATED — the reduced camera system S (C*6, C*6) and
    gradient g are partial-summed per shard and `psum`-reduced across the
    mesh (NCCL over NVLink on GPUs); every device then solves the
    identical small system and
    back-substitutes its local landmark shard. No parameter server, no
    gather of landmark state, one collective per GN iteration.

Batched independent pairs (two-view) shard the batch axis — pure data
parallelism, zero collectives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import multiview as mv


def _cost_sharded(prob: mv.MultiViewProblem, axis_name: str):
    return jax.lax.psum(mv.total_cost(prob), axis_name)


def _lm_loop(p, num_iters, lam0, axis_name, linear_solver, cg_iters, cg_tol):
    """The shared LM accept/reject loop over psum-reduced GN/Schur steps
    (runs on one shard of the landmark table; camera state replicated)."""

    def step(carry, _):
        poses, landmarks, lam = carry
        cur = p._replace(poses=poses, landmarks=landmarks)
        cost0 = _cost_sharded(cur, axis_name)
        np_, nl = mv.gauss_newton_step(
            cur,
            lam,
            fix_first_pose=True,
            linear_solver=linear_solver,
            cg_iters=cg_iters,
            cg_tol=cg_tol,
            axis_name=axis_name,
        )
        cost1 = _cost_sharded(p._replace(poses=np_, landmarks=nl), axis_name)
        accept = cost1 < cost0
        poses = jnp.where(accept, np_, poses)
        landmarks = jnp.where(accept, nl, landmarks)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
        return (poses, landmarks, lam), jnp.minimum(cost0, cost1)

    # 0 * poses[0, 0] ties lam's shard-varying axes to the data's (under a
    # multi-axis shard_map the cost psums only reduce the landmark axis, so
    # the carry is varying over the pair axis — the init must match).
    lam_init = jnp.asarray(lam0, p.poses.dtype) + 0.0 * p.poses[0, 0]
    (poses, landmarks, _), costs = jax.lax.scan(
        step,
        (p.poses, p.landmarks, lam_init),
        None,
        length=num_iters,
    )
    return p._replace(poses=poses, landmarks=landmarks), costs


def collective_bytes_per_gn_iter(
    C: int, linear_solver: str = "pcg", cg_iters: int = 100, dtype_bytes: int = 4
) -> int:
    """Analytic per-device psum payload of ONE GN/LM iteration of the
    sharded multiview solve (counts bytes entering each psum, per
    device).

    pcg:   Schur setup psums S_diag (C,6,6) + coup_diag (C,6,6) +
           g_cam (C,6) + g_pairs (C,6), then one (C,6) vector per CG
           iteration — O(C) total.
    dense: setup psums plus the full (C,C,6,6) pair tensor — O(C^2).
    Both: two scalar cost psums per LM iteration.
    """
    setup = 2 * C * 36 + 2 * C * 6
    costs = 2
    if linear_solver == "dense":
        vol = setup + C * C * 36
    else:
        vol = setup + cg_iters * C * 6
    return (vol + costs) * dtype_bytes


def _problem_specs(lm_spec, pose_spec):
    return mv.MultiViewProblem(
        poses=pose_spec,
        landmarks=lm_spec,
        obs_cam=lm_spec,
        obs_bearing=lm_spec,
        obs_valid=lm_spec,
        lm_valid=lm_spec,
    )


# The sharded solvers are jitted once at module level with every
# non-array argument static (the mesh included), so repeated calls with
# the same shapes reuse one executable.
_STATIC = ("mesh", "num_iters", "lam0", "linear_solver", "cg_iters", "cg_tol")


@partial(jax.jit, static_argnames=_STATIC + ("axis_name",))
def _solve_sharded(prob, *, mesh, num_iters, lam0, axis_name, linear_solver,
                   cg_iters, cg_tol):
    specs = _problem_specs(P(axis_name), P())

    @partial(jax.shard_map, mesh=mesh, in_specs=(specs,), out_specs=(specs, P()))
    def run(p: mv.MultiViewProblem):
        return _lm_loop(
            p, num_iters, lam0, axis_name, linear_solver, cg_iters, cg_tol
        )

    return run(prob)


@partial(jax.jit, static_argnames=_STATIC + ("pair_axis", "lm_axis"))
def _solve_batch_sharded(probs, *, mesh, num_iters, lam0, pair_axis, lm_axis,
                         linear_solver, cg_iters, cg_tol):
    specs = _problem_specs(P(pair_axis, lm_axis), P(pair_axis))

    @partial(jax.shard_map, mesh=mesh, in_specs=(specs,),
             out_specs=(specs, P(pair_axis)))
    def run(p: mv.MultiViewProblem):
        return jax.vmap(
            lambda pp: _lm_loop(
                pp, num_iters, lam0, lm_axis, linear_solver, cg_iters, cg_tol
            )
        )(p)

    return run(probs)


def solve_multiview_sharded(
    prob: mv.MultiViewProblem,
    mesh: Mesh,
    num_iters: int = 20,
    lam0: float = 1e-3,
    axis_name: str = "data",
    linear_solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
):
    """Distributed LM/Schur solve: landmarks sharded over `mesh`, poses
    replicated, camera-level aggregates psum-reduced per iteration (the
    SAME gauss_newton_step as single-device, with axis_name threaded in).

    linear_solver "dense" psums the full (C*6)^2 system once per GN step;
    "pcg" (the scalable path) psums one fused (C, 6, 6)x3 aggregate per GN
    step plus one (C, 6) vector per CG iteration — collective volume
    O(C) instead of O(C^2). "auto": dense up to 32 cameras.

    The (L, P) observation table must have L divisible by the mesh size
    (pad with lm_valid=False rows).
    """
    if linear_solver == "auto":
        linear_solver = "dense" if prob.poses.shape[0] <= 32 else "pcg"
    return _solve_sharded(
        prob, mesh=mesh, num_iters=num_iters, lam0=float(lam0),
        axis_name=axis_name, linear_solver=linear_solver, cg_iters=cg_iters,
        cg_tol=float(cg_tol),
    )


def solve_multiview_batch_sharded(
    probs: mv.MultiViewProblem,
    mesh: Mesh,
    num_iters: int = 20,
    lam0: float = 1e-3,
    pair_axis: str = "pairs",
    lm_axis: str = "data",
    linear_solver: str = "pcg",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
):
    """Batch of INDEPENDENT multiview problems on a 2-D (pairs x landmarks)
    mesh (parallel.mesh.make_mesh_2d): the leading batch axis is sharded
    over `pair_axis` (zero collectives — independent solves), each
    problem's landmark table over `lm_axis` (psums reduce over that axis
    only). This is the production layout for sequence SfM at scale: many
    sequences solved concurrently, each itself landmark-sharded.

    `probs` is a MultiViewProblem whose every field carries a leading
    batch dim B; B must divide by mesh.shape[pair_axis] and L by
    mesh.shape[lm_axis].
    """
    return _solve_batch_sharded(
        probs, mesh=mesh, num_iters=num_iters, lam0=float(lam0),
        pair_axis=pair_axis, lm_axis=lm_axis, linear_solver=linear_solver,
        cg_iters=cg_iters, cg_tol=float(cg_tol),
    )


@partial(jax.jit, static_argnames=("cfg", "frontend"))
def _two_view_vmapped(im_left, im_right, keys, cfg, frontend):
    from ..models import twoview

    return jax.vmap(partial(twoview.run_two_view, cfg=cfg, frontend=frontend))(
        im_left, im_right, keys
    )


def batched_two_view_sharded(im_left, im_right, keys, mesh: Mesh, cfg, frontend="band"):
    """Data-parallel batched two-view BA: batch axis sharded over the mesh
    (BASELINE.md config #2 scaled out). Zero collectives.

    The whole sharded batch runs as one vmap, so under the auto band
    ladder both ladders run for every pair (lax.cond under vmap): pin
    "parity" or "dense" in `cfg` here."""
    shard = NamedSharding(mesh, P("data"))
    im_left = jax.device_put(im_left, shard)
    im_right = jax.device_put(im_right, shard)
    keys = jax.device_put(keys, shard)
    return _two_view_vmapped(im_left, im_right, keys, cfg=cfg, frontend=frontend)
