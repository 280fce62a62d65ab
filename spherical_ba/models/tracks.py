"""Cross-pair feature-track merging: consecutive-pair matches -> multi-
observation landmarks, entirely device-side (jit/vmap/scan, static shapes).

The reference is two-view only, so this is north-star capability
(BASELINE.md configs #3-#5); round 1 made every match a 2-observation
landmark assembled by a host-side Python loop — multi-view in name only. Here:

  * JOIN: a match m of pair k (frames k -> k+1) continues a match m' of
    pair k-1 iff pair k's LEFT keypoint coincides with pair k-1's RIGHT
    keypoint — both are detections in frame k, produced by the same
    deterministic detector on the same image, so they agree bit-for-bit;
    the join hashes pixel coords to grid cells and compares cell ids,
    one (M, M) equality table per consecutive pair of pairs (vmapped).
  * TRACK IDS: propagated along the chain with ONE `lax.scan` over pairs;
    roots (matches with no predecessor) take compact landmark indices from
    a cumulative-sum ranking, so the landmark table needs no host-side
    compaction pass.
  * ASSEMBLY: observations scatter into the landmark-major (L, P) table
    of models.multiview with two `.at[].set` scatters (left obs at its
    track slot, right obs at slot+1 for chain tails), and landmarks are
    initialized by midpoint triangulation of each root match lifted to
    the world frame through the chained poses.

Everything is O(Np * M) memory with static shapes — no per-pair host
dispatches, so 100-frame sequences assemble in one jit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rotation, sphere
from ..core.precision import einsum as hp_einsum
from . import multiview as mv


class TrackTable(NamedTuple):
    """Per-match track assignment over (Np, M) consecutive-pair matches."""

    track_id: jax.Array  # (Np, M) int32 compact landmark index, -1 invalid
    slot: jax.Array      # (Np, M) int32 position of the match in its track
    has_next: jax.Array  # (Np, M) bool: a pair-(k+1) match continues this one
    num_tracks: jax.Array  # scalar int32: number of distinct tracks (roots)


def link_consecutive(left_xy, right_xy, valid, cell_size: float = 0.5):
    """links[k, m] = index m' of the pair-k match continued by pair-(k+1)
    match m (right keypoint of (k, m') == left keypoint of (k+1, m) up to
    cell quantization), or -1. Returns (Np-1, M) int32."""

    def cell(xy):
        return jnp.round(xy / cell_size).astype(jnp.int32)

    cl = cell(left_xy)
    cr = cell(right_xy)

    def link_pair(c_prev_right, v_prev, c_left, v_left):
        eq = jnp.all(c_prev_right[None, :, :] == c_left[:, None, :], axis=-1)
        eq = eq & v_prev[None, :] & v_left[:, None]  # (m, m')
        found = jnp.any(eq, axis=-1)
        idx = jnp.argmax(eq, axis=-1).astype(jnp.int32)
        return jnp.where(found, idx, -1)

    return jax.vmap(link_pair)(cr[:-1], valid[:-1], cl[1:], valid[1:])


def merge_tracks(left_xy, right_xy, valid, cell_size: float = 0.5) -> TrackTable:
    """Assign compact track ids/slots to all matches of a consecutive-pair
    chain. left_xy/right_xy: (Np, M, 2); valid: (Np, M)."""
    n_pairs, m = valid.shape
    links = link_consecutive(left_xy, right_xy, valid, cell_size)  # (Np-1, M)

    # roots: valid matches not linked to a predecessor
    is_root = valid & jnp.concatenate(
        [jnp.ones((1, m), bool), links < 0], axis=0
    )
    root_rank = (jnp.cumsum(is_root.reshape(-1).astype(jnp.int32)) - 1).reshape(
        n_pairs, m
    )
    num_tracks = jnp.sum(is_root.astype(jnp.int32))

    ids0 = jnp.where(valid[0], root_rank[0], -1).astype(jnp.int32)
    slots0 = jnp.zeros((m,), jnp.int32)

    def body(carry, x):
        prev_ids, prev_slots = carry
        link, rid, v = x
        linked = link >= 0
        li = jnp.maximum(link, 0)
        ids = jnp.where(
            linked, prev_ids[li], jnp.where(v, rid, -1)
        ).astype(jnp.int32)
        slots = jnp.where(linked, prev_slots[li] + 1, 0).astype(jnp.int32)
        return (ids, slots), (ids, slots)

    (_, _), (ids_rest, slots_rest) = jax.lax.scan(
        body, (ids0, slots0), (links, root_rank[1:], valid[1:])
    )
    track_id = jnp.concatenate([ids0[None], ids_rest], axis=0)
    slot = jnp.concatenate([slots0[None], slots_rest], axis=0)

    # has_next[k, m'] = some pair-(k+1) match links back to m'
    def nexts(link):
        tgt = jnp.where(link >= 0, link, m)
        return jnp.zeros((m + 1,), bool).at[tgt].set(True)[:m]

    has_next = jnp.concatenate(
        [jax.vmap(nexts)(links), jnp.zeros((1, m), bool)], axis=0
    )
    return TrackTable(
        track_id=track_id, slot=slot, has_next=has_next, num_tracks=num_tracks
    )


def _triangulate_midpoint(b1, b2, r_aa, t):
    """Midpoint triangulation of matched bearings (batched over leading
    dims). Rays: camera i at origin along b1; camera j at center
    c = R^T t with direction R^T b2 (from p_j = R p_i - t).
    Returns (X (..., 3) in camera-i frame, ok (...,))."""
    R = rotation.angle_axis_to_matrix(r_aa)
    d2 = hp_einsum("...i,...ij->...j", b2, R)  # R^T b2
    c2 = hp_einsum("...ij,...i->...j", R, t)   # R^T t
    b1d2 = jnp.sum(b1 * d2, axis=-1)
    rhs1 = jnp.sum(b1 * c2, axis=-1)
    rhs2 = jnp.sum(d2 * c2, axis=-1)
    det = 1.0 - b1d2 * b1d2
    s = (rhs1 - b1d2 * rhs2) / jnp.maximum(det, 1e-9)
    u = (b1d2 * rhs1 - rhs2) / jnp.maximum(det, 1e-9)
    p1 = b1 * s[..., None]
    p2 = c2 + d2 * u[..., None]
    X = 0.5 * (p1 + p2)
    ok = (det > 1e-6) & (s > 0.1) & jnp.all(jnp.isfinite(X), axis=-1)
    return jnp.where(ok[..., None], X, 0.0), ok


@partial(jax.jit, static_argnames=("width", "height", "max_obs_per_track"))
def build_multiview_problem(
    poses,
    left_xy,
    right_xy,
    match_valid,
    pair_rot_aa,
    pair_tran,
    width: int,
    height: int,
    max_obs_per_track: int = 6,
) -> mv.MultiViewProblem:
    """Landmark-major (L, P) problem from consecutive-pair matches with
    cross-pair track merging. One jit; no host loops.

    poses: (C=Np+1, 6) world->camera chained poses; left_xy/right_xy:
    (Np, M, 2) matched ERP pixels of pair k (frames k, k+1); match_valid:
    (Np, M); pair_rot_aa/pair_tran: (Np, 3) per-pair two-view relative
    poses (used only for landmark triangulation init).

    L = Np * M rows (every match could be a root; rows beyond the actual
    track count stay invalid); P = max_obs_per_track, observations past
    the cap are dropped.
    """
    n_pairs, m = match_valid.shape
    n_cams = n_pairs + 1
    L = n_pairs * m
    P = max_obs_per_track

    tt = merge_tracks(left_xy, right_xy, match_valid)

    b_left = sphere.pixel_to_bearing(left_xy, width, height)    # (Np, M, 3)
    b_right = sphere.pixel_to_bearing(right_xy, width, height)  # (Np, M, 3)

    cam_left = jnp.broadcast_to(
        jnp.arange(n_pairs, dtype=jnp.int32)[:, None], (n_pairs, m)
    )
    cam_right = cam_left + 1

    # observation scatters: left obs at (tid, slot); right obs at
    # (tid, slot + 1) only for chain tails (a successor's left obs fills
    # that cell otherwise — same frame, same keypoint).
    obs_cam = jnp.zeros((L + 1, P), jnp.int32)
    obs_bearing = jnp.zeros((L + 1, P, 3), jnp.float32)
    obs_valid = jnp.zeros((L + 1, P), bool)

    def scatter(obs_cam, obs_bearing, obs_valid, tid, slot, ok, cam, bear):
        ok = ok & (tid >= 0) & (slot >= 0) & (slot < P)
        t = jnp.where(ok, tid, L).reshape(-1)
        s = jnp.clip(slot, 0, P - 1).reshape(-1)
        obs_cam = obs_cam.at[t, s].set(cam.reshape(-1))
        obs_bearing = obs_bearing.at[t, s].set(bear.reshape(-1, 3))
        obs_valid = obs_valid.at[t, s].set(ok.reshape(-1))
        return obs_cam, obs_bearing, obs_valid

    obs_cam, obs_bearing, obs_valid = scatter(
        obs_cam, obs_bearing, obs_valid,
        tt.track_id, tt.slot, match_valid, cam_left, b_left,
    )
    obs_cam, obs_bearing, obs_valid = scatter(
        obs_cam, obs_bearing, obs_valid,
        tt.track_id, tt.slot + 1, match_valid & ~tt.has_next,
        cam_right, b_right,
    )

    # landmark init: triangulate each ROOT match with its pair's relative
    # pose, lift to world through the chained pose of its left camera
    # (X_w = R_i^T (X_ci + t_i) from p_i = R_i X_w - t_i).
    X_local, tri_ok = _triangulate_midpoint(
        b_left, b_right,
        jnp.broadcast_to(pair_rot_aa[:, None, :], (n_pairs, m, 3)),
        jnp.broadcast_to(pair_tran[:, None, :], (n_pairs, m, 3)),
    )  # (Np, M, 3), (Np, M)
    pose_l = poses[cam_left]  # (Np, M, 6)
    R_l = rotation.angle_axis_to_matrix(pose_l[..., :3])
    Xw = hp_einsum("...ij,...i->...j", R_l, X_local + pose_l[..., 3:])

    is_root = tt.slot == 0
    root_ok = match_valid & is_root & (tt.track_id >= 0)
    t_lm = jnp.where(root_ok, tt.track_id, L).reshape(-1)
    landmarks = jnp.zeros((L + 1, 3), jnp.float32).at[t_lm].set(
        Xw.reshape(-1, 3)
    )
    lm_tri_ok = jnp.zeros((L + 1,), bool).at[t_lm].set(tri_ok.reshape(-1))

    obs_cam = obs_cam[:L]
    obs_bearing = obs_bearing[:L]
    obs_valid = obs_valid[:L]
    landmarks = landmarks[:L]
    lm_valid = (
        lm_tri_ok[:L]
        & (jnp.sum(obs_valid.astype(jnp.int32), axis=-1) >= 2)
    )
    return mv.MultiViewProblem(
        poses=poses,
        landmarks=landmarks,
        obs_cam=obs_cam,
        obs_bearing=obs_bearing,
        obs_valid=obs_valid & lm_valid[:, None],
        lm_valid=lm_valid,
    )
