"""Cross-pair track merging tests (VERDICT r1 #3): P>=3 tracks from
consecutive-pair matches, device-side assembly, and global BA on merged
tracks beating pose-graph-only poses on a noisy >=8-frame sequence."""

import numpy as np
import jax
import jax.numpy as jnp

from spherical_ba.core import rotation, sphere
from spherical_ba.models import multiview as mv
from spherical_ba.models import tracks


class TestMergeTracks:
    def test_chain_three_pairs(self):
        """Hand-built chains: keypoint A tracks through all 4 frames,
        B through frames 1-3, C only in pair 2."""
        M = 4
        nan = 1e9  # distinct junk for invalid slots

        def xy(*pts):
            out = np.full((M, 2), nan, np.float32)
            for i, p in enumerate(pts):
                if p is not None:
                    out[i] = p
            return out

        # frame-k pixel of track A: (10+k, 20); B: (50, 60+k); C: (80, 80)
        left_xy = np.stack([
            xy((10, 20), None, None),            # pair 0: A at frame0
            xy((11, 20), (50, 61), None),        # pair 1: A, B at frame1
            xy((12, 20), (50, 62), (80, 80)),    # pair 2: A, B, C at frame2
        ])
        right_xy = np.stack([
            xy((11, 20), None, None),            # pair 0 right = frame1
            xy((12, 20), (50, 62), None),        # pair 1 right = frame2
            xy((13, 20), (50, 63), (81, 80)),    # pair 2 right = frame3
        ])
        valid = np.zeros((3, M), bool)
        valid[0, :1] = True
        valid[1, :2] = True
        valid[2, :3] = True

        tt = tracks.merge_tracks(
            jnp.asarray(left_xy), jnp.asarray(right_xy), jnp.asarray(valid)
        )
        tid = np.asarray(tt.track_id)
        slot = np.asarray(tt.slot)
        # A: one track across all three pairs
        assert tid[0, 0] == tid[1, 0] == tid[2, 0]
        assert (slot[0, 0], slot[1, 0], slot[2, 0]) == (0, 1, 2)
        # B: one track across pairs 1-2, distinct from A
        assert tid[1, 1] == tid[2, 1] != tid[0, 0]
        assert (slot[1, 1], slot[2, 1]) == (0, 1)
        # C: its own root
        assert tid[2, 2] not in (tid[0, 0], tid[1, 1])
        assert slot[2, 2] == 0
        assert int(tt.num_tracks) == 3
        # has_next: A continued in pairs 0,1; B continued in pair 1
        hn = np.asarray(tt.has_next)
        assert hn[0, 0] and hn[1, 0] and not hn[2, 0]
        assert hn[1, 1] and not hn[2, 1]
        assert not hn[2, 2]

    def test_problem_has_multi_obs_landmarks(self):
        """End-to-end assembly from projected GT geometry: the A-style
        track must yield a P>=4-observation landmark with the right
        cameras in the right slots."""
        prob, gt_poses, _, _ = _make_sequence_problem(
            n_cams=5, n_landmarks=24, seed=0, pose_noise=(0.0, 0.0)
        )
        counts = np.asarray(jnp.sum(prob.obs_valid, axis=-1))
        assert counts.max() >= 4, f"max obs/track {counts.max()}"
        assert (counts >= 3).sum() >= 5
        # each valid landmark's observations carry strictly increasing cams
        cams = np.asarray(prob.obs_cam)
        ov = np.asarray(prob.obs_valid)
        for row in np.flatnonzero(np.asarray(prob.lm_valid))[:20]:
            cs = cams[row][ov[row]]
            assert np.all(np.diff(cs) == 1), f"track cams {cs}"


def _make_sequence_problem(
    n_cams=10, n_landmarks=80, seed=1, pose_noise=(0.02, 0.08), px_noise=0.0,
    width=1024, height=512,
):
    """Project GT landmarks through a GT trajectory into per-pair match
    tables (the per-frame pixel is shared by adjacent pairs, like a real
    detector), then assemble the multiview problem from NOISY poses."""
    rng = np.random.default_rng(seed)
    n_pairs = n_cams - 1

    gt = np.concatenate(
        [
            rng.uniform(-0.15, 0.15, (n_cams, 3)),
            np.cumsum(rng.uniform(-0.4, 0.4, (n_cams, 3)), axis=0),
        ],
        axis=-1,
    ).astype(np.float32)
    gt[0] = 0.0
    X = rng.normal(size=(n_landmarks, 3))
    X = X / np.linalg.norm(X, axis=-1, keepdims=True) * rng.uniform(
        4.0, 9.0, (n_landmarks, 1)
    )
    X = X.astype(np.float32)

    gtj = jnp.asarray(gt)
    Xj = jnp.asarray(X)

    # per-frame projected pixels (C, L, 2) + per-detection noise
    def project(pose, Xw):
        p = rotation.rotate_angle_axis(pose[:3], Xw) - pose[3:]
        return sphere.bearing_to_pixel(
            p / jnp.linalg.norm(p, axis=-1, keepdims=True), width, height
        )

    px = jax.vmap(lambda pose: project(pose, Xj))(gtj)  # (C, L, 2)
    px = np.asarray(px) + rng.normal(scale=px_noise, size=px.shape)

    # pair k observes a sliding window of landmarks
    M = n_landmarks
    left_xy = np.zeros((n_pairs, M, 2), np.float32)
    right_xy = np.zeros((n_pairs, M, 2), np.float32)
    valid = np.zeros((n_pairs, M), bool)
    win = max(n_landmarks // 2, 12)
    stride = max((n_landmarks - win) // max(n_pairs - 1, 1), 1)
    for k in range(n_pairs):
        lo = min(k * stride, n_landmarks - win)
        idx = np.arange(lo, lo + win)
        left_xy[k, : len(idx)] = px[k, idx]
        right_xy[k, : len(idx)] = px[k + 1, idx]
        valid[k, : len(idx)] = True

    # noisy poses (what a drifty pose graph would hand over)
    noisy = gt + np.concatenate(
        [
            rng.normal(scale=pose_noise[0], size=(n_cams, 3)),
            rng.normal(scale=pose_noise[1], size=(n_cams, 3)),
        ],
        axis=-1,
    ).astype(np.float32)
    noisy[0] = gt[0]

    # per-pair relative poses from the NOISY chain (triangulation init)
    R_rel_list, t_rel_list = [], []
    for k in range(n_pairs):
        Ri = np.asarray(rotation.angle_axis_to_matrix(jnp.asarray(noisy[k, :3])))
        Rj = np.asarray(rotation.angle_axis_to_matrix(jnp.asarray(noisy[k + 1, :3])))
        R_rel = Rj @ Ri.T
        t_rel = noisy[k + 1, 3:] - R_rel @ noisy[k, 3:]
        R_rel_list.append(
            np.asarray(rotation.matrix_to_angle_axis(jnp.asarray(R_rel)))
        )
        t_rel_list.append(t_rel)

    prob = tracks.build_multiview_problem(
        jnp.asarray(noisy),
        jnp.asarray(left_xy),
        jnp.asarray(right_xy),
        jnp.asarray(valid),
        jnp.asarray(np.stack(R_rel_list), jnp.float32),
        jnp.asarray(np.stack(t_rel_list), jnp.float32),
        width,
        height,
        max_obs_per_track=6,
    )
    return prob, gt, noisy, X


def _pose_errors(poses, gt):
    """(mean rotation geodesic deg, mean translation err after optimal
    global scale alignment — bearing-only BA has a scale gauge)."""
    r_err = []
    for k in range(gt.shape[0]):
        Re = np.asarray(rotation.angle_axis_to_matrix(jnp.asarray(poses[k, :3])))
        Rg = np.asarray(rotation.angle_axis_to_matrix(jnp.asarray(gt[k, :3])))
        cos = (np.trace(Re.T @ Rg) - 1) / 2
        r_err.append(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    te = np.asarray(poses[:, 3:], np.float64)
    tg = np.asarray(gt[:, 3:], np.float64)
    s = float(np.sum(te * tg) / max(np.sum(te * te), 1e-12))
    t_err = np.linalg.norm(s * te - tg, axis=-1)
    return float(np.mean(r_err)), float(np.mean(t_err))


class TestGlobalBAOnTracks:
    def test_ba_beats_pose_graph_only_10_frames(self):
        """VERDICT r1 #3 'Done' criterion: on a >=8-frame noisy sequence,
        global Schur BA over merged P>=3 tracks must measurably beat the
        pose-graph-only (noisy input) poses."""
        prob, gt, noisy, X = _make_sequence_problem(
            n_cams=10, n_landmarks=80, seed=1, pose_noise=(0.02, 0.08)
        )
        counts = np.asarray(jnp.sum(prob.obs_valid, axis=-1))
        assert counts.max() >= 4, "expected long tracks in the fixture"

        solved, costs = mv.solve_multiview(prob, num_iters=25)
        r0, t0 = _pose_errors(noisy, gt)
        r1, t1 = _pose_errors(np.asarray(solved.poses), gt)
        assert float(costs[-1]) < float(costs[0])
        assert r1 < 0.5 * r0, f"rotation: {r0:.4f} -> {r1:.4f} deg"
        assert t1 < 0.5 * t0, f"translation: {t0:.4f} -> {t1:.4f}"
