"""100-keyframe end-to-end sequence SfM artifact (VERDICT r3 next #8).

Renders a 100-frame synthetic orbit (smooth yaw sweep with pitch/roll
wobble), runs the FULL sequence path — vmapped pairwise two-view BA,
lax.scan chain init, pose-graph GN, track merging, multi-keyframe Schur
BA with matrix-free PCG — on a virtual 8-device CPU mesh (the multi-chip
validation surface, SURVEY.md §4), and records rotation ATE vs the known
ground-truth orbit plus wall time per stage.

Writes SEQUENCE_100_r05.json. Usage:
  python scripts/run_sequence_100.py [n_frames] (default 100)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")


def orbit_eulers(n, yaw_total_deg=356.4, wobble_deg=2.0, seed=0):
    """Per-frame absolute orientation: linear yaw sweep + smooth wobble."""
    rng = np.random.default_rng(seed)
    tt = np.linspace(0.0, 1.0, n)
    yaw = np.deg2rad(yaw_total_deg) * tt
    pitch = np.deg2rad(wobble_deg) * np.sin(2 * np.pi * 2.0 * tt + rng.uniform(0, 6.28))
    roll = np.deg2rad(wobble_deg) * np.sin(2 * np.pi * 3.0 * tt + rng.uniform(0, 6.28))
    return np.stack([roll, pitch, yaw], axis=1).astype(np.float32)


def run_orbit(n=100, H=256, W=512):
    from spherical_ba.core import rotation
    from spherical_ba.models import sequence
    from spherical_ba.utils import synthetic
    from spherical_ba.utils.config import (
        MatchConfig,
        PipelineConfig,
        SurfConfig,
    )

    import dataclasses

    cfg = PipelineConfig(
        surf=SurfConfig(max_keypoints=64, n_octaves=2),
        match=MatchConfig(max_matches=128, ratio_thresh=0.5),
    )
    # corrected-mode BA: per-match depths + outlier gates + joint Schur —
    # compat mode's reference quirks bias tiny inter-frame rotations and
    # the bias integrates into systematic trajectory drift
    cfg = dataclasses.replace(
        cfg,
        ba=dataclasses.replace(
            cfg.ba, reference_compat=False, joint_refine=True,
            outlier_reject=True, multi_start=4),
    )

    eulers = orbit_eulers(n)
    Rs = jax.vmap(rotation.euler_to_matrix)(jnp.asarray(eulers))
    scene_key = jax.random.PRNGKey(11)
    t0 = time.perf_counter()
    # One shared scene viewed from n orientations (pure-rotation orbit).
    frames = jax.vmap(
        lambda R: synthetic.render_erp(scene_key, R.T, H, W)
    )(Rs)
    jax.block_until_ready(frames)
    t_render = time.perf_counter() - t0

    from spherical_ba.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(min(8, len(jax.devices())))

    # Keyframes are ~3.6 deg apart (a full 360-deg orbit): span-10 skip
    # edges (36 deg baselines, low relative bias) bound odometry-chain
    # depth, and (0, n-1) is a TRUE loop closure (the orbit ends where it
    # started). Closures weighted 8x: the 99 tiny odometry edges carry a
    # ~0.2-0.5 deg absolute quantization bias each, the wide-baseline
    # edges are the trustworthy ones.
    # ERP frames see the full sphere, so ANY frame pair overlaps — long-
    # span closures (quarter- and half-orbit) are as solvable as short
    # ones and distribute the loop error instead of letting it bulge
    # mid-arc (the classic drift arc of a single loop closure).
    closures = sorted(
        {(i, min(i + 10, n - 1)) for i in range(0, n - 1, 10)}
        | {(i, min(i + 25, n - 1)) for i in range(0, n - 1, 25)}
        | {(0, n // 2), (n // 4, 3 * n // 4), (n // 2, n - 1)}
        | {(0, n - 1)}
    )
    t0 = time.perf_counter()
    res = sequence.run_sequence(
        frames, jax.random.PRNGKey(3), cfg, global_ba="auto", ba_iters=10,
        mesh=mesh, closures=closures, closure_weight=8.0, pg_iters=60,
    )
    jax.block_until_ready(res.poses)
    t_seq = time.perf_counter() - t0

    # Rotation ATE with the CORRECT gauge side (round-5 fix): with
    # world->camera poses p = R_i X, the unobservable freedom of a
    # relative-pose problem is the choice of WORLD frame X' = G X, i.e. a
    # RIGHT multiplication R_i -> R_i G^{-1} (relative poses R_j R_i^T
    # are invariant to it; a LEFT factor is NOT a gauge freedom). The r4
    # metric (and the first r5 cut) aligned on the left, which cannot
    # absorb frame-0's ground-truth wobble offset — every recorded ATE
    # carried a constant ~|R_gt[0]| ~ 2.3 deg of pure gauge. Alignment:
    # best-fit B over the trajectory (Procrustes on sum R_est^T R_gt),
    # applied R_est[i] @ B; the frame-0-anchored variant (B = R_gt[0],
    # exact at frame 0) is recorded alongside.
    def ate(poses):
        R_est = np.asarray(
            jax.vmap(rotation.angle_axis_to_matrix)(poses[:, :3]), np.float64
        )
        R_gt = np.asarray(Rs, np.float64)
        M = np.einsum("nji,njk->ik", R_est, R_gt)  # sum R_est^T R_gt
        u, _, vt = np.linalg.svd(M)
        B = u @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))]) @ vt
        B0 = R_est[0].T @ R_gt[0]  # exact frame-0 anchoring (right side)
        e = []
        e0 = []
        for i in range(n):
            cv = (np.trace(R_gt[i].T @ (R_est[i] @ B)) - 1) / 2
            e.append(np.degrees(np.arccos(np.clip(cv, -1, 1))))
            cv0 = (np.trace(R_gt[i].T @ (R_est[i] @ B0)) - 1) / 2
            e0.append(np.degrees(np.arccos(np.clip(cv0, -1, 1))))
        return np.asarray(e), np.asarray(e0)

    errs, errs_frame0 = ate(res.poses)
    errs_pg, _ = ate(res.pg_poses)

    out = {
        "n_frames": n,
        "resolution": [H, W],
        "ate_alignment": "best-fit RIGHT-side (world-frame gauge) SO(3); _frame0 = exact frame-0 anchor",
        "mesh_devices": len(mesh.devices.flat),
        "render_wall_s": round(t_render, 2),
        "sequence_wall_s": round(t_seq, 2),
        "pg_cost_first_last": [float(np.asarray(res.pg_costs)[0]),
                               float(np.asarray(res.pg_costs)[-1])],
        "ba_cost_first_last": [float(np.asarray(res.ba_costs)[0]),
                               float(np.asarray(res.ba_costs)[-1])]
        if res.ba_costs.size else None,
        "rot_ate_deg": {
            "mean": float(errs.mean()),
            "median": float(np.median(errs)),
            "p90": float(np.percentile(errs, 90)),
            "max": float(errs.max()),
        },
        "rot_ate_pose_graph_deg": {
            "mean": float(errs_pg.mean()),
            "median": float(np.median(errs_pg)),
            "max": float(errs_pg.max()),
        },
        "rot_ate_frame0_deg": {
            "mean": float(errs_frame0.mean()),
            "median": float(np.median(errs_frame0)),
            "max": float(errs_frame0.max()),
        },
        "per_frame_err_deg": [round(float(e), 3) for e in errs],
    }
    return out


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    out = run_orbit(n)
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "SEQUENCE_100_r05.json",
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("n_frames", "sequence_wall_s", "rot_ate_deg")}, indent=1))


if __name__ == "__main__":
    main()
