"""2-process distributed validation: actually exercise
`jax.distributed.initialize`'s coordinator path (VERDICT r2: it had only
ever run in its single-process fallback branch) and run the sharded
multi-keyframe solver over a (2 process x 4 virtual CPU device) global
mesh, asserting parity with the single-process 8-device solve.

This is the CPU stand-in for a multi-host run: the mesh axis spans a
process boundary, so every psum in the Schur reduction crosses the
distributed runtime, not just intra-process threads.

Usage:
  python scripts/run_multiprocess.py   # parent: spawns 2 children, runs the
                                       # single-process reference, prints
                                       # the comparison record (also
                                       # written to a temporary directory)
  python scripts/run_multiprocess.py <pid> <n> <result.json>  # child
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = 12765
C, L, P_OBS, ITERS = 8, 128, 4, 10
DEVS_PER_PROC = 4


def build_problem():
    from spherical_ba.utils import synthetic

    return synthetic.multiview_problem(C=C, L=L, P=P_OBS, noise=0.0, pose_noise=0.05, seed=3)


def solve_on_mesh(prob, mesh_devices, n_procs):
    """Shard the problem's landmark axis globally and solve."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from spherical_ba.parallel import dist_ba

    mesh = Mesh(np.asarray(mesh_devices), ("data",))
    lm_sharding = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def globalize(x, sharding):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )

    gprob = prob._replace(
        poses=globalize(prob.poses, rep),
        landmarks=globalize(prob.landmarks, lm_sharding),
        obs_cam=globalize(prob.obs_cam, lm_sharding),
        obs_bearing=globalize(prob.obs_bearing, lm_sharding),
        obs_valid=globalize(prob.obs_valid, lm_sharding),
        lm_valid=globalize(prob.lm_valid, lm_sharding),
    )
    solved, costs = dist_ba.solve_multiview_sharded(
        gprob, mesh, num_iters=ITERS, linear_solver="pcg"
    )
    # poses/costs come back replicated -> readable on every process
    return np.asarray(jax.device_get(solved.poses)), np.asarray(
        jax.device_get(costs)
    )


def child(pid, n_procs, result_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=n_procs,
        process_id=pid,
        local_device_ids=list(range(DEVS_PER_PROC)),
    )
    assert jax.process_count() == n_procs, jax.process_count()
    assert len(jax.devices()) == n_procs * DEVS_PER_PROC
    prob, poses_gt, X = build_problem()
    t0 = time.time()
    poses, costs = solve_on_mesh(prob, jax.devices(), n_procs)
    wall = time.time() - t0
    if pid == 0:
        with open(result_path, "w") as f:
            json.dump(
                {
                    "poses": poses.tolist(),
                    "final_cost": float(costs[-1]),
                    "wall_s": wall,
                    "process_count": jax.process_count(),
                    "n_devices": len(jax.devices()),
                },
                f,
            )
    jax.distributed.shutdown()


def parent():
    env = dict(
        os.environ,
        XLA_FLAGS=f"--xla_force_host_platform_device_count={DEVS_PER_PROC}",
    )
    out_dir = tempfile.mkdtemp(prefix="sba_multiprocess_")
    result_path = os.path.join(out_dir, "child_result.json")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid), "2",
             result_path],
            env=env,
        )
        for pid in range(2)
    ]
    rcs = [p.wait(timeout=900) for p in procs]
    assert all(rc == 0 for rc in rcs), f"child exit codes {rcs}"
    with open(result_path) as f:
        multi = json.load(f)
    assert multi["process_count"] == 2 and multi["n_devices"] == 8

    # single-process 8-virtual-device reference
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={2 * DEVS_PER_PROC}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    prob, poses_gt, X = build_problem()
    poses_ref, costs_ref = solve_on_mesh(prob, jax.devices(), 1)

    poses_mp = np.asarray(multi["poses"])
    delta = float(np.max(np.abs(poses_mp - poses_ref)))
    cost_delta = abs(multi["final_cost"] - float(costs_ref[-1]))
    print(
        f"[multiprocess] 2proc-vs-1proc max pose delta {delta:.3e}, "
        f"final cost {multi['final_cost']:.6e} (delta {cost_delta:.2e}), "
        f"2-proc wall {multi['wall_s']:.1f}s",
        file=sys.stderr,
    )
    assert delta < 1e-4, delta
    rec = {
        "what": "2-process jax.distributed CPU run, (2 proc x 4 dev) mesh, "
                "solve_multiview_sharded pcg, vs single-process 8-device",
        "C": C, "L": L, "P": P_OBS, "num_iters": ITERS,
        "max_pose_delta": delta,
        "final_cost_multi": multi["final_cost"],
        "final_cost_single": float(costs_ref[-1]),
        "two_proc_wall_s": multi["wall_s"],
    }
    with open(os.path.join(out_dir, "multiprocess.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    else:
        parent()
