"""Multi-keyframe Schur BA tests: single-device and sharded (8 virtual
CPU devices) must converge and agree."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spherical_ba.models import evaluation
from spherical_ba.models import multiview as mv
from spherical_ba.parallel import dist_ba, mesh as mesh_lib
from spherical_ba.utils import synthetic


# the fixture and the error metric live in the package so chip_smoke.py
# and scripts share them
synth_problem = synthetic.multiview_problem
pose_errors = evaluation.pose_errors_host


class TestMultiView:
    def test_cost_zero_at_ground_truth(self):
        prob, poses_gt, X = synth_problem()
        p = prob._replace(poses=jnp.asarray(poses_gt), landmarks=jnp.asarray(X))
        assert float(mv.total_cost(p)) < 1e-8

    def test_converges_from_noisy_init(self):
        prob, poses_gt, X = synth_problem()
        c0 = float(mv.total_cost(prob))
        solved, costs = mv.solve_multiview(prob, num_iters=15)
        c1 = float(costs[-1])
        assert c1 < 1e-6 * max(c0, 1.0), f"cost {c0} -> {c1}"
        ang, terr = pose_errors(np.asarray(solved.poses), poses_gt)
        assert np.max(ang) < 0.5, f"rot errs {ang}"
        assert np.max(terr) < 0.05, f"tran errs {terr}"

    def test_respects_invalid_landmarks(self):
        prob, poses_gt, X = synth_problem(L=32)
        lmv = prob.lm_valid.at[:8].set(False)
        prob = prob._replace(lm_valid=lmv)
        solved, costs = mv.solve_multiview(prob, num_iters=10)
        # invalid landmark rows must remain at their init values
        np.testing.assert_array_equal(
            np.asarray(solved.landmarks[:8]), np.asarray(prob.landmarks[:8])
        )


class TestDistributed:
    def test_sharded_matches_single_device(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        prob, poses_gt, X = synth_problem(C=4, L=64, P=4)
        m = mesh_lib.make_mesh(8)
        solved_s, costs_s = dist_ba.solve_multiview_sharded(prob, m, num_iters=12)
        solved_1, costs_1 = mv.solve_multiview(prob, num_iters=12)
        ang_s, terr_s = pose_errors(np.asarray(solved_s.poses), poses_gt)
        assert np.max(ang_s) < 0.5
        assert float(costs_s[-1]) < 1e-5
        # same algorithm, same data: costs should track closely
        np.testing.assert_allclose(
            np.asarray(costs_s[-1]), np.asarray(costs_1[-1]), rtol=0.5, atol=1e-6
        )

    def test_2d_mesh_batch_of_problems(self):
        """2-D (pairs x landmarks) mesh: a batch of independent problems
        sharded over the outer axis, each landmark-sharded over the inner
        axis. Every batch element must match its own single-device solve."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        probs, gts = [], []
        for seed in (5, 6):
            prob, poses_gt, X = synth_problem(C=4, L=64, P=4, seed=seed)
            probs.append(prob)
            gts.append(poses_gt)
        batched = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)
        m2 = mesh_lib.make_mesh_2d(2, 4)
        assert m2.shape == {"pairs": 2, "data": 4}
        solved, costs = dist_ba.solve_multiview_batch_sharded(
            batched, m2, num_iters=12, linear_solver="pcg", cg_iters=100
        )
        assert costs.shape == (2, 12)
        for i in (0, 1):
            assert float(costs[i, -1]) < 1e-5
            ang, terr = pose_errors(np.asarray(solved.poses[i]), gts[i])
            assert np.max(ang) < 0.5, f"problem {i}: rot errs {ang}"

    def test_collective_accounting(self):
        """PCG collective volume is O(C); dense is O(C^2)."""
        pcg = dist_ba.collective_bytes_per_gn_iter(256, "pcg", cg_iters=60)
        dense = dist_ba.collective_bytes_per_gn_iter(256, "dense")
        assert pcg < dense / 4
        # doubling C doubles pcg volume but quadruples the dense tensor
        assert dist_ba.collective_bytes_per_gn_iter(512, "pcg", cg_iters=60) < 2.1 * pcg
        assert dist_ba.collective_bytes_per_gn_iter(512, "dense") > 3.5 * dense


class TestPcgCameraSystem:
    """VERDICT r1 #5: matrix-free block-Jacobi PCG on the reduced camera
    system (the reference's own ITERATIVE_SCHUR choice,
    spherical_bundle_adjuster.cpp:335)."""

    def test_pcg_matches_dense(self):
        prob, poses_gt, X = synth_problem(C=8, L=128, P=4, seed=2)
        solved_d, costs_d = mv.solve_multiview(
            prob, num_iters=12, linear_solver="dense"
        )
        solved_p, costs_p = mv.solve_multiview(
            prob, num_iters=12, linear_solver="pcg", cg_iters=200, cg_tol=1e-7
        )
        assert float(costs_p[-1]) < 1e-6 * max(float(costs_p[0]), 1.0)
        np.testing.assert_allclose(
            np.asarray(solved_d.poses), np.asarray(solved_p.poses), atol=1e-3
        )

    def test_c256_l8192_sharded_pcg(self):
        """The north-star scale demo: C=256 keyframes, L=8192 landmarks,
        8-device mesh, matrix-free PCG inside the psum'd Schur step —
        nothing O(C^2) materialized anywhere."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        prob, poses_gt, X = synth_problem(
            C=256, L=8192, P=4, pose_noise=0.03, seed=3
        )
        m = mesh_lib.make_mesh(8)
        solved, costs = dist_ba.solve_multiview_sharded(
            prob, m, num_iters=8, linear_solver="pcg", cg_iters=60, cg_tol=1e-5
        )
        c0, c1 = float(costs[0]), float(costs[-1])
        assert c1 < 1e-4 * c0, f"cost {c0} -> {c1}"
        ang, terr = pose_errors(np.asarray(solved.poses), poses_gt)
        assert np.median(ang) < 0.2, f"median rot err {np.median(ang)}"
        assert np.median(terr) < 0.02, f"median tran err {np.median(terr)}"
