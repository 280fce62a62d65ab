"""Checkpoint/resume tests for the multi-keyframe solver."""

import numpy as np
import jax
import jax.numpy as jnp

from spherical_ba.utils import checkpoint as ckpt
from test_multiview import synth_problem


class TestCheckpoint:
    def test_save_load_roundtrip(self, tmp_path):
        prob, _, _ = synth_problem(C=3, L=16, P=3)
        path = str(tmp_path / "ck")
        kind = ckpt.save_checkpoint(path, prob, step=5)
        assert kind in ("orbax", "npz")
        restored, step = ckpt.load_checkpoint(path, prob)
        assert step == 5
        for a, b in zip(jax.tree.leaves(prob), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_resumable_solve_continues(self, tmp_path):
        prob, poses_gt, X = synth_problem(C=3, L=32, P=3)
        path = str(tmp_path / "solve_ck")
        # run 2 of 4 rounds, "crash", resume — final state must be solved
        p1, costs1 = ckpt.solve_multiview_resumable(
            prob, path, total_iters=10, iters_per_round=5
        )
        assert costs1.shape[0] == 10
        # resume from finished state: no further rounds run
        p2, costs2 = ckpt.solve_multiview_resumable(
            prob, path, total_iters=10, iters_per_round=5
        )
        assert costs2.shape[0] == 0
        from spherical_ba.models import multiview as mv

        assert float(mv.total_cost(p1)) < 1e-5
