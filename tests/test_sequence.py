"""Sequence pipeline test: rotation-only synthetic sequence."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spherical_ba.core import rotation
from spherical_ba.models import sequence
from spherical_ba.utils import synthetic
from spherical_ba.utils.config import (
    BaConfig,
    MatchConfig,
    PipelineConfig,
    SurfConfig,
)

H, W = 96, 192


def render_sequence(eulers, key):
    """Frames viewing the same procedural scene through cumulative
    rotations; frame k's camera rotation R_k maps bearings b_0 -> b_k =
    R_k b_0 (reference eval convention, see synthetic.rotation_pair)."""
    frames = []
    for e in eulers:
        R = rotation.euler_to_matrix(jnp.asarray(e, jnp.float32))
        frames.append(synthetic.render_erp(key, R.T, H, W))
    return jnp.stack(frames)


def test_sequence_recovers_rotations():
    cfg = PipelineConfig(
        surf=SurfConfig(max_keypoints=128, n_octaves=2),
        match=MatchConfig(max_matches=256, ratio_thresh=0.6),
        ba=BaConfig(reference_compat=False),
    )
    key = jax.random.PRNGKey(11)
    eulers = np.deg2rad(
        [[0, 0, 0], [1.5, -2.0, 3.0], [3.0, -3.5, 6.0], [4.0, -5.0, 9.0]]
    )
    frames = render_sequence(eulers, key)

    out = sequence.run_sequence(
        frames, key, cfg, frontend="band", global_ba=False
    )
    # pairwise odometry rotations should match the incremental GT rotation
    for k in range(3):
        R_prev = np.asarray(rotation.euler_to_matrix(jnp.asarray(eulers[k], jnp.float32)))
        R_next = np.asarray(rotation.euler_to_matrix(jnp.asarray(eulers[k + 1], jnp.float32)))
        R_rel_gt = R_next @ R_prev.T
        R_est = np.asarray(rotation.angle_axis_to_matrix(out.pairwise_rot[k]))
        cos = (np.trace(R_est.T @ R_rel_gt) - 1) / 2
        geo = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        assert geo < 2.0, f"pair {k}: rel rotation off by {geo:.2f} deg"

    # chained pose-graph rotation of the last frame ~ GT cumulative
    R_last_est = np.asarray(rotation.angle_axis_to_matrix(out.poses[-1, :3]))
    R_last_gt = np.asarray(rotation.euler_to_matrix(jnp.asarray(eulers[-1], jnp.float32)))
    cos = (np.trace(R_last_est.T @ R_last_gt) - 1) / 2
    geo = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    assert geo < 4.0, f"final pose rotation drift {geo:.2f} deg"
    assert float(out.pg_costs[-1]) <= float(out.pg_costs[0]) + 1e-6


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("SBA_SLOW", "0") != "1",
    reason="100-keyframe sequence takes minutes on CPU; set SBA_SLOW=1",
)
def test_sequence_100_keyframes_ate_bound():
    """100-keyframe full-orbit sequence through the complete path —
    vmapped odometry, skip/loop closures, robust pose graph, sharded
    global BA on the virtual 8-device mesh (VERDICT r3 next #8). Runs the
    EXACT configuration of the committed artifact SEQUENCE_100_r05.json
    (scripts/run_sequence_100.run_orbit) and asserts the rotation-ATE
    envelope it measured (mean 0.203 / median 0.184 / max 0.513 deg —
    right-side gauge alignment; the r4 bound was 3.58/7.13 under the
    broken left-side alignment) with generous headroom."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "run_sequence_100",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts",
            "run_sequence_100.py",
        ),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    out = mod.run_orbit(100)
    ate = out["rot_ate_deg"]
    assert ate["median"] < 1.0, ate
    assert ate["max"] < 2.0, ate
