"""Synthetic ERP scene rendering for evaluation fixtures.

The reference's eval encodes ground truth in the right image's filename and
implies pure-rotation synthetic pairs (test/feature_test.cpp:146-163,
SURVEY.md §4). Here the scene is a procedural function of the 3D viewing
direction, so a rotated view is rendered EXACTLY (no warping resampling
error): render(R) samples texture(R @ v) on the ERP grid.

The texture mixes low-frequency random Fourier components (smooth shading)
with high-contrast spherical discs (strong blob features for SURF).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import sphere
from ..core.precision import einsum as hp_einsum


def _texture_params(key, n_waves=24, n_discs=96):
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    freqs = jax.random.normal(k1, (n_waves, 3)) * 4.0
    phases = jax.random.uniform(k2, (n_waves,), minval=0.0, maxval=2 * jnp.pi)
    amps = jax.random.uniform(k3, (n_waves, 3), minval=0.0, maxval=1.0)
    centers = jax.random.normal(k4, (n_discs, 3))
    centers = centers / jnp.linalg.norm(centers, axis=-1, keepdims=True)
    radii = jax.random.uniform(k5, (n_discs,), minval=0.01, maxval=0.08)
    colors = jax.random.uniform(k6, (n_discs, 3), minval=-1.0, maxval=1.0)
    return freqs, phases, amps, centers, radii, colors


def _texture(v, params):
    """v: (..., 3) unit directions -> (..., 3) float colors in [0, 255].

    Precision note: `dots` feeds the hard disc test dots > cos(radii) with
    cos(radii) in [0.9968, 1). A reduced-precision einsum (bf16, or TF32
    on a GPU) quantizes dots in ~0.002 steps near 1.0 — larger than the
    whole disc-boundary signal — so discs render as noise DIFFERENTLY in
    the left and rotated right views and match quality collapses. The
    contraction must be f32-faithful."""
    freqs, phases, amps, centers, radii, colors = params
    proj = hp_einsum("...c,kc->...k", v, freqs) + phases
    base = jnp.einsum("...k,kc->...c", jnp.cos(proj), amps) / freqs.shape[0]
    dots = hp_einsum("...c,kc->...k", v, centers)
    inside = (dots > jnp.cos(radii)).astype(v.dtype)
    discs = jnp.einsum("...k,kc->...c", inside, colors)
    img = 0.5 + 1.5 * base + 0.5 * discs
    return jnp.clip(img, 0.0, 1.0) * 255.0


@partial(jax.jit, static_argnames=("height", "width"))
def render_erp(key, R, height: int = 128, width: int = 256):
    """Render the procedural scene viewed through rotation R as an ERP
    image (H, W, 3) uint8. render(I) and render(R) form an exact
    pure-rotation pair with ground truth R."""
    params = _texture_params(key)
    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5)
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5)
    xy = jnp.stack(jnp.meshgrid(xs, ys, indexing="xy"), axis=-1)
    v = sphere.pixel_to_bearing(xy, width, height)
    v_rot = hp_einsum("rc,ijc->ijr", R.astype(v.dtype), v)
    img = _texture(v_rot, params)
    return img.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("height", "width"))
def render_erp_at(key, pose_aa_t, height: int = 128, width: int = 256,
                  min_dist: float = 2.0, max_dist: float = 6.0):
    """Render the procedural scene from a camera with pose [angle-axis | t]
    in the BA convention p_cam = R X_world - t (camera center c = R^T t).

    Unlike render_erp (pure rotation, texture at infinity), the DISCS sit
    at finite world positions p_k = center_k * dist_k — translating the
    camera produces real parallax, so translation/depth recovery and
    multi-view BA have exact ground truth. The Fourier background stays at
    infinity (it is low-frequency shading, not a matchable feature).
    With pose = 0 this reproduces the disc layout of render_erp(key, I)
    up to the (tiny) cos(r) vs cos(asin(r)) angular-radius difference.
    """
    from ..core import rotation as rot

    params = _texture_params(key)
    freqs, phases, amps, centers, radii, colors = params
    dists = jax.random.uniform(
        jax.random.fold_in(key, 7), (centers.shape[0],),
        minval=min_dist, maxval=max_dist,
    )

    aa = pose_aa_t[:3]
    t = pose_aa_t[3:]
    R = rot.angle_axis_to_matrix(aa)
    c = hp_einsum("ij,i->j", R, t)  # camera center: R^T t

    ys = jnp.arange(height, dtype=jnp.float32) + 0.5
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    xy = jnp.stack(jnp.meshgrid(xs, ys, indexing="xy"), axis=-1)
    b = sphere.pixel_to_bearing(xy, width, height)       # camera frame
    v_world = hp_einsum("rc,ijr->ijc", R, b)             # R^T b

    # infinity background
    proj = hp_einsum("...c,kc->...k", v_world, freqs) + phases
    base = jnp.einsum("...k,kc->...c", jnp.cos(proj), amps) / freqs.shape[0]

    # finite discs with parallax (f32-faithful dots: see _texture's
    # precision note — the disc test operates within one bf16 ulp of 1.0)
    p_world = centers * dists[:, None]
    rel = p_world - c[None, :]
    dist_c = jnp.linalg.norm(rel, axis=-1)
    dir_world = rel / jnp.maximum(dist_c[:, None], 1e-6)
    ang = jnp.arcsin(jnp.clip(radii * dists / jnp.maximum(dist_c, 1e-6), 0.0, 1.0))
    dots = hp_einsum("...c,kc->...k", v_world, dir_world)
    inside = (dots > jnp.cos(ang)).astype(b.dtype)
    discs = jnp.einsum("...k,kc->...c", inside, colors)

    img = 0.5 + 1.5 * base + 0.5 * discs
    return (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)


def translation_pair(key, euler, t, height=128, width=256,
                     min_dist=2.0, max_dist=6.0):
    """(left, right, R_gt, t_gt): a TRUE two-view pair with parallax.

    Left camera is the identity at the origin; the right camera has
    rotation R_gt = euler_to_matrix(euler) and translation t_gt in the BA
    convention p_right = R_gt X - t_gt. Disc world points X with left
    bearing b_l = X/|X| appear in the right image along
    b_r = (R_gt X - t_gt)/|..| — exactly the two-view residual model
    (spherical_bundle_adjuster.cpp:844-868), so recovered (r, t, d) have
    metric ground truth.
    """
    from ..core import rotation as rot

    R = rot.euler_to_matrix(jnp.asarray(euler, jnp.float32))
    aa = rot.matrix_to_angle_axis(R)
    t = jnp.asarray(t, jnp.float32)
    left = render_erp_at(
        key, jnp.zeros(6, jnp.float32), height, width, min_dist, max_dist
    )
    right = render_erp_at(
        key, jnp.concatenate([aa, t]), height, width, min_dist, max_dist
    )
    return left, right, R, t


def render_trajectory(key, poses_aa_t, height=128, width=256,
                      min_dist=2.0, max_dist=6.0):
    """Stack of ERP frames along a camera trajectory (N, 6) [aa | t] —
    the multi-keyframe fixture with exact GT poses and parallax."""
    fn = partial(render_erp_at, key, height=height, width=width,
                 min_dist=min_dist, max_dist=max_dist)
    return jnp.stack([fn(poses_aa_t[i]) for i in range(poses_aa_t.shape[0])])


def rotation_pair(key, euler, height=128, width=256):
    """(left, right, R_gt) with the reference eval's GT convention
    (test/feature_test.cpp:36-62): a scene point seen along left bearing
    b_l appears in the right image along b_r = R_gt @ b_l, where
    R_gt = euler_to_matrix(euler).

    Derivation: render_erp(K) shows texture point p at the pixel whose
    bearing is K^T p; rendering the right view with K = R_gt^T therefore
    places p at b_r = R_gt b_l.
    """
    from ..core import rotation as rot

    R = rot.euler_to_matrix(jnp.asarray(euler, jnp.float32))
    eye = jnp.eye(3, dtype=jnp.float32)
    left = render_erp(key, eye, height, width)
    right = render_erp(key, R.T, height, width)
    return left, right, R


def multiview_problem(C=4, L=64, P=4, noise=0.0, pose_noise=0.05, seed=0):
    """Multi-keyframe BA fixture: cameras on a small trajectory, landmarks
    on a shell, every landmark observed by P random cameras.

    Returns (MultiViewProblem with a noisy init, GT poses (C, 6) f32,
    GT landmarks (L, 3) f32). Camera 0 is the identity (the gauge).
    """
    import numpy as np

    from ..models import multiview as mv

    rng = np.random.default_rng(seed)
    aa = rng.uniform(-0.1, 0.1, (C, 3))
    aa[0] = 0
    t = rng.uniform(-0.3, 0.3, (C, 3))
    t[0] = 0
    poses_gt = np.concatenate([aa, t], axis=-1).astype(np.float32)

    X = rng.normal(size=(L, 3))
    X = X / np.linalg.norm(X, axis=-1, keepdims=True) * rng.uniform(3, 7, (L, 1))
    X = X.astype(np.float32)

    obs_cam = np.stack([rng.choice(C, P, replace=False) for _ in range(L)]).astype(
        np.int32
    )
    poses_j = jnp.asarray(poses_gt)
    p = mv.transform_point(poses_j[obs_cam], jnp.asarray(X)[:, None, :])
    b = p / jnp.linalg.norm(p, axis=-1, keepdims=True)
    if noise > 0:
        b = b + noise * rng.normal(size=b.shape).astype(np.float32)
        b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)

    poses0 = poses_gt + rng.normal(scale=pose_noise, size=poses_gt.shape).astype(
        np.float32
    )
    poses0[0] = poses_gt[0]
    X0 = X + rng.normal(scale=0.1, size=X.shape).astype(np.float32)

    prob = mv.MultiViewProblem(
        poses=jnp.asarray(poses0),
        landmarks=jnp.asarray(X0),
        obs_cam=jnp.asarray(obs_cam),
        obs_bearing=jnp.asarray(b, jnp.float32),
        obs_valid=jnp.ones((L, P), bool),
        lm_valid=jnp.ones((L,), bool),
    )
    return prob, poses_gt, X
