"""Rotation representations: Euler (XYZ extrinsic, R = Rz @ Ry @ Rx),
rotation matrices, and angle-axis (Rodrigues).

The reference conflates Euler vectors and angle-axis vectors in one place
(spherical_bundle_adjuster.cpp:330 feeds a negated Euler triple to
ceres::AngleAxisRotatePoint). Here every representation has an explicit,
separately named API; the compat shim for that quirk lives in the two-view
pipeline, not in this module.

Euler convention (matches reference spherical_surf.cpp:18-45):
  euler = (rx, ry, rz);  R = Rz(rz) @ Ry(ry) @ Rx(rx).
Inverse (matches rot2euler, spherical_bundle_adjuster.cpp:25-45):
  rx = atan2(R21, R22), ry = atan2(-R20, sy), rz = atan2(R10, R00),
  with the sy < 1e-6 gimbal-lock branch.

All functions broadcast over leading batch dims and are vmap/jit-safe.
"""

from __future__ import annotations

import jax.numpy as jnp

from .precision import matmul as hp_matmul


def euler_to_matrix(euler):
    """(..., 3) Euler (rx, ry, rz) -> (..., 3, 3) rotation, R = Rz@Ry@Rx."""
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = jnp.cos(rx), jnp.sin(rx)
    cy, sy = jnp.cos(ry), jnp.sin(ry)
    cz, sz = jnp.cos(rz), jnp.sin(rz)
    # Rows of Rz @ Ry @ Rx, expanded analytically (one fused elementwise op
    # instead of three matmuls).
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    rows = [
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def matrix_to_euler(R):
    """(..., 3, 3) -> (..., 3) Euler, with the reference's gimbal branch."""
    sy = jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    rx = jnp.where(
        singular,
        jnp.arctan2(-R[..., 1, 2], R[..., 1, 1]),
        jnp.arctan2(R[..., 2, 1], R[..., 2, 2]),
    )
    ry = jnp.arctan2(-R[..., 2, 0], sy)
    rz = jnp.where(singular, 0.0, jnp.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return jnp.stack([rx, ry, rz], axis=-1)


def angle_axis_to_matrix(aa):
    """Rodrigues: (..., 3) angle-axis -> (..., 3, 3) rotation matrix.

    Uses the sinc-stable small-angle form so it is differentiable at 0.
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    theta = jnp.sqrt(theta2 + 1e-32)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks near zero.
    small = theta2[..., 0] < 1e-12
    s = jnp.where(small, 1.0 - theta2[..., 0] / 6.0, jnp.sin(theta[..., 0]) / theta[..., 0])
    c = jnp.where(
        small,
        0.5 - theta2[..., 0] / 24.0,
        (1.0 - jnp.cos(theta[..., 0])) / jnp.maximum(theta2[..., 0], 1e-32),
    )
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zero = jnp.zeros_like(x)
    K = jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), K.shape)
    return (
        eye
        + s[..., None, None] * K
        + c[..., None, None] * hp_matmul(K, K)
    )


def rotate_angle_axis(aa, v):
    """Rotate vectors v (..., 3) by angle-axis aa (..., 3).

    Equivalent to ceres::AngleAxisRotatePoint (the BA residual's rotation op,
    spherical_bundle_adjuster.cpp:857). Uses the Rodrigues vector formula
    directly — cheaper than materializing the matrix under vmap/autodiff.
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    theta = jnp.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-12
    s = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    c = jnp.where(small, theta2 / 2.0, 1.0 - jnp.cos(theta))
    # v_rot = v*cos + (w x v)*sin + w*(w.v)*(1-cos), w = aa/theta
    w = aa / theta
    wxv = jnp.cross(w, v)
    wdv = jnp.sum(w * v, axis=-1, keepdims=True)
    cos_t = 1.0 - c
    return v * cos_t + wxv * s * theta + w * wdv * c


def matrix_to_angle_axis(R):
    """(..., 3, 3) -> (..., 3) angle-axis (log map).

    Differentiable at the identity: theta is computed via atan2 (arccos has
    an infinite derivative at cos=1, which poisons jacfwd even through a
    masking `where`), and the theta/(2 sin) factor uses the double-where
    pattern so the singular branch never contributes NaN tangents.
    Stable for theta away from pi (pose-graph/BA increments are small).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = (trace - 1.0) / 2.0
    # axis * 2 sin(theta), from the skew-symmetric part
    ax = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin2 = jnp.sum(ax * ax, axis=-1) / 4.0
    small = sin2 < 1e-12
    sin_t = jnp.sqrt(jnp.where(small, 1.0, sin2))  # safe sqrt (double-where)
    theta = jnp.arctan2(
        jnp.where(small, 0.0, sin_t), jnp.clip(cos_t, -1.0, 1.0)
    )
    scale = jnp.where(
        small,
        0.5 + theta * theta / 12.0,  # Taylor of theta/(2 sin theta)
        theta / (2.0 * sin_t),
    )
    return ax * scale[..., None]


def euler_to_angle_axis(euler):
    """Exact Euler -> angle-axis conversion (the correct version of the
    reference's `-euler` shortcut at spherical_bundle_adjuster.cpp:330)."""
    return matrix_to_angle_axis(euler_to_matrix(euler))
