"""Gather-based image resampling: the single kernel behind ERP->cubemap,
rotated band-crop, and general spherical rotation warps.

The reference implements these as six+ separate OpenMP per-pixel loops with
scalar trig (equi2cube.cpp, spherical_surf.cpp:76-108). Here each warp is
one fused elementwise coordinate computation followed by one batched gather;
XLA vectorizes the trig and fuses it into the gather.

Sampling modes:
  * "floor"    — integer truncation, bit-matching the reference's
                 nearest-neighbor convention (equi2cube.cpp:46-50).
  * "nearest"  — round-to-nearest.
  * "bilinear" — 4-tap bilinear (quality option; the reference has none).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import cube, rotation, sphere
from ..core.precision import einsum as hp_einsum, matmul as hp_matmul


def _gather_pixels(image, ix, iy):
    """image: (H, W, C) or (H, W); ix/iy int32 arrays of identical shape.

    Gathers through a flattened linear index (one 1-D gather)."""
    h, w = image.shape[0], image.shape[1]
    iy = jnp.clip(iy, 0, h - 1)
    ix = jnp.clip(ix, 0, w - 1)
    lin = iy * w + ix
    if image.ndim == 2:
        return jnp.take(image.reshape(-1), lin)
    return jnp.take(image.reshape(h * w, -1), lin, axis=0)


def resample(image, coords, mode: str = "floor"):
    """Sample `image` at fractional pixel `coords` (..., 2) = (x, y).

    Returns an array of shape coords.shape[:-1] + image.shape[2:].
    """
    x = coords[..., 0]
    y = coords[..., 1]
    if mode == "floor":
        # The reference floors double-precision coordinates. In float32,
        # warp coordinates that are exactly integral in exact arithmetic
        # (e.g. identity rotations) land a few ulps below the integer; a
        # sub-pixel epsilon keeps floor() parity without visible bias.
        eps = 2e-3
        return _gather_pixels(
            image,
            jnp.floor(x + eps).astype(jnp.int32),
            jnp.floor(y + eps).astype(jnp.int32),
        )
    if mode == "nearest":
        return _gather_pixels(
            image,
            jnp.round(x).astype(jnp.int32),
            jnp.round(y).astype(jnp.int32),
        )
    if mode == "bilinear":
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = (x - x0)[..., None] if image.ndim == 3 else (x - x0)
        fy = (y - y0)[..., None] if image.ndim == 3 else (y - y0)
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)
        p00 = _gather_pixels(image, x0i, y0i).astype(jnp.float32)
        p01 = _gather_pixels(image, x0i + 1, y0i).astype(jnp.float32)
        p10 = _gather_pixels(image, x0i, y0i + 1).astype(jnp.float32)
        p11 = _gather_pixels(image, x0i + 1, y0i + 1).astype(jnp.float32)
        top = p00 * (1 - fx) + p01 * fx
        bot = p10 * (1 - fx) + p11 * fx
        out = top * (1 - fy) + bot * fy
        return out.astype(image.dtype) if jnp.issubdtype(image.dtype, jnp.integer) else out
    raise ValueError(f"unknown resample mode: {mode}")


@partial(jax.jit, static_argnames=("cube_size", "mode"))
def equi_to_cubemap(image, cube_size: int, mode: str = "floor"):
    """ERP image (H, W, C) -> cube strip (S, 6*S, C), faces in
    left|front|right|back|top|bottom order (equi2cube.cpp:282-302)."""
    h, w = image.shape[0], image.shape[1]
    rays = cube.face_rays(cube_size)  # (6, S, S, 3)
    tp = sphere.cartesian_to_spherical(
        rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
    )
    coords = sphere.spherical_to_pixel(tp, w, h)  # (6, S, S, 2)
    faces = resample(image, coords, mode)  # (6, S, S, C)
    return jnp.concatenate([faces[i] for i in range(6)], axis=1)


@partial(jax.jit, static_argnames=("face", "cube_size", "mode"))
def equi_to_cube_face(image, face: str, cube_size: int, mode: str = "floor"):
    """Extract ONE cube face (S, S, C) from an ERP image — the single-face
    getters equi2cube::get_back/front/left/right/top/bottom
    (equi2cube.hpp:24-30). `face` is a name from core.cube.FACE_NAMES."""
    h, w = image.shape[0], image.shape[1]
    f = cube.FACE_NAMES.index(face)
    rays = cube.face_rays(cube_size)[f]  # (S, S, 3)
    tp = sphere.cartesian_to_spherical(
        rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
    )
    coords = sphere.spherical_to_pixel(tp, w, h)
    return resample(image, coords, mode)


def erp_rotation_coords(R, width, height, row_start, num_rows, dtype=jnp.float32):
    """Source ERP coordinates for an inverse rotation warp of output rows
    [row_start, row_start + num_rows).

    Output pixel (row_start+i, j) maps through R exactly as the reference's
    rotate_pixel (spherical_surf.cpp:47-74): pixel -> (theta, phi) ->
    cartesian -> R @ v -> (theta, phi) wrapped -> pixel.
    """
    rows = row_start + jnp.arange(num_rows, dtype=dtype)
    cols = jnp.arange(width, dtype=dtype)
    xy = jnp.stack(jnp.meshgrid(cols, rows, indexing="xy"), axis=-1)
    v = sphere.pixel_to_bearing(xy, width, height)  # (num_rows, W, 3)
    v_rot = hp_einsum("rc,ijc->ijr", R.astype(dtype), v)
    return sphere.bearing_to_pixel(v_rot, width, height)


@partial(jax.jit, static_argnames=("mode",))
def rotate_erp(image, R, mode: str = "floor"):
    """Full-sphere rotation warp of an ERP image by rotation matrix R.

    Used to synthesize ground-truth rotated pairs for evaluation
    (the fixture implied by test/feature_test.cpp's filename-encoded GT).
    """
    h, w = image.shape[0], image.shape[1]
    coords = erp_rotation_coords(R, w, h, 0, h)
    return resample(image, coords, mode)


@partial(jax.jit, static_argnames=("mode",))
def crop_rotated_band(image, pitch_rad, mode: str = "floor"):
    """Extract the H/4-tall equatorial band (rows [3H/8, 5H/8)) of the
    pitch-rotated sphere — the reference's crop_rotated_image
    (spherical_surf.cpp:76-108), one fused warp instead of a scalar loop.

    pitch_rad is a (possibly traced) scalar; R = euler2rot((0, pitch, 0)).
    """
    h, w = image.shape[0], image.shape[1]
    euler = jnp.stack(
        [jnp.zeros_like(pitch_rad), pitch_rad, jnp.zeros_like(pitch_rad)]
    )
    R = rotation.euler_to_matrix(euler)
    coords = erp_rotation_coords(R, w, h, 3 * h // 8, h // 4)
    return resample(image, coords, mode)


def band_pixel_to_erp(xy_band, pitch_rad, width, height):
    """Map keypoint pixels detected in a rotated band back to original ERP
    coordinates (spherical_surf.cpp:110-123): offset rows by 3H/8, then the
    same rotation mapping used by the crop. Batched over (..., 2)."""
    offset = jnp.asarray([0.0, 3.0 * height / 8.0], dtype=xy_band.dtype)
    euler = jnp.stack(
        [jnp.zeros_like(pitch_rad), pitch_rad, jnp.zeros_like(pitch_rad)]
    )
    R = rotation.euler_to_matrix(euler)
    v = sphere.pixel_to_bearing(xy_band + offset, width, height)
    v_rot = hp_matmul(v, R.T.astype(v.dtype))
    return sphere.bearing_to_pixel(v_rot, width, height)
