"""Tests for the gather-based resampler: equi2cube, band-crop, rotation."""

import numpy as np
import jax.numpy as jnp

from spherical_ba.core import rotation
from spherical_ba.ops import warp


def _synthetic_erp(h=64, w=128, c=3, seed=0):
    rng = np.random.default_rng(seed)
    # smooth-ish image so bilinear/nearest agree approximately
    img = rng.integers(0, 255, (h, w, c), dtype=np.uint8)
    return jnp.asarray(img)


def _reference_equi2cube_face_pixel(im, face, i, j, cube_size):
    """Scalar oracle transcribing the reference math (equi2cube.cpp)."""
    s = cube_size
    u = (s - 2.0 * j) / s
    v = (s - 2.0 * i) / s
    rays = {
        0: (u, 1.0, v),        # left
        1: (-1.0, u, v),       # front
        2: (-u, -1.0, v),      # right
        3: (1.0, -u, v),       # back
        4: (v, u, 1.0),        # top
        5: (-v, u, -1.0),      # bottom
    }
    x, y, z = rays[face]
    n = np.sqrt(x * x + y * y + z * z)
    x, y, z = x / n, y / n, z / n
    theta = np.arccos(z)
    phi = np.arctan2(y, x)
    if phi < 0:
        phi += 2 * np.pi
    h, w = im.shape[:2]
    py = int(h * theta / np.pi)
    px = int(w * phi / (2 * np.pi))
    py = min(py, h - 1)
    px = min(px, w - 1)
    return np.asarray(im)[py, px]


def test_equi_to_cubemap_matches_scalar_oracle():
    im = _synthetic_erp()
    s = 16
    strip = np.asarray(warp.equi_to_cubemap(im, s))
    assert strip.shape == (s, 6 * s, 3)
    rng = np.random.default_rng(1)
    for _ in range(50):
        face = rng.integers(0, 6)
        i = int(rng.integers(0, s))
        j = int(rng.integers(0, s))
        expected = _reference_equi2cube_face_pixel(im, face, i, j, s)
        got = strip[i, face * s + j]
        np.testing.assert_array_equal(got, expected)


def test_crop_rotated_band_shape_and_zero_pitch_identity():
    im = _synthetic_erp(h=64, w=128)
    band = np.asarray(warp.crop_rotated_band(im, jnp.float32(0.0)))
    assert band.shape == (16, 128, 3)
    # pitch=0: identity rotation, band == rows [3H/8, 5H/8)
    np.testing.assert_array_equal(band, np.asarray(im)[24:40])


def test_rotate_erp_inverse_recovers_image():
    # rotate by R then by R^{-1}: pixels away from the poles recover.
    im = _synthetic_erp(h=64, w=128)
    euler = jnp.array([0.1, 0.3, -0.2])
    R = rotation.euler_to_matrix(euler)
    fwd = warp.rotate_erp(im, R, mode="bilinear")
    back = warp.rotate_erp(fwd, jnp.linalg.inv(R), mode="bilinear")
    mid = slice(20, 44)  # equatorial band, avoids pole degeneracy
    err = np.abs(
        np.asarray(back)[mid].astype(np.float32)
        - np.asarray(im)[mid].astype(np.float32)
    )
    # bilinear blur accumulates; just require gross agreement
    assert np.median(err) < 40

def test_band_pixel_to_erp_inverts_crop_coords():
    # A feature at band pixel p came from ERP pixel q; band_pixel_to_erp(p)
    # must return q (floor-rounded by the crop's sampling).
    im_h, im_w = 64, 128
    pitch = jnp.float32(np.deg2rad(45.0))
    coords = warp.erp_rotation_coords(
        rotation.euler_to_matrix(jnp.array([0.0, float(pitch), 0.0])),
        im_w, im_h, 3 * im_h // 8, im_h // 4,
    )
    band_xy = jnp.asarray([[10.0, 5.0], [100.0, 12.0], [64.0, 0.0]])
    got = warp.band_pixel_to_erp(band_xy, pitch, im_w, im_h)
    for (bx, by), g in zip(np.asarray(band_xy), np.asarray(got)):
        src = np.asarray(coords)[int(by), int(bx)]
        np.testing.assert_allclose(g, src, atol=1e-3)


def test_equi_to_cube_face_matches_strip():
    """Single-face getters (equi2cube.hpp:24-30 parity): each face equals
    its slice of the 6-face strip."""
    from spherical_ba.core.cube import FACE_NAMES

    im = _synthetic_erp()
    s = 16
    strip = np.asarray(warp.equi_to_cubemap(im, s))
    for f, name in enumerate(FACE_NAMES):
        face = np.asarray(warp.equi_to_cube_face(im, name, s))
        np.testing.assert_array_equal(face, strip[:, f * s : (f + 1) * s])
