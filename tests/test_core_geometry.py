"""Property tests for core geometry: round-trips and reference conventions."""

import numpy as np
import jax.numpy as jnp
import pytest

from spherical_ba.core import cube, rotation, sphere


class TestSphere:
    def test_pixel_spherical_roundtrip(self, rng):
        w, h = 256, 128
        xy = jnp.asarray(rng.uniform([0, 0], [w - 1e-3, h - 1e-3], (100, 2)))
        tp = sphere.pixel_to_spherical(xy, w, h)
        back = sphere.spherical_to_pixel(tp, w, h)
        np.testing.assert_allclose(back, xy, atol=1e-3)

    def test_cartesian_roundtrip(self, rng):
        tp = jnp.asarray(
            np.stack(
                [rng.uniform(0.01, np.pi - 0.01, 200), rng.uniform(0, 2 * np.pi, 200)],
                axis=-1,
            )
        )
        v = sphere.spherical_to_cartesian(tp)
        np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
        back = sphere.cartesian_to_spherical(v)
        np.testing.assert_allclose(back, tp, atol=1e-4)

    def test_bearing_matches_reference_formula(self):
        # spherical_bundle_adjuster.cpp:276-298: phi=2pi x/W, theta=pi y/H,
        # v = (sin t cos p, sin t sin p, cos t)
        w, h = 200, 100
        xy = jnp.array([[50.0, 25.0]])
        v = sphere.pixel_to_bearing(xy, w, h)
        t, p = np.pi * 25.0 / h, 2 * np.pi * 50.0 / w
        expected = [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)]
        np.testing.assert_allclose(np.asarray(v)[0], expected, atol=1e-6)

    def test_angular_distance(self):
        v1 = jnp.array([1.0, 0.0, 0.0])
        v2 = jnp.array([0.0, 1.0, 0.0])
        np.testing.assert_allclose(
            sphere.angular_distance(v1, v2), np.pi / 2, atol=1e-6
        )
        np.testing.assert_allclose(sphere.angular_distance(v1, v1), 0.0, atol=1e-6)


class TestRotation:
    def test_euler_matrix_roundtrip(self, rng):
        euler = jnp.asarray(rng.uniform(-1.2, 1.2, (50, 3)))
        R = rotation.euler_to_matrix(euler)
        # orthonormality
        eye = jnp.einsum("bij,bkj->bik", R, R)
        np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
        back = rotation.matrix_to_euler(R)
        np.testing.assert_allclose(back, euler, atol=1e-4)

    def test_euler_matches_rzryrx(self, rng):
        # R = Rz @ Ry @ Rx (spherical_surf.cpp:18-45)
        e = rng.uniform(-1, 1, 3)
        cx, sx = np.cos(e[0]), np.sin(e[0])
        cy, sy = np.cos(e[1]), np.sin(e[1])
        cz, sz = np.cos(e[2]), np.sin(e[2])
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R_ref = Rz @ Ry @ Rx
        R = rotation.euler_to_matrix(jnp.asarray(e))
        np.testing.assert_allclose(R, R_ref, atol=1e-6)

    def test_angle_axis_roundtrip(self, rng):
        aa = jnp.asarray(rng.uniform(-1.5, 1.5, (50, 3)))
        R = rotation.angle_axis_to_matrix(aa)
        back = rotation.matrix_to_angle_axis(R)
        np.testing.assert_allclose(back, aa, atol=1e-4)

    def test_rotate_angle_axis_matches_matrix(self, rng):
        aa = jnp.asarray(rng.uniform(-1.5, 1.5, (20, 3)))
        v = jnp.asarray(rng.normal(size=(20, 3)))
        R = rotation.angle_axis_to_matrix(aa)
        expected = jnp.einsum("bij,bj->bi", R, v)
        got = rotation.rotate_angle_axis(aa, v)
        np.testing.assert_allclose(got, expected, atol=1e-5)

    def test_rotate_angle_axis_zero(self):
        v = jnp.array([[1.0, 2.0, 3.0]])
        got = rotation.rotate_angle_axis(jnp.zeros((1, 3)), v)
        np.testing.assert_allclose(got, v, atol=1e-6)

    def test_euler_to_angle_axis_consistent(self, rng):
        e = jnp.asarray(rng.uniform(-1.0, 1.0, (10, 3)))
        aa = rotation.euler_to_angle_axis(e)
        np.testing.assert_allclose(
            rotation.angle_axis_to_matrix(aa),
            rotation.euler_to_matrix(e),
            atol=1e-5,
        )


class TestCube:
    def test_face_rays_reference_formulas(self):
        s = 8
        rays = np.asarray(cube.face_rays(s))
        i, j = 3, 5
        u = (s - 2.0 * j) / s
        v = (s - 2.0 * i) / s
        # left (equi2cube.cpp:117-120): (u, 1, v)
        np.testing.assert_allclose(rays[0, i, j], [u, 1, v], atol=1e-6)
        # front (:72-75): (-1, u, v)
        np.testing.assert_allclose(rays[1, i, j], [-1, u, v], atol=1e-6)
        # right (:162-165): (-u, -1, v)
        np.testing.assert_allclose(rays[2, i, j], [-u, -1, v], atol=1e-6)
        # back (:27-30): (1, -u, v)
        np.testing.assert_allclose(rays[3, i, j], [1, -u, v], atol=1e-6)
        # top (:207-210): (v, u, 1)
        np.testing.assert_allclose(rays[4, i, j], [v, u, 1], atol=1e-6)
        # bottom (:252-255): (-v, u, -1)
        np.testing.assert_allclose(rays[5, i, j], [-v, u, -1], atol=1e-6)

    def test_cube_pixel_to_bearing_matches_face_rays(self):
        s = 16
        rays = cube.face_rays(s)
        rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
        for f in range(6):
            xy = jnp.array([[f * s + 5.0, 3.0]])
            b = cube.cube_pixel_to_bearing(xy, s)
            np.testing.assert_allclose(
                np.asarray(b)[0], np.asarray(rays)[f, 3, 5], atol=1e-5
            )

    def test_cube_equi_roundtrip(self, rng):
        # equi2cube o cube2equi ~ id on pixel centers (SURVEY.md §4 property)
        s, w, h = 64, 512, 256
        xy = jnp.asarray(
            rng.uniform([0, 0], [6 * s - 1e-3, s - 1e-3], (500, 2))
        )
        bearings = cube.cube_pixel_to_bearing(xy, s)
        from spherical_ba.core import sphere as sp

        erp = cube.cube_pixel_to_erp_pixel(xy, s, w, h)
        back = sp.pixel_to_bearing(erp, w, h)
        ang = sp.angular_distance(bearings, back)
        assert float(jnp.max(ang)) < 1e-3
