"""Native library tests: codecs, threaded loader, and golden agreement
between the f32 JAX solvers and the f64 reference-convention oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spherical_ba.utils import native

@pytest.fixture(autouse=True)
def _native_lib():
    """Build (at first use) and load the native library; decided here and
    not at import, so collecting this module compiles nothing."""
    if not native.available():
        pytest.skip("native library unavailable (no C++ toolchain)")


def synth(n=64, euler=(0.08, -0.12, 0.2), t=(0.2, 0.1, -0.05), seed=0):
    from spherical_ba.core import rotation

    rng = np.random.default_rng(seed)
    b1 = rng.normal(size=(n, 3))
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    d1 = rng.uniform(2, 6, n)
    R = np.asarray(rotation.euler_to_matrix(jnp.asarray(euler)), np.float64)
    x2 = (R @ (b1 * d1[:, None]).T).T - np.asarray(t)
    d2 = np.linalg.norm(x2, axis=-1)
    b2 = x2 / d2[:, None]
    return b1, b2, d1, d2, R, np.asarray(t)


class TestCodecs:
    def test_png_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
        p = str(tmp_path / "x.png")
        assert native.save_png_native(p, img)
        back = native.load_image_native(p)
        np.testing.assert_array_equal(back, img)

    def test_loader_prefetch(self, tmp_path):
        rng = np.random.default_rng(2)
        imgs = [rng.integers(0, 255, (16, 24, 3), dtype=np.uint8) for _ in range(6)]
        paths = []
        for i, im in enumerate(imgs):
            p = str(tmp_path / f"{i}.png")
            native.save_png_native(p, im)
            paths.append(p)
        ld = native.NativeImageLoader(paths, n_threads=2)
        seen = {}
        for idx, arr in ld:
            seen[idx] = arr
        ld.close()
        assert len(seen) == 6
        for i, im in enumerate(imgs):
            np.testing.assert_array_equal(seen[i], im)

    def test_io_module_uses_native(self, tmp_path):
        from spherical_ba.utils import io

        rng = np.random.default_rng(3)
        img = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
        p = str(tmp_path / "y.png")
        native.save_png_native(p, img)
        np.testing.assert_array_equal(io.load_image(p), img)


class TestGoldenOracle:
    def test_eight_point_agrees(self):
        """f32 JAX essential estimation vs f64 oracle on the same sample."""
        from spherical_ba.solver import epipolar

        b1, b2, _, _, R, t = synth()
        w = jnp.ones(b1.shape[0])
        E = epipolar.essential_from_bearings(
            jnp.asarray(b1, jnp.float32), jnp.asarray(b2, jnp.float32), w
        )
        r1, r2, tt = epipolar.decompose_essential(E)
        from spherical_ba.core import rotation

        e_jax = np.stack(
            [np.asarray(rotation.matrix_to_euler(r1)), np.asarray(rotation.matrix_to_euler(r2))]
        )
        e1_o, e2_o, t_o, v1, v2 = native.oracle_eight_point(b1, b2)
        e_orc = np.stack([e1_o, e2_o])
        # The twisted-pair branch depends on the SVD sign convention
        # (E vs -E give the same valid solution but different discarded
        # twins), so compare only the VALID candidates — the ones the
        # 1.57-rad filter lets the pipeline observe.
        valid_orc = [e for e, v in zip(e_orc, (v1, v2)) if v]
        assert valid_orc, "oracle produced no valid candidate"
        for eo in valid_orc:
            best = np.linalg.norm(e_jax - eo, axis=-1).min()
            assert best < 5e-3, f"oracle euler {eo} not found in jax {e_jax}"
        # translation axis agreement up to sign
        assert abs(abs(float(np.dot(np.asarray(tt), t_o))) - 1.0) < 1e-3

    def test_bcd_agrees(self):
        """f32 JAX BCD stages vs f64 oracle BCD from the same init."""
        from spherical_ba.core import rotation
        from spherical_ba.solver import lm
        from spherical_ba.utils.config import BaConfig

        b1, b2, d1, d2, R, t = synth()
        aa = np.asarray(
            rotation.matrix_to_angle_axis(jnp.asarray(R, jnp.float32)), np.float64
        )
        rot0 = aa + 0.02
        tran0 = t + 0.02
        d0 = np.stack([d1, d2], -1) + 0.2

        rot_o, tran_o, d_o = native.oracle_bcd(
            b1, b2, rot0, tran0, d0, iters=50, compat=False
        )

        cfg = BaConfig(reference_compat=False)
        valid = jnp.ones(b1.shape[0], bool)
        j32 = lambda a: jnp.asarray(a, jnp.float32)
        d_j, _ = lm.solve_depths(j32(b1), j32(b2), j32(d0), j32(rot0), j32(tran0), valid, cfg)
        rot_j, _ = lm.solve_rotation(j32(b1), j32(b2), d_j, j32(rot0), j32(tran0), valid, cfg)
        tran_j, _ = lm.solve_translation(j32(b1), j32(b2), d_j, rot_j, j32(tran0), valid, cfg)

        # Both must land near the ground truth; agreement bound covers
        # f32-vs-f64 and barrier-strength differences.
        np.testing.assert_allclose(np.asarray(rot_j), rot_o, atol=2e-2)
        np.testing.assert_allclose(np.asarray(tran_j), tran_o, atol=3e-2)
