"""Mesh helpers: 2-D mesh construction and the multi-process entry point
(single-process fallback path)."""

import jax
import numpy as np
import pytest

from spherical_ba.parallel import mesh as mesh_lib


class TestMesh:
    def test_make_mesh_1d(self):
        m = mesh_lib.make_mesh(2)
        assert m.shape == {"data": 2}

    def test_make_mesh_2d_shape_and_layout(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        m = mesh_lib.make_mesh_2d(2, 4)
        assert m.shape == {"pairs": 2, "data": 4}
        # inner (landmark/psum) axis gets contiguous devices — the ICI axis
        grid = np.asarray(m.devices)
        ids = np.asarray([[d.id for d in row] for row in grid])
        assert (np.diff(ids, axis=1) == 1).all()

    def test_make_mesh_2d_infers_inner(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        m = mesh_lib.make_mesh_2d(2)
        assert m.shape["pairs"] == 2
        assert m.shape["data"] == len(jax.devices()) // 2

    def test_make_mesh_2d_too_big(self):
        with pytest.raises(AssertionError):
            mesh_lib.make_mesh_2d(len(jax.devices()), 2)

    def test_init_distributed_single_process(self):
        # no cluster env: falls back to single-process, returns index 0,
        # and local meshes keep working afterwards
        assert mesh_lib.init_distributed() == 0
        assert mesh_lib.make_mesh(1).shape == {"data": 1}
