"""The XLA dense-map stages of SURF against a NumPy brute-force box-filter
reference: the det-of-Hessian pyramid and the packed Haar / trace-sign
maps. The reference sums pixels directly (sliding windows over a
zero-padded image, float64), sharing no code with the integral-image
formulation under test."""

import numpy as np
import jax.numpy as jnp
import pytest
from numpy.lib.stride_tricks import sliding_window_view

from spherical_ba.ops import integral, surf
from spherical_ba.utils.config import SurfConfig

CFG = SurfConfig(max_keypoints=64, n_octaves=2)
SHAPES = [(64, 96), (56, 128)]


def image(shape, seed=3):
    h, w = shape
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = 120 + 80 * np.sin(x / 7.0) * np.cos(y / 5.0) + rng.uniform(0, 40, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def box_sums(gray, y0, x0, y1, x1):
    """For every pixel (y, x): sum of gray over rows [y+y0, y+y1) and cols
    [x+x0, x+x1), clipped to the image — by direct summation."""
    h, w = gray.shape
    p = max(abs(y0), abs(y1), abs(x0), abs(x1)) + 1
    g = np.pad(gray.astype(np.float64), p)
    win = sliding_window_view(g, (y1 - y0, x1 - x0)).sum(axis=(-1, -2))
    return win[p + y0: p + y0 + h, p + x0: p + x0 + w]


def det_reference(gray, cfg):
    """Dense det-of-Hessian per (octave, layer) on the octave's stride
    grid, NaN outside the region where the filter fits."""
    h, w = gray.shape
    out = []
    for o in range(cfg.n_octaves):
        step = 1 << o
        layers = []
        for l in range(cfg.n_octave_layers + 2):
            size = (9 + 6 * l) << o
            half = size // 2

            def resp(base):
                return sum(
                    wt * box_sums(gray, y0 - half, x0 - half, y1 - half, x1 - half)
                    for (y0, x0, y1, x1, wt) in surf._scaled_pattern(base, size)
                )

            det = resp(surf._DXX9) * resp(surf._DYY9) - 0.81 * resp(surf._DXY9) ** 2
            ys = np.arange(h)[:, None]
            xs = np.arange(w)[None, :]
            inside = (ys >= half) & (ys <= h - (size - half)) & (xs >= half) & (
                xs <= w - (size - half)
            )
            layers.append(np.where(inside, det, np.nan)[::step, ::step])
        out.append(np.stack(layers))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_det_pyramid_matches_bruteforce(shape):
    gray = image(shape)
    got = surf._det_maps_per_octave(jnp.asarray(gray), CFG)
    ref = det_reference(gray, CFG)
    n_inside = 0
    for g, r in zip(got, ref):
        g = np.asarray(g, np.float64)
        assert g.shape == r.shape
        inside = np.isfinite(r)
        # outside the filter's support the map is -inf (NMS margin)
        assert np.all(np.isneginf(g[~inside]))
        n_inside += int(inside.sum())
        # f32 integral-image cancellation: box sums carry ~eps * ii_max
        # (~0.1 here) absolute error, and det is a product of two
        # area-normalized responses (|D| <~ 300), so a tolerance of 1e-4
        # of the largest |det| covers it with margin
        tol = 1e-4 * np.max(np.abs(r[inside]))
        np.testing.assert_allclose(g[inside], r[inside], rtol=0, atol=tol)
    assert n_inside > 1000


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_haar_trace_maps_match_bruteforce(shape):
    gray = image(shape)
    ii = integral.integral_image(jnp.asarray(gray))
    hx, hy = surf._unpack_haar(surf._dense_haar_maps(ii, CFG))
    trace = np.asarray(surf._dense_trace_sign_maps(ii, CFG))
    for qi, size in enumerate(surf._mid_layer_sizes(CFG)):
        r = max(int(round(2 * 1.2 * size / 9.0)), 1)
        hx_ref = box_sums(gray, -r, 0, r, r) - box_sums(gray, -r, -r, r, 0)
        hy_ref = box_sums(gray, 0, -r, r, r) - box_sums(gray, -r, -r, 0, r)
        # responses are stored as bf16 (8-bit mantissa: <= 2^-8 relative)
        # on top of the f32 box-sum noise
        for got, ref in ((hx[qi], hx_ref), (hy[qi], hy_ref)):
            np.testing.assert_allclose(
                np.asarray(got, np.float64), ref, rtol=2 ** -8, atol=0.5
            )
        half, t, b = size // 2, int(size / 3.0), int(2.0 * size / 9.0)
        tr = sum(
            wt * box_sums(gray, i * t - half, b - half, (i + 1) * t - half, size - b - half)
            for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))
        ) + sum(
            wt * box_sums(gray, b - half, i * t - half, size - b - half, (i + 1) * t - half)
            for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))
        )
        # the sign is defined wherever the trace clears the f32 noise
        clear = np.abs(tr) > 1.0
        np.testing.assert_array_equal(trace[qi][clear], np.sign(tr)[clear])
