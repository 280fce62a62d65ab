"""Spherical feature front-ends: the reference's three interchangeable
`do_all` strategies (SURVEY.md L4) re-designed batch-first.

All three return the same `FrontendResult` contract (the 7-argument
do_all signature of spherical_surf.hpp:13 / equi2cube_surf.hpp:13 /
feature_matcher.hpp:37, made functional):

  * erp_frontend   — SURF directly on the full ERP pair (C5)
  * band_frontend  — 4 distortion-reduced rotated latitude bands per image
                     (the ACTIVE strategy, spherical_surf.cpp:125-240);
                     here the 8 bands run as ONE vmapped detect/describe
  * cubemap_frontend — ERP->cubemap strip + SURF (C7); per-image keypoint
                     sizing fixes the reference's left-count bug
                     (equi2cube_surf.cpp:96-104, SURVEY.md C7 quirk)

Static shapes: keypoint banks have capacity K per band/image; matches have
capacity M with validity masks.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import cube
from ..ops import integral, match, surf, warp
from ..utils.config import PipelineConfig


class FrontendResult(NamedTuple):
    """Matched keypoints in ERP pixel coordinates (static capacity M)."""

    left_xy: jax.Array      # (M, 2)
    right_xy: jax.Array     # (M, 2)
    match_valid: jax.Array  # (M,) bool
    match_distance: jax.Array  # (M,)
    total_keypoints: jax.Array  # scalar: valid left keypoints (reference
    # counts the left bank: spherical_surf.cpp:239, feature_matcher.cpp:127)

    @property
    def match_count(self):
        return jnp.sum(self.match_valid.astype(jnp.int32))


def _match_banks(xy_l, desc_l, valid_l, xy_r, desc_r, valid_r, cfg: PipelineConfig):
    mt = match.match_descriptors(desc_l, valid_l, desc_r, valid_r, cfg=cfg.match)
    left_xy = xy_l[mt.query_idx]
    right_xy = xy_r[mt.train_idx]
    mv = mt.valid
    return FrontendResult(
        left_xy=jnp.where(mv[:, None], left_xy, 0.0),
        right_xy=jnp.where(mv[:, None], right_xy, 0.0),
        match_valid=mv,
        match_distance=mt.distance,
        total_keypoints=jnp.sum(valid_l.astype(jnp.int32)),
    )


@partial(jax.jit, static_argnames=("cfg",))
def erp_frontend(im_left, im_right, cfg: PipelineConfig = PipelineConfig()):
    """Naive full-ERP SURF + match (feature_matcher::do_all, C5)."""
    imgs = jnp.stack([im_left, im_right])
    kp, desc = jax.vmap(lambda im: surf.detect_and_describe(im, cfg.surf))(imgs)
    return _match_banks(
        kp.xy[0], desc[0], kp.valid[0], kp.xy[1], desc[1], kp.valid[1], cfg
    )


@partial(jax.jit, static_argnames=("cfg",))
def band_frontend(im_left, im_right, cfg: PipelineConfig = PipelineConfig()):
    """Band-rotation front-end — the ACTIVE production strategy (C6).

    Ladder selection (FrontendConfig.band_ladder): "parity" runs the
    reference's 4-pitch ladder, "dense" the 22.5-deg ladder, and "auto"
    (default) runs parity and falls back to dense via lax.cond when fewer
    than auto_min_matches matches survive — the reference ladder's
    documented intermediate-pitch cliff (QUALITY.md: 4.3 matches / 36.7%
    outliers at GT pitch 30 deg) without paying dense cost on easy scenes.
    """
    from ..utils.config import DENSE_BAND_PITCHES

    fcfg = cfg.frontend
    if fcfg.band_ladder == "parity":
        return _band_frontend_pitches(
            im_left, im_right, cfg, fcfg.band_pitches_deg
        )
    if fcfg.band_ladder == "dense":
        return _band_frontend_pitches(im_left, im_right, cfg, DENSE_BAND_PITCHES)
    if fcfg.band_ladder != "auto":
        raise ValueError(f"unknown band_ladder {fcfg.band_ladder!r}")
    fr_p = _band_frontend_pitches(im_left, im_right, cfg, fcfg.band_pitches_deg)
    return jax.lax.cond(
        fr_p.match_count < fcfg.auto_min_matches,
        lambda: _band_frontend_pitches(
            im_left, im_right, cfg, DENSE_BAND_PITCHES
        ),
        lambda: fr_p,
    )


def _band_frontend_pitches(im_left, im_right, cfg: PipelineConfig, pitch_list):
    """Band front-end at a fixed pitch ladder.

    Crops the pitch-rotated equatorial bands for both images, runs
    detect/describe over all bands as one vmapped batch, maps keypoints
    back to ERP coordinates with the inverse band rotation
    (spherical_surf.cpp:180-193), concatenates banks, matches once.
    """
    h, w = im_left.shape[0], im_left.shape[1]
    pitches = jnp.deg2rad(jnp.asarray(pitch_list, jnp.float32))
    n_bands = pitches.shape[0]

    # Grayscale BEFORE warping: detection only needs luma, and pointwise
    # conversion commutes exactly with floor/nearest gathers — 3x less
    # gather traffic than cropping RGB.
    gray_l = integral.rgb_to_gray(im_left)
    gray_r = integral.rgb_to_gray(im_right)

    # Static zero-pitch fast path: the 0-degree band is a pure row slice
    # (the reference also takes a plain ROI there, spherical_surf.cpp:
    # 130-139) — skipping its gather saves ~1/4 of the crop stage's
    # gathers. crop_rotated_band at pitch 0 floors
    # identity coordinates, so the slice is bit-identical.
    nonzero = [p for p in pitch_list if p != 0.0]
    nz_rad = jnp.deg2rad(jnp.asarray(nonzero, jnp.float32))

    def crop_all(im):
        warped = jax.vmap(
            lambda p: warp.crop_rotated_band(im, p, cfg.frontend.resample_mode)
        )(nz_rad) if nonzero else None
        r0 = 3 * h // 8
        outs = []
        wi = 0
        for p in pitch_list:
            if p == 0.0:
                outs.append(im[r0 : r0 + h // 4])
            else:
                outs.append(warped[wi])
                wi += 1
        return jnp.stack(outs)

    bands = jnp.concatenate([crop_all(gray_l), crop_all(gray_r)])  # (2B, H/4, W)
    kp, desc = jax.vmap(lambda im: surf.detect_and_describe(im, cfg.surf))(bands)

    # Map band-local keypoints back to ERP coordinates (vmapped over bands).
    pitches2 = jnp.concatenate([pitches, pitches])
    xy_erp = jax.vmap(lambda xy, p: warp.band_pixel_to_erp(xy, p, w, h))(
        kp.xy, pitches2
    )  # (2B, K, 2)

    k = cfg.surf.max_keypoints

    def flatten_image(i0):
        xy = xy_erp[i0 : i0 + n_bands].reshape(n_bands * k, 2)
        dsc = desc[i0 : i0 + n_bands].reshape(n_bands * k, -1)
        val = kp.valid[i0 : i0 + n_bands].reshape(n_bands * k)
        return xy, dsc, val

    xy_l, desc_l, valid_l = flatten_image(0)
    xy_r, desc_r, valid_r = flatten_image(n_bands)
    return _match_banks(xy_l, desc_l, valid_l, xy_r, desc_r, valid_r, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def cubemap_frontend(im_left, im_right, cfg: PipelineConfig = PipelineConfig()):
    """Cubemap front-end (C7): ERP->6-face strip, SURF on the strip, then
    cube->ERP keypoint remap (equi2cube_surf.cpp:78-122), sized per image
    (the reference's left-count sizing bug is fixed by construction)."""
    h, w = im_left.shape[0], im_left.shape[1]
    s = cfg.frontend.cube_size
    strips = jnp.stack(
        [
            warp.equi_to_cubemap(integral.rgb_to_gray(im_left), s, cfg.frontend.resample_mode),
            warp.equi_to_cubemap(integral.rgb_to_gray(im_right), s, cfg.frontend.resample_mode),
        ]
    )
    kp, desc = jax.vmap(lambda im: surf.detect_and_describe(im, cfg.surf))(strips)
    xy_erp = jax.vmap(lambda xy: cube.cube_pixel_to_erp_pixel(xy, s, w, h))(kp.xy)
    return _match_banks(
        xy_erp[0], desc[0], kp.valid[0], xy_erp[1], desc[1], kp.valid[1], cfg
    )


FRONTENDS = {
    "erp": erp_frontend,
    "band": band_frontend,
    "cubemap": cubemap_frontend,
}
