"""SURF feature detection and description as static-shape JAX.

Replaces OpenCV xfeatures2d::SURF (reference feature_matcher.cpp:6-40) with
a static-shape JAX implementation:

  * integral image  — two parallel prefix sums (ops.integral)
  * box-filter Hessian pyramid — dense det-of-Hessian maps for every
    octave/layer as shifted-slice arithmetic on the integral image (no
    gathers; XLA fuses each filter into one elementwise pass)
  * non-max suppression — `lax.reduce_window` max over (scale, y, x)
  * keypoint selection — one global `top_k` over all octaves with a fixed
    capacity and validity mask (static shapes for jit/vmap)
  * subpixel/scale refinement — batched 3x3 quadratic fit
  * orientation — Haar responses on a radius-6s disc, sliding pi/3 window
  * descriptor — 64-d (4x4 subregions x (sum dx, sum|dx|, sum dy, sum|dy|))
    from a rotated 21x21 patch sampled at spacing s, Gaussian-weighted,
    L2-normalized

Filter geometry follows the OpenCV convention the reference depends on:
filter sizes (9 + 6*layer) << octave, area-normalized box weights,
det = Dxx*Dyy - (0.9*Dxy)^2, hessianThreshold default 100
(feature_matcher.cpp:13: SURF::create() defaults).

SURF implementations never bit-match each other; parity is validated by
match-quality metrics (outlier% @ 2 deg, SURVEY.md §4), not identical
keypoints.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import smallmat
from ..utils.config import SurfConfig
from . import integral


# Base (size-9) box patterns, (y0, x0, y1, x1, weight), relative to the
# filter's top-left corner. Same geometry OpenCV scales from.
_DXX9 = [(2, 0, 7, 3, 1.0), (2, 3, 7, 6, -2.0), (2, 6, 7, 9, 1.0)]
_DYY9 = [(0, 2, 3, 7, 1.0), (3, 2, 6, 7, -2.0), (6, 2, 9, 7, 1.0)]
_DXY9 = [
    (1, 1, 4, 4, 1.0),
    (1, 5, 4, 8, -1.0),
    (5, 1, 8, 4, -1.0),
    (5, 5, 8, 8, 1.0),
]


def _round_half_even(v: float) -> int:
    return int(round(v))


def _scaled_pattern(base, size: int):
    """Scale a size-9 base pattern to `size`, area-normalizing weights."""
    ratio = size / 9.0
    out = []
    for (y0, x0, y1, x1, w) in base:
        sy0 = _round_half_even(ratio * y0)
        sx0 = _round_half_even(ratio * x0)
        sy1 = _round_half_even(ratio * y1)
        sx1 = _round_half_even(ratio * x1)
        area = max((sy1 - sy0) * (sx1 - sx0), 1)
        out.append((sy0, sx0, sy1, sx1, w / area))
    return out


def _filter_sizes(cfg: SurfConfig):
    """[(octave, layer, size)] for all octave layers (incl. NMS border
    layers 0 and n_octave_layers+1)."""
    sizes = []
    for o in range(cfg.n_octaves):
        for l in range(cfg.n_octave_layers + 2):
            sizes.append((o, l, (9 + 6 * l) << o))
    return sizes


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (K = cfg.max_keypoints).

    xy: (K, 2) float32 ERP/image pixel coords (x, y); size: (K,) filter
    size in pixels (OpenCV convention); response: (K,) det-of-Hessian;
    orientation: (K,) radians; laplacian: (K,) sign of trace; valid: (K,)
    bool mask — invalid slots carry zeros.
    """

    xy: jax.Array
    size: jax.Array
    response: jax.Array
    orientation: jax.Array
    laplacian: jax.Array
    valid: jax.Array

    @property
    def scale(self):
        """SURF scale s = size * 1.2 / 9 (OpenCV convention)."""
        return self.size * (1.2 / 9.0)


def _det_maps_per_octave(gray, cfg: SurfConfig):
    """Det-of-Hessian maps per octave, evaluated on the octave's stride
    grid (sampleStep = 1 << octave, OpenCV's scheme).

    Every box-corner read is a CONTIGUOUS shifted slice of the padded
    integral image: the det map is computed dense over the shifted window
    and subsampled ONCE per layer with a single strided slice. XLA fuses
    each layer's shifted reads and the elementwise det into one loop
    fusion, and the sampled values are bit-identical to a formulation
    that strides every corner slice (same ii_pad elements).

    Returns a list of (n_layers+2, H>>o, W>>o) arrays (with -inf margins).
    """
    h, w = gray.shape
    ii = integral.integral_image(gray)
    sizes = _filter_sizes(cfg)
    max_size = max(s for (_, _, s) in sizes)
    pad = max_size  # generous so all shifted slices stay in range
    ii_pad = jnp.pad(ii, ((pad, pad), (pad, pad)), mode="edge")

    n_l = cfg.n_octave_layers + 2
    out = []
    for o in range(cfg.n_octaves):
        step = 1 << o
        oh = (h + step - 1) // step
        ow = (w + step - 1) // step
        # dense window covering all strided sample points
        dh = (oh - 1) * step + 1
        dw = (ow - 1) * step + 1

        layer_maps = []
        for l in range(n_l):
            size = (9 + 6 * l) << o
            half = size // 2

            def dense_sums(boxes):
                acc = None
                for (y0, x0, y1, x1, wt) in boxes:
                    oy0 = y0 + pad - half
                    ox0 = x0 + pad - half
                    oy1 = y1 + pad - half
                    ox1 = x1 + pad - half

                    def sl(dy, dx):
                        return jax.lax.slice(
                            ii_pad, (dy, dx), (dy + dh, dx + dw)
                        )

                    s = sl(oy1, ox1) - sl(oy0, ox1) - sl(oy1, ox0) + sl(oy0, ox0)
                    term = wt * s
                    acc = term if acc is None else acc + term
                return acc

            dxx = dense_sums(_scaled_pattern(_DXX9, size))
            dyy = dense_sums(_scaled_pattern(_DYY9, size))
            dxy = dense_sums(_scaled_pattern(_DXY9, size))
            det = dxx * dyy - 0.81 * dxy * dxy
            if step > 1:
                det = det[::step, ::step]  # one strided subsample per layer
            ys = jnp.arange(oh)[:, None] * step
            xs = jnp.arange(ow)[None, :] * step
            inside = (
                (ys >= half)
                & (ys <= h - (size - half))
                & (xs >= half)
                & (xs <= w - (size - half))
            )
            layer_maps.append(jnp.where(inside, det, -jnp.inf))
        out.append(jnp.stack(layer_maps))
    return out


def _nms_candidates(det_list, cfg: SurfConfig):
    """Scores for middle layers that are 3x3x3 local maxima above the
    Hessian threshold on each octave's stride grid; -inf elsewhere.
    Returns a list of (n_mid, H>>o, W>>o)."""
    out = []
    for stack in det_list:
        n_l = stack.shape[0]
        neg_inf = jnp.array(-jnp.inf, stack.dtype)
        m = jax.lax.reduce_window(
            stack,
            neg_inf,
            jax.lax.max,
            window_dimensions=(3, 3, 3),
            window_strides=(1, 1, 1),
            padding=[(1, 1), (1, 1), (1, 1)],
        )
        mid = stack[1 : n_l - 1]
        is_max = (mid >= m[1 : n_l - 1]) & (mid > cfg.hessian_threshold)
        out.append(jnp.where(is_max, mid, -jnp.inf))
    return out


def _refine_and_pack(gray_shape, det_list, cand_list, cfg: SurfConfig):
    """Global top-K + subpixel/scale refinement -> Keypoints fields
    (without orientation/laplacian). Works on per-octave stride grids."""
    k = cfg.max_keypoints
    # Exact candidate-count reduction before top_k: NMS enforces a 3x3
    # spatial exclusion per layer, so any 2x2 block of one layer's grid
    # holds at most one maximum (two at L_inf distance 1 would each have to
    # exceed the other) — a 2x2 block-argmax loses nothing (ties aside) and
    # shrinks the top_k input 4x (bit-identical scores).
    red_list = []  # (n_mid, rh, rw) block maxima
    sub_list = []  # argmax-in-block in [0, 4): sub = 2*dy + dx
    for c in cand_list:
        n_mid, oh, ow = c.shape
        ph, pw = (oh + 1) // 2 * 2, (ow + 1) // 2 * 2
        gp = jnp.pad(
            c, ((0, 0), (0, ph - oh), (0, pw - ow)), constant_values=-jnp.inf
        )
        blk = gp.reshape(n_mid, ph // 2, 2, pw // 2, 2).transpose(0, 1, 3, 2, 4)
        blk = blk.reshape(n_mid, ph // 2, pw // 2, 4)
        red_list.append(jnp.max(blk, axis=-1))
        sub_list.append(jnp.argmax(blk, axis=-1).astype(jnp.int32))

    flats = [c.reshape(-1) for c in red_list]
    sizes = [f.shape[0] for f in flats]
    offsets = [0]
    for sz in sizes:
        offsets.append(offsets[-1] + sz)
    flat = jnp.concatenate(flats)
    scores, idx = jax.lax.top_k(flat, k)
    valid = jnp.isfinite(scores)

    # decode reduced flat index -> (octave, layer, gy, gx) with static
    # per-octave shapes (python loop over octaves, masked select)
    oct_i = jnp.zeros_like(idx)
    layer = jnp.zeros_like(idx)
    y = jnp.zeros_like(idx)
    x = jnp.zeros_like(idx)
    step_arr = jnp.zeros_like(idx)
    for o, (red, sub, c) in enumerate(zip(red_list, sub_list, cand_list)):
        n_mid, rh, rw = red.shape
        oh, ow = c.shape[1], c.shape[2]
        in_oct = (idx >= offsets[o]) & (idx < offsets[o + 1])
        local = jnp.clip(idx - offsets[o], 0, sizes[o] - 1)
        l_o = local // (rh * rw)
        rem = local % (rh * rw)
        by = rem // rw
        bx = rem % rw
        s_o = sub.reshape(-1)[local]
        y_o = jnp.minimum(by * 2 + s_o // 2, oh - 1)
        x_o = jnp.minimum(bx * 2 + s_o % 2, ow - 1)
        oct_i = jnp.where(in_oct, o, oct_i)
        layer = jnp.where(in_oct, l_o + 1, layer)
        y = jnp.where(in_oct, y_o, y)
        x = jnp.where(in_oct, x_o, x)
        step_arr = jnp.where(in_oct, 1 << o, step_arr)

    # 3x3x3 neighborhood on the octave's grid: the flat index is computed
    # with the keypoint's own octave shape (masked elementwise arithmetic)
    # and all 27 taps come from ONE take of the concatenated det buffer:
    # K*27 elements total instead of 3x that from per-octave takes.
    offs = [(dl, dy, dx) for dl in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    dls = jnp.asarray([o_[0] for o_ in offs], jnp.int32)[None, :]
    dys = jnp.asarray([o_[1] for o_ in offs], jnp.int32)[None, :]
    dxs = jnp.asarray([o_[2] for o_ in offs], jnp.int32)[None, :]
    det_flat = jnp.concatenate([s_.reshape(-1) for s_ in det_list])
    doff = [0]
    for s_ in det_list:
        doff.append(doff[-1] + s_.size)
    lin27 = jnp.zeros((idx.shape[0], 27), jnp.int32)
    for o, stack in enumerate(det_list):
        n_l, oh, ow = stack.shape
        ll = jnp.clip(layer[:, None] + dls, 0, n_l - 1)
        yy = jnp.clip(y[:, None] + dys, 0, oh - 1)
        xx = jnp.clip(x[:, None] + dxs, 0, ow - 1)
        lin = doff[o] + (ll * oh + yy) * ow + xx
        lin27 = jnp.where((oct_i == o)[:, None], lin, lin27)
    v27 = jnp.take(det_flat, lin27)
    n27 = jnp.where(jnp.isfinite(v27), v27, 0.0)

    def nb(dl, dy, dx):
        return n27[:, (dl + 1) * 9 + (dy + 1) * 3 + (dx + 1)]

    d000 = nb(0, 0, 0)
    # gradient
    gs = 0.5 * (nb(1, 0, 0) - nb(-1, 0, 0))
    gy = 0.5 * (nb(0, 1, 0) - nb(0, -1, 0))
    gx = 0.5 * (nb(0, 0, 1) - nb(0, 0, -1))
    # Hessian of the response surface
    hss = nb(1, 0, 0) + nb(-1, 0, 0) - 2 * d000
    hyy = nb(0, 1, 0) + nb(0, -1, 0) - 2 * d000
    hxx = nb(0, 0, 1) + nb(0, 0, -1) - 2 * d000
    hsy = 0.25 * (nb(1, 1, 0) - nb(1, -1, 0) - nb(-1, 1, 0) + nb(-1, -1, 0))
    hsx = 0.25 * (nb(1, 0, 1) - nb(1, 0, -1) - nb(-1, 0, 1) + nb(-1, 0, -1))
    hyx = 0.25 * (nb(0, 1, 1) - nb(0, 1, -1) - nb(0, -1, 1) + nb(0, -1, -1))

    H3 = jnp.stack(
        [
            jnp.stack([hss, hsy, hsx], -1),
            jnp.stack([hsy, hyy, hyx], -1),
            jnp.stack([hsx, hyx, hxx], -1),
        ],
        -2,
    )  # (K, 3, 3)
    g3 = jnp.stack([gs, gy, gx], -1)
    # damped closed-form 3x3 solve (core/smallmat); clamp offsets to +-1
    # sample
    eye = jnp.eye(3, dtype=H3.dtype) * 1e-6
    delta = -smallmat.solve3(H3 + eye, g3)
    delta = jnp.nan_to_num(jnp.clip(delta, -1.0, 1.0))

    stepf = step_arr.astype(jnp.float32)
    base_size = (9.0 + 6.0 * (layer.astype(jnp.float32))) * stepf
    size_step = 6.0 * stepf
    size = base_size + delta[:, 0] * size_step
    # grid coords -> image pixels: offsets scale by the octave stride
    xy = jnp.stack(
        [
            (x.astype(jnp.float32) + delta[:, 2]) * stepf,
            (y.astype(jnp.float32) + delta[:, 1]) * stepf,
        ],
        -1,
    )
    if cfg.subpixel_refine is False:
        size = base_size
        xy = jnp.stack(
            [x.astype(jnp.float32) * stepf, y.astype(jnp.float32) * stepf], -1
        )
    zero = jnp.zeros_like(size)
    xy = jnp.where(valid[:, None], xy, 0.0)
    return Keypoints(
        xy=xy,
        size=jnp.where(valid, size, 1.0),
        response=jnp.where(valid, scores, 0.0),
        orientation=zero,
        laplacian=zero,
        valid=valid,
    )


def _dense_trace_sign_maps(ii, cfg: SurfConfig):
    """Dense sign(Dxx + Dyy) maps for every middle-layer scale.

    Shape (Q, H, W) int8. Each layer's trace is 6 thirds-geometry boxes =
    24 shifted slices of the edge-padded integral image — fully fused by
    XLA, no gathers (same trick as _dense_haar_maps). Keypoints then read
    their sign with ONE gathered element instead of 24 corner reads per
    keypoint. The scale is quantized to the keypoint's
    detection layer — what OpenCV itself does (the trace is recorded at
    detection, before subpixel size refinement), so this is parity-
    faithful, not an approximation.
    """
    h = ii.shape[0] - 1
    w = ii.shape[1] - 1
    sizes = _mid_layer_sizes(cfg)
    pad = max(sizes) // 2 + 2
    ii_pad = jnp.pad(ii, ((pad, pad), (pad, pad)), mode="edge")
    maps = []
    for s in sizes:
        half = s // 2
        t = int(s / 3.0)
        b = int(2.0 * s / 9.0)
        base = pad - half
        boxes = [
            # Dyy: three row bands x center column band
            (base + i * t, base + b, base + (i + 1) * t, base + s - b, wt)
            for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))
        ] + [
            # Dxx: center row band x three column bands
            (base + b, base + i * t, base + s - b, base + (i + 1) * t, wt)
            for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))
        ]
        tr = integral.shifted_box_sums(ii_pad, boxes, h, w)
        maps.append(jnp.sign(tr).astype(jnp.int8))
    return jnp.stack(maps)  # (Q, H, W) int8


def _laplacian_sign_dense(ii, kp: Keypoints, cfg: SurfConfig):
    """Laplacian sign via one gather per keypoint from the dense maps."""
    maps = _dense_trace_sign_maps(ii, cfg)
    q, h, w = maps.shape
    li = _layer_index(kp.size, cfg)
    x = jnp.clip(jnp.round(kp.xy[:, 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(kp.xy[:, 1]).astype(jnp.int32), 0, h - 1)
    lin = li * (h * w) + y * w + x
    return jnp.take(maps.reshape(-1), lin).astype(jnp.float32)


def _laplacian_sign(ii, kp: Keypoints, cfg: SurfConfig):
    """Sign of Dxx + Dyy at each keypoint (OpenCV stores this for
    match-time bucketing; we keep it for API parity).

    Coarse trace with thirds geometry (sign only, exact scaling unneeded).
    "gather" mode, the reference for _laplacian_sign_dense: 24
    integral-image corners per keypoint at the refined size, read as ONE
    flat `jnp.take` of K*24 elements."""
    h = ii.shape[0] - 1
    w = ii.shape[1] - 1
    size = jnp.round(kp.size).astype(jnp.int32)
    half = size // 2
    x = jnp.round(kp.xy[:, 0]).astype(jnp.int32) - half
    y = jnp.round(kp.xy[:, 1]).astype(jnp.int32) - half
    third = (size.astype(jnp.float32) / 3.0).astype(jnp.int32)
    b = (2.0 * size.astype(jnp.float32) / 9.0).astype(jnp.int32)
    zero = jnp.zeros_like(size)

    # slot offsets shared by rows and cols: {0, t, 2t, 3t, b, size-b}
    slots = jnp.stack([zero, third, 2 * third, 3 * third, b, size - b], -1)  # (K, 6)
    # (row slot, col slot, coefficient) for all 24 corners:
    # dyy boxes span row slots (0,1),(1,2),(2,3) x col slots (4,5) with
    # weights (1,-2,1); dxx boxes span row slots (4,5) x cols (0,1),(1,2),
    # (2,3). Corner signs: (y1,x1,+),(y0,x1,-),(y1,x0,-),(y0,x0,+).
    corner_r, corner_c, coef = [], [], []
    boxes = [(i, i + 1, 4, 5, wt) for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))]
    boxes += [(4, 5, i, i + 1, wt) for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))]
    for (r0, r1, c0, c1, wt) in boxes:
        for (rr, cc, sgn) in ((r1, c1, 1.0), (r0, c1, -1.0), (r1, c0, -1.0), (r0, c0, 1.0)):
            corner_r.append(rr)
            corner_c.append(cc)
            coef.append(wt * sgn)
    coefs = jnp.asarray(coef, jnp.float32)[None, :]

    rows_i = jnp.clip(y[:, None] + slots, 0, h)  # (K, 6)
    cols_i = jnp.clip(x[:, None] + slots, 0, w)  # (K, 6)
    lin = rows_i[:, jnp.asarray(corner_r)] * (w + 1) + cols_i[:, jnp.asarray(corner_c)]
    v = jnp.take(ii.reshape(-1), lin)  # (K, 24)
    return jnp.sign(jnp.sum(v * coefs, axis=-1))


# ---------------------------------------------------------------------------
# Orientation


def _mid_layer_sizes(cfg: SurfConfig):
    """Filter sizes of the NMS-eligible middle layers, all octaves."""
    return [
        (9 + 6 * l) << o
        for o in range(cfg.n_octaves)
        for l in range(1, cfg.n_octave_layers + 1)
    ]


def _dense_haar_maps(ii, cfg: SurfConfig):
    """Dense Haar-x / Haar-y response maps for every middle-layer scale.

    Shape (Q, H, W) uint32, Q = n_octaves * n_octave_layers; each pixel
    packs (hx as bf16) << 16 | (hy as bf16). Each map is four shifted
    slices of the padded integral image — fully fused, no gathers.
    Keypoints then sample with ONE gathered element per sample instead of
    8 corner reads (or a (2,) row).
    The wavelet radius is quantized to the keypoint's detection layer
    (round(2 * 1.2 * size / 9)), matching OpenCV's integer rounding to
    within half a layer.
    """
    h = ii.shape[0] - 1
    w = ii.shape[1] - 1
    sizes = _mid_layer_sizes(cfg)
    rmax = max(int(round(2 * 1.2 * s / 9.0)) for s in sizes) + 1
    ii_pad = jnp.pad(ii, ((rmax, rmax), (rmax, rmax)), mode="edge")
    maps = []
    for size in sizes:
        r = max(int(round(2 * 1.2 * size / 9.0)), 1)
        # boxes relative to the sample center (y0, x0, y1, x1, weight)
        hx = integral.shifted_box_sums(
            ii_pad,
            [
                (rmax - r, rmax, rmax + r, rmax + r, 1.0),
                (rmax - r, rmax - r, rmax + r, rmax, -1.0),
            ],
            h,
            w,
        )
        hy = integral.shifted_box_sums(
            ii_pad,
            [
                (rmax, rmax - r, rmax + r, rmax + r, 1.0),
                (rmax - r, rmax - r, rmax, rmax + r, -1.0),
            ],
            h,
            w,
        )
        # (hx, hy) PACKED as two bf16s in one uint32 per pixel: one u32
        # element per sample instead of a (2,) f32 row. bf16 rounding
        # (<=0.4% relative on each response) is negligible for the
        # orientation histogram, whose own quantization is 5-degree bins.
        hx16 = jax.lax.bitcast_convert_type(hx.astype(jnp.bfloat16), jnp.uint16)
        hy16 = jax.lax.bitcast_convert_type(hy.astype(jnp.bfloat16), jnp.uint16)
        packed = (hx16.astype(jnp.uint32) << 16) | hy16.astype(jnp.uint32)
        maps.append(packed)
    return jnp.stack(maps)  # (Q, H, W) uint32 [hx_bf16 | hy_bf16]


def _unpack_haar(packed_u32):
    """uint32 [hx_bf16 << 16 | hy_bf16] -> (hx, hy) float32."""
    hx = jax.lax.bitcast_convert_type(
        (packed_u32 >> 16).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    hy = jax.lax.bitcast_convert_type(
        (packed_u32 & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    return hx, hy


def _layer_index(kp_size, cfg: SurfConfig):
    """Nearest middle-layer index for each keypoint's (continuous) size."""
    sizes = jnp.asarray(_mid_layer_sizes(cfg), jnp.float32)
    return jnp.argmin(jnp.abs(kp_size[:, None] - sizes[None, :]), axis=-1)


def _sample_haar(haar, q, cy, cx):
    """Packed Haar samples on each keypoint's 13x13 disc grid.

    haar: (Q, H, W) packed u32 maps; q: (K,) layer; cy, cx: (K, 13) row
    and column per grid offset. Returns (K, 13, 13) u32 indexed
    [k, row offset, col offset]: ONE flat take of K*169 elements at
    q*H*W + cy*W + cx.
    """
    _, h, w = haar.shape
    lin = (q[:, None, None] * h + cy[:, :, None]) * w + cx[:, None, :]
    return jnp.take(haar.reshape(-1), lin)


def _assign_orientation(ii, kp: Keypoints, cfg: SurfConfig):
    """Dominant orientation per keypoint (classic SURF sliding window).

    The disc samples form a 13x13 grid of rows cy x cols cx per keypoint,
    read from the packed Haar maps with one gather (_sample_haar). Sample
    pixel coordinates (round + clip) are identical to the per-sample
    formulation.
    """
    if cfg.upright:
        return jnp.zeros_like(kp.size)
    s = kp.scale  # (K,)
    haar = _dense_haar_maps(ii, cfg)  # (Q, H, W) packed uint32
    h, w = haar.shape[1], haar.shape[2]
    q = _layer_index(kp.size, cfg)  # (K,)
    k = kp.xy.shape[0]

    grid = jnp.arange(-6, 7, dtype=jnp.float32)  # (13,)
    gx, gy = jnp.meshgrid(grid, grid, indexing="xy")  # (13, 13): dx, dy
    disc = gx * gx + gy * gy <= 36.0
    wts = jnp.where(disc, jnp.exp(-(gx * gx + gy * gy) / (2.0 * 2.5**2)), 0.0)

    cy = jnp.clip(
        jnp.round(kp.xy[:, 1:2] + grid[None, :] * s[:, None]).astype(jnp.int32), 0, h - 1
    )  # (K, 13) row per row-offset
    cx = jnp.clip(
        jnp.round(kp.xy[:, 0:1] + grid[None, :] * s[:, None]).astype(jnp.int32), 0, w - 1
    )  # (K, 13) col per col-offset
    hx, hy = _unpack_haar(_sample_haar(haar, q, cy, cx))  # (K, 13, 13) f32
    # (r, j) -> dy = grid[r], dx = grid[j]; flatten to the sample axis
    hx = (hx * wts[None]).reshape(k, -1)  # weights zero outside the disc
    hy = (hy * wts[None]).reshape(k, -1)
    ang = jnp.arctan2(hy, hx)  # (K, N)

    # Sliding pi/3 window every 5 degrees. Window centers sit on 5-degree
    # bin boundaries, so binning responses into a 72-bin circular histogram
    # and summing 12 adjacent bins per center is EXACT (membership
    # |wrap(ang - c_j)| < pi/6 is constant across each 5-degree bin, up to
    # the measure-zero bin edge) — replaces the (K, 72, N) mask reduction.
    nbins = 72
    b = jnp.clip(
        jnp.floor((ang + jnp.pi) / (2 * jnp.pi) * nbins).astype(jnp.int32), 0, nbins - 1
    )  # (K, N)
    onehot_b = (b[..., None] == jnp.arange(nbins)[None, None, :]).astype(jnp.float32)
    hist_x = jnp.einsum("knb,kn->kb", onehot_b, hx)
    hist_y = jnp.einsum("knb,kn->kb", onehot_b, hy)
    # window j covers bins b with (b - j) mod 72 in {-6, ..., 5}
    sx = sum(jnp.roll(hist_x, -d, axis=-1) for d in range(-6, 6))
    sy = sum(jnp.roll(hist_y, -d, axis=-1) for d in range(-6, 6))
    mag = sx * sx + sy * sy
    best = jnp.argmax(mag, axis=-1)
    bx = jnp.take_along_axis(sx, best[:, None], axis=-1)[:, 0]
    by = jnp.take_along_axis(sy, best[:, None], axis=-1)[:, 0]
    return jnp.arctan2(by, bx)


# ---------------------------------------------------------------------------
# Descriptor


def _descriptor_grid():
    """21x21 sample offsets centered on the keypoint (units of s)."""
    r = jnp.arange(21, dtype=jnp.float32) - 10.0
    gx, gy = jnp.meshgrid(r, r, indexing="xy")
    return gx, gy  # each (21, 21)


def _gauss20():
    """Gaussian weights (sigma 3.3) over the 20x20 derivative grid."""
    r = jnp.arange(20, dtype=jnp.float32) - 9.5
    gx, gy = jnp.meshgrid(r, r, indexing="xy")
    return jnp.exp(-(gx * gx + gy * gy) / (2.0 * 3.3**2))


def describe(gray, kp: Keypoints, cfg: SurfConfig):
    """64-d SURF descriptors for all K keypoints. (K, 64) float32,
    L2-normalized; zero rows for invalid slots."""
    h, w = gray.shape
    gxs, gys = _descriptor_grid()  # (21, 21)
    s = kp.scale
    co = jnp.cos(kp.orientation)
    si = jnp.sin(kp.orientation)
    # rotated sampling positions, (K, 21, 21)
    px = kp.xy[:, 0, None, None] + s[:, None, None] * (
        co[:, None, None] * gxs[None] - si[:, None, None] * gys[None]
    )
    py = kp.xy[:, 1, None, None] + s[:, None, None] * (
        si[:, None, None] * gxs[None] + co[:, None, None] * gys[None]
    )
    if cfg.descriptor_interp == "bilinear":
        x0 = jnp.floor(px)
        y0 = jnp.floor(py)
        fx = px - x0
        fy = py - y0
        x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
        y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
        x1i = jnp.clip(x0i + 1, 0, w - 1)
        y1i = jnp.clip(y0i + 1, 0, h - 1)
        patch = (
            gray[y0i, x0i] * (1 - fx) * (1 - fy)
            + gray[y0i, x1i] * fx * (1 - fy)
            + gray[y1i, x0i] * (1 - fx) * fy
            + gray[y1i, x1i] * fx * fy
        )  # (K, 21, 21)
    else:
        # nearest (OpenCV rounds sample coords; 4x fewer gathers)
        xi = jnp.clip(jnp.round(px).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(jnp.round(py).astype(jnp.int32), 0, h - 1)
        patch = gray[yi, xi]  # (K, 21, 21)

    # 2-tap derivatives on the resampled patch (OpenCV's DX/DY scheme)
    dx = 0.5 * (
        patch[:, :-1, 1:] - patch[:, :-1, :-1] + patch[:, 1:, 1:] - patch[:, 1:, :-1]
    )  # (K, 20, 20)
    dy = 0.5 * (
        patch[:, 1:, :-1] - patch[:, :-1, :-1] + patch[:, 1:, 1:] - patch[:, :-1, 1:]
    )
    gw = _gauss20()[None]
    dx = dx * gw
    dy = dy * gw

    # 4x4 subregions of 5x5 samples -> (sum dx, sum|dx|, sum dy, sum|dy|)
    def pool(v):
        v = v.reshape(v.shape[0], 4, 5, 4, 5)
        return jnp.sum(v, axis=(2, 4))  # (K, 4, 4)

    feats = jnp.stack(
        [pool(dx), pool(jnp.abs(dx)), pool(dy), pool(jnp.abs(dy))], axis=-1
    )  # (K, 4, 4, 4)
    desc = feats.reshape(feats.shape[0], 64)
    norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc / jnp.maximum(norm, 1e-12)
    return jnp.where(kp.valid[:, None], desc, 0.0)


@partial(jax.jit, static_argnames=("cfg",))
def detect(gray, cfg: SurfConfig = SurfConfig()):
    """Detect up to cfg.max_keypoints SURF keypoints in a grayscale image.

    Returns a Keypoints with orientation and laplacian sign filled in.
    """
    gray = gray.astype(jnp.float32)
    det_list = _det_maps_per_octave(gray, cfg)
    cand_list = _nms_candidates(det_list, cfg)
    kp = _refine_and_pack(gray.shape, det_list, cand_list, cfg)
    ii = integral.integral_image(gray)
    lap_fn = (
        _laplacian_sign_dense
        if cfg.laplacian_mode == "dense"
        else _laplacian_sign
    )
    lap = lap_fn(ii, kp, cfg)
    ori = _assign_orientation(ii, kp, cfg)
    return kp._replace(
        orientation=jnp.where(kp.valid, ori, 0.0),
        laplacian=jnp.where(kp.valid, lap, 0.0),
    )


@partial(jax.jit, static_argnames=("cfg",))
def detect_and_describe(image, cfg: SurfConfig = SurfConfig()):
    """RGB or gray image -> (Keypoints, descriptors (K, 64))."""
    gray = integral.rgb_to_gray(image)
    kp = detect(gray, cfg)
    desc = describe(gray, kp, cfg)
    return kp, desc
