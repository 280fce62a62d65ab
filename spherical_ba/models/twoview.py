"""Two-view spherical bundle adjustment — the reference's product path
(main.cpp -> do_bundle_adjustment, spherical_bundle_adjuster.cpp:255-356)
as one jittable function, vmappable over batches of ERP pairs.

Stages (call stack parity, SURVEY.md §3.1):
  1. front-end (band-rotation by default)     -> matched ERP pixel pairs
  2. pixel -> unit-bearing lifting (C8)       -> (M, 3) bearing banks
  3. consensus 8-point initial guess (C9/C10)
  4. depth init + the reference's init quirks (C12)
  5. block-coordinate descent d -> rot -> tran (C11/C12), optionally a
     joint Schur-refined polish (the corrected formulation)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rotation, sphere
from ..solver import epipolar, lm
from ..utils.config import PipelineConfig
from .frontend import FRONTENDS, FrontendResult


class SolverTelemetry(NamedTuple):
    """Per-BCD-stage convergence telemetry — parity with the Ceres
    BriefReport + iteration progress the reference prints for each of its
    three solver stages (spherical_bundle_adjuster.cpp:198-211). Each
    field is an lm.StageReport whose leaves are shaped (bcd_rounds,), one
    entry per block-coordinate round of the FINAL solve (after any
    outlier re-gating)."""

    depth: lm.StageReport
    rot: lm.StageReport
    tran: lm.StageReport


class TwoViewResult(NamedTuple):
    rotation_aa: jax.Array      # (3,) refined rotation (angle-axis params)
    rotation_deg: jax.Array     # (3,) the reference's printed convention:
    # angle-axis components * 180/pi (spherical_bundle_adjuster.cpp:215)
    translation: jax.Array      # (3,)
    depths: jax.Array           # (M, 2) per-match (d1, d2)
    initial_euler: jax.Array    # (3,) consensus initial guess
    initial_translation: jax.Array
    match_valid: jax.Array      # (M,)
    match_distance: jax.Array   # (M,) descriptor distance per match
    left_xy: jax.Array          # (M, 2)
    right_xy: jax.Array         # (M, 2)
    num_matches: jax.Array      # scalar int
    total_keypoints: jax.Array  # scalar int
    ok: jax.Array               # scalar bool (initial guess found)
    telemetry: SolverTelemetry  # per-stage iterations + costs (BriefReport)


def lift_matches(fr: FrontendResult, width, height):
    """Matched ERP pixels -> unit bearing banks (C8, one fused op)."""
    b_left = sphere.pixel_to_bearing(fr.left_xy, width, height)
    b_right = sphere.pixel_to_bearing(fr.right_xy, width, height)
    return b_left, b_right


def _pred_angular_residual(b_left, b_right, r, t, d):
    """Per-match angle between b_right and the reprojected left ray."""
    pred = rotation.rotate_angle_axis(
        jnp.broadcast_to(r, b_left.shape), b_left * d[:, 0:1]
    ) - t
    pred = pred / jnp.maximum(
        jnp.linalg.norm(pred, axis=-1, keepdims=True), 1e-12
    )
    return sphere.angular_distance(pred, b_right)


def _trimmed_mean_masked(x, valid, keep_frac=0.8):
    """Mean of the smallest keep_frac of x over valid slots (static)."""
    n = jnp.sum(valid.astype(jnp.int32))
    xs = jnp.sort(jnp.where(valid, x, jnp.inf))
    hi = jnp.floor(keep_frac * n.astype(jnp.float32)).astype(jnp.int32)
    hi = jnp.maximum(hi, 1)
    keep = jnp.arange(x.shape[0]) < hi
    return jnp.sum(jnp.where(keep & jnp.isfinite(xs), xs, 0.0)) / hi.astype(
        jnp.float32
    )


def _solve_from_init(b_left, b_right, base_valid, euler0, t0_in, ok, cfg, init_d):
    """One full refinement from one consensus candidate: stage-1 epipolar
    gate -> BCD -> iterated stage-2 reprojection gate -> optional joint
    Schur. Returns (r, t, d, robust residual score for multi-start)."""
    ba = cfg.ba
    match_valid = base_valid
    if ba.outlier_reject:
        # Stage-1 gate: the candidate's epipolar residuals (the RANSAC the
        # reference scores but never applies, spherical_bundle_adjuster.cpp
        # :118-181). Adaptive threshold — the candidate is itself a noisy
        # subsample estimate.
        gated = epipolar.epipolar_inlier_mask(
            b_left,
            b_right,
            match_valid,
            euler0,
            t0_in,
            thresh_rad=jnp.deg2rad(ba.outlier_thresh_deg),
            min_keep=ba.outlier_min_keep,
        )
        # only trust the gate when a consensus pose exists
        match_valid = jnp.where(ok, gated, match_valid)

    if ba.reference_compat:
        # Quirk (:330): the negated Euler consensus vector is used directly
        # as the angle-axis init.
        r0 = -euler0
    else:
        # The 8-point decomposition of this constraint convention recovers
        # R^T (E = [-R^T t]x R^T for the model X2 = R X1 - t), so the exact
        # init inverts the consensus rotation — the reference's negation is
        # the small-angle approximation of this inverse.
        r0 = -rotation.euler_to_angle_axis(euler0)
    t0 = t0_in

    def run_bcd(valid_mask):
        def bcd_round(carry, _):
            r, t, d = carry
            d, rep_d = lm.solve_depths(b_left, b_right, d, r, t, valid_mask, ba)
            if ba.reference_compat:
                # Quirk (:941-942, :998-999): every rot/tran residual uses
                # the first two matches' LEFT depths as (d1, d2).
                d_pair = jnp.stack([d[0, 0], d[1, 0]])
            else:
                d_pair = d
            r, rep_r = lm.solve_rotation(b_left, b_right, d_pair, r, t, valid_mask, ba)
            t, rep_t = lm.solve_translation(b_left, b_right, d_pair, r, t, valid_mask, ba)
            return (r, t, d), SolverTelemetry(rep_d, rep_r, rep_t)

        (r, t, d), tel = jax.lax.scan(
            bcd_round, (r0, t0, init_d), None, length=ba.bcd_rounds
        )
        return r, t, d, tel

    r, t, d, tel = run_bcd(match_valid)

    if ba.outlier_reject:
        # Stage-2 gate: residuals against the REFINED pose separate in/out-
        # liers much more sharply than the consensus estimate (Huber keeps
        # the first solve sane under outliers); re-solve on the clean set.
        # Iterated: each round's sharper pose exposes outliers the previous
        # (still-dirty) pose let through.
        for _ in range(ba.outlier_rounds):
            ang = _pred_angular_residual(b_left, b_right, r, t, d)
            gated = epipolar.residual_inlier_mask(
                ang,
                match_valid,
                thresh_rad=jnp.deg2rad(ba.outlier_thresh_deg),
                min_keep=ba.outlier_min_keep,
            )
            match_valid = jnp.where(ok, gated, match_valid)
            r, t, d, tel = run_bcd(match_valid)

    if ba.joint_refine:
        r, t, d, _ = lm.solve_joint_schur(
            b_left, b_right, d, r, t, match_valid, ba
        )

    # Multi-start selection score: 20%-trimmed mean angular residual over
    # the ORIGINAL (pre-gate) valid matches — a start must not win by
    # gating away the matches it cannot explain.
    ang = _pred_angular_residual(b_left, b_right, r, t, d)
    score = _trimmed_mean_masked(ang, base_valid, keep_frac=0.8)

    # If no consensus initial guess exists (too few matches / no valid
    # candidates), refining from an arbitrary point produces garbage —
    # report the (identity) init instead. The reference would crash on an
    # empty candidate vector here (:178 min_element on empty).
    r = jnp.where(ok, r, r0)
    t = jnp.where(ok, t, t0)
    d = jnp.where(ok, d, init_d)
    # The no-initial-guess fallback above discards the solve, so its
    # telemetry is garbage too: mask it (0 iterations, NaN costs) so the
    # CLI's BriefReport prints can't report costs from a solve whose pose
    # was thrown away.
    tel = jax.tree.map(
        lambda x: jnp.where(
            ok,
            x,
            jnp.zeros_like(x)
            if jnp.issubdtype(x.dtype, jnp.integer)
            else jnp.full_like(x, jnp.nan),
        ),
        tel,
    )
    return r, t, d, score, tel


@partial(jax.jit, static_argnames=("cfg",))
def adjust_from_matches(
    b_left,
    b_right,
    match_valid,
    key,
    cfg: PipelineConfig = PipelineConfig(),
    init_depth=None,
):
    """Initial guess + BCD refinement given lifted matched bearings.

    This is the solver half of do_bundle_adjustment (:300-346); split out
    so batched/multi-view paths reuse it.

    With cfg.ba.multi_start = k > 0 (corrected mode), the top-k consensus
    candidates are each refined (vmapped — the solver is a few ms, k-fold
    is cheap next to the frontend) and the start with the lowest trimmed
    angular residual over ALL matches wins: the BCD/joint solvers are
    local, so a single mode-consensus init occasionally locks a wrong
    basin degrees off the optimum (PARITY.md "End-to-end").
    """
    ba = cfg.ba
    d0 = jnp.asarray(ba.init_depth if init_depth is None else init_depth)
    m = b_left.shape[0]
    init_d = jnp.full((m, 2), d0, jnp.float32)

    if ba.multi_start and not ba.reference_compat:
        e_k, t_k, ok = epipolar.initial_guess_topk(
            b_left, b_right, match_valid, key, cfg.ransac, k=ba.multi_start
        )
        rs, ts, ds, scores, tels = jax.vmap(
            lambda e0, t0: _solve_from_init(
                b_left, b_right, match_valid, e0, t0, ok, cfg, init_d
            )
        )(e_k, t_k)
        win = jnp.argmin(scores)
        if ba.rot_dominant_select_deg > 0:
            # Rotation-dominant selection (see BaConfig): when some start
            # explains the matches as a pure rotation to sub-threshold
            # median residual, pick by the rotation-only criterion — the
            # full score's depth+translation freedom rewards absorbing
            # structured match bias into a phantom translation exactly in
            # this (degenerate-E) regime.
            def med_rot(r):
                pred = rotation.rotate_angle_axis(
                    jnp.broadcast_to(r, b_left.shape), b_left
                )
                ang = sphere.angular_distance(pred, b_right)
                return epipolar.masked_median(ang, match_valid)

            mr = jax.vmap(med_rot)(rs)
            # Adaptive threshold: the absolute floor (rot_dominant_select
            # deg) covers high-res inputs; at low resolutions match noise
            # itself exceeds it, so a start whose rotation-only median is
            # within 1.5x of the best FULL-model score (i.e. pure
            # rotation explains the data about as well as rotation+
            # translation+depths) also qualifies, capped at 3 deg so a
            # junk-match translation scene can never trip it. On
            # translation-rich scenes min(mr) >= the parallax angle while
            # the full score sits at noise level, so neither branch fires.
            thresh = jnp.maximum(
                jnp.deg2rad(ba.rot_dominant_select_deg),
                1.5 * jnp.min(scores),
            )
            thresh = jnp.minimum(thresh, jnp.deg2rad(3.0))
            rot_dom = jnp.min(mr) < thresh
            win = jnp.where(rot_dom, jnp.argmin(mr), win)
        guess = epipolar.InitialGuess(
            euler=e_k[win],
            translation=t_k[win],
            num_candidates=jnp.asarray(ba.multi_start),
            ok=ok,
        )
        tel = jax.tree.map(lambda x: x[win], tels)
        return rs[win], ts[win], ds[win], guess, tel

    guess = epipolar.initial_guess(b_left, b_right, match_valid, key, cfg.ransac)
    r, t, d, _, tel = _solve_from_init(
        b_left, b_right, match_valid, guess.euler, guess.translation,
        guess.ok, cfg, init_d,
    )
    return r, t, d, guess, tel


@partial(jax.jit, static_argnames=("cfg", "frontend"))
def run_two_view(
    im_left,
    im_right,
    key,
    cfg: PipelineConfig = PipelineConfig(),
    frontend: str = "band",
) -> TwoViewResult:
    """End-to-end two-view spherical BA on an ERP image pair."""
    h, w = im_left.shape[0], im_left.shape[1]
    fr = FRONTENDS[frontend](im_left, im_right, cfg)
    b_left, b_right = lift_matches(fr, w, h)
    r, t, d, guess, tel = adjust_from_matches(
        b_left, b_right, fr.match_valid, key, cfg
    )
    return TwoViewResult(
        rotation_aa=r,
        rotation_deg=r / jnp.pi * 180.0,
        translation=t,
        depths=d,
        initial_euler=guess.euler,
        initial_translation=guess.translation,
        match_valid=fr.match_valid,
        match_distance=fr.match_distance,
        left_xy=fr.left_xy,
        right_xy=fr.right_xy,
        num_matches=fr.match_count,
        total_keypoints=fr.total_keypoints,
        ok=guess.ok,
        telemetry=tel,
    )


def run_two_view_batch(
    im_left, im_right, keys, cfg=PipelineConfig(), frontend="band",
    batch_chunk: int = 4,
):
    """vmapped two-view BA over a batch of independent ERP pairs —
    the reference has no batch mode; this is the natural unit of
    single-device throughput (BASELINE.md config #2).

    Auto band ladder, batched: under vmap a lax.cond runs
    BOTH branches, so the single-pair auto fallback would cost
    parity + dense (~2.7x crop/detect) on EVERY pair of every batch. This
    entry point instead runs auto as a host-side two-pass: the whole batch
    on the parity ladder first, then ONLY the pairs that found fewer than
    auto_min_matches matches re-run on the dense ladder (rare — the
    intermediate-pitch cliff) and are scattered back. Costs one
    small device->host readback of the match counts per batch; easy
    scenes pay pure parity cost. When this function is itself being
    traced (inputs are tracers — e.g. inside an outer jit/shard_map),
    the host two-pass is impossible and the vmapped lax.cond fallback
    (both ladders every pair) is kept: pin "parity" or "dense" there.

    Batches larger than `batch_chunk` run as a device-side `lax.map` over
    vmapped sub-batches (still ONE dispatch): peak memory is bounded by
    the chunk, not the batch, and compile time by the chunk's vmap width.
    batch_chunk=0 disables chunking. Batches not divisible by the chunk
    are padded up to the next multiple (static shapes) and the pad rows
    dropped from the result — a ragged batch must NOT silently fall back
    to the full vmap whose memory blow-up the chunking exists to bound.

    Chunk default 4: wider vmaps inflate fused intermediates and compile
    time (a 4-pair chunk compiles ~4x faster than a 16-pair one); the
    GPU's best chunk is not measured yet (ROADMAP S5).
    """
    fcfg = cfg.frontend
    if (
        frontend == "band"
        and fcfg.band_ladder == "auto"
        and not isinstance(im_left, jax.core.Tracer)
    ):
        import dataclasses as _dc

        ladder = lambda name: _dc.replace(
            cfg, frontend=_dc.replace(fcfg, band_ladder=name)
        )
        out = run_two_view_batch(
            im_left, im_right, keys, ladder("parity"), frontend, batch_chunk
        )
        import numpy as _np

        fail = _np.asarray(out.num_matches) < fcfg.auto_min_matches
        idx = _np.nonzero(fail)[0]
        if idx.size == 0:
            return out
        sub = run_two_view_batch(
            im_left[idx], im_right[idx], keys[idx],
            ladder("dense"), frontend, batch_chunk,
        )
        jidx = jnp.asarray(idx)
        return jax.tree.map(lambda a, s: a.at[jidx].set(s), out, sub)

    return _run_batch_chunked(
        im_left, im_right, keys, cfg=cfg, frontend=frontend,
        batch_chunk=batch_chunk,
    )


@partial(jax.jit, static_argnames=("cfg", "frontend", "batch_chunk"))
def _run_batch_chunked(im_left, im_right, keys, cfg, frontend, batch_chunk):
    """One-dispatch chunked batch executor (jitted: executed eagerly, the
    pad/regroup/lax.map would cost dozens of per-op dispatches)."""
    fn = jax.vmap(partial(run_two_view, cfg=cfg, frontend=frontend))
    b = im_left.shape[0]
    if not batch_chunk or b <= batch_chunk:
        return fn(im_left, im_right, keys)
    pad = (-b) % batch_chunk
    if pad:
        im_left = jnp.concatenate([im_left, im_left[:pad]])
        im_right = jnp.concatenate([im_right, im_right[:pad]])
        keys = jnp.concatenate([keys, keys[:pad]])
    bp = b + pad
    g = bp // batch_chunk

    def regroup(x):
        return x.reshape(g, batch_chunk, *x.shape[1:])

    out = jax.lax.map(
        lambda args: fn(*args),
        (regroup(im_left), regroup(im_right), regroup(keys)),
    )
    return jax.tree.map(lambda x: x.reshape(bp, *x.shape[2:])[:b], out)
