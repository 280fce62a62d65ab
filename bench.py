"""Benchmark: end-to-end two-view spherical BA on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

The headline is full-pipeline throughput (band front-end SURF detect/
describe -> descriptor matching -> 80-trial consensus 8-point -> 3-stage
BCD bundle adjustment) at the knee of the batch curve on 512x1024 ERP
pairs. `detail` additionally records:

  * `sweep`   — batch in {1,4,8,16,32,64} @ 512x1024 (BASELINE.md config #2)
  * `erp2k`   — a single 1024x2048 pair, the reference's actual workload
                (main.cpp:8-33, BASELINE.md config #1)
  * `stages`  — scan-amortized per-stage device times at the headline batch
                (frontend / match / initial_guess / bcd) with XLA
                cost-analysis flops+bytes -> achieved GFLOP/s, GB/s,
                arithmetic intensity (the roofline coordinates)
  * `accuracy`— match quality (outlier%@2deg, 10%-trimmed mean angular
                error: test/feature_test.cpp:102-121) and rotation error
                vs the synthetic GT for BOTH reference_compat and
                corrected modes; thresholds asserted (exit 1 on breach,
                after printing the JSON line)

vs_baseline compares against the frozen single-pair CPU figure in
BASELINE_FROZEN.json (the reference is a CPU/OpenMP tool with no published
numbers — SURVEY.md §6; the frozen figure is this same workload measured
on the host CPU, our stand-in for the reference-class implementation).

Timing: warm wall time ended by block_until_ready, after a compile-and-
warm call. Scan-timed bodies run `reps` iterations inside one dispatch and
mix a runtime-zero perturbation into every input, so XLA cannot hoist
loop-invariant subgraphs out of the timing loop (Timer.scan_time).

Needs a GPU (main() exits otherwise). Env knobs: BENCH_QUICK=1 skips
everything but the headline and the accuracy gates; BENCH_FULL=1 also
measures the sweep / erp2k / acc2k / ladder_dense / default_auto / stages
sections. A section that is not measured is reported as "not measured".
"""

import dataclasses
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BENCH_H, BENCH_W = 512, 1024
# Headline batch: 64, chunked as a device-side lax.map over vmap-4
# sub-batches (models/twoview.run_two_view_batch).
BATCH = 64
SWEEP_BATCHES = (1, 4, 8, 16, 32, 64)
ACC_SEEDS = (43, 101)          # independent scene/euler seeds
ACC_PAIRS_PER_SEED = 8         # 16 pairs total per mode
FROZEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_FROZEN.json")
NOT_MEASURED = "not measured"

# Accuracy gates (asserted). Rotation errors are measured on the host in
# f64 (rot_err_deg_host). The values were calibrated on an earlier
# accelerator's numerics from fresh-process repeats of
# scripts/calibrate_accuracy.py (16 pairs x 2 seeds, distinct solver PRNG
# streams); recalibrating them on the GPU is open (ROADMAP R2).
# Compat mode replicates the reference's first-two-depths + negated-Euler
# quirks (SURVEY.md C11/C12); its BCD has init-sensitive shallow basins
# (PARITY.md "End-to-end"), so single-pair errors are heavy-tailed BY
# REFERENCE-PARITY CONSTRUCTION — compat is gated on the MEDIAN (stable)
# plus a wide max envelope, whose tail the f64 oracle BCD reproduces from
# the same inits (PARITY.md). Corrected mode (per-match depths + outlier
# rejection + joint Schur) carries the tight gates: ~2x the worst
# calibrated median, ~3x the max.
GATE_MIN_MATCHES = 40            # per pair (mean)
GATE_MAX_OUTLIER_PCT = 10.0      # @ 2 deg, mean over pairs
GATE_MAX_TRIM_ERR_DEG = 1.0      # 10%-trimmed mean angular match error, deg
GATE_MED_ROT_ERR_COMPAT = 2.5    # deg, median over 16 pairs
GATE_MAX_ROT_ERR_COMPAT = 11.5   # deg, max envelope (init-sensitive basins)
GATE_MED_ROT_ERR_CORRECT = 0.2   # deg, median
GATE_MAX_ROT_ERR_CORRECT = 0.5   # deg, max

# 2K workload gates (BASELINE.md config #1 — the reference's actual
# workload, main/main.cpp:8-33), at the 2K-tuned capacity
# (bench_config_2k) over 8 pairs. Calibrated like the 512 gates:
# mean outliers ~10% @ 2 deg at ~125 matches/pair (gate ~20% headroom);
# corrected med 0.05 / max 0.17 deg (~6x headroom); compat med 1.5 /
# max 5.0 deg (median ~1.6x headroom, max a wide envelope for compat's
# init-sensitive tail).
GATE_2K_MIN_MATCHES = 40
GATE_2K_MAX_OUTLIER_PCT = 12.5
GATE_2K_MED_ROT_ERR_CORRECT = 0.3   # deg
GATE_2K_MAX_ROT_ERR_CORRECT = 1.0   # deg
GATE_2K_MED_ROT_ERR_COMPAT = 2.5    # deg
GATE_2K_MAX_ROT_ERR_COMPAT = 8.0    # deg

# Pitch-cell gates: the quality sweep's known-bad regime —
# GT pitch between the reference ladder's 45-deg band centers (QUALITY.md:
# at pitch 30 deg the parity ladder collapses to 4.3 matches / 36.7%
# outliers). Gated LIVE each run on the DEFAULT config (auto band ladder:
# parity with dense fallback — the data-driven default), corrected mode,
# 4 pairs per cell at pitch {15, 30, 60} deg.
PITCH_CELLS = (15.0, 30.0, 60.0)
GATE_CELL_MIN_MATCHES = 10          # mean per pair, per cell
GATE_CELL_MAX_OUTLIER_PCT = 25.0
# Per-cell max-rot-err gates: default auto ladder, corrected mode, 4
# pairs/cell calibrated at max 0.28 deg (pitch 60); gates at ~3.5x.
GATE_CELL_MAX_ROT_ERR = {15: 1.0, 30: 1.0, 60: 1.0}  # deg, max over pairs


def bench_config():
    from spherical_ba.utils.config import (
        MatchConfig,
        PipelineConfig,
        SurfConfig,
    )

    # parity ladder: the headline workload is the reference's ACTIVE
    # band strategy (4 pitches, spherical_surf.cpp:137-153); the default
    # auto ladder is exercised by the pitch-cell accuracy section
    return PipelineConfig(
        surf=SurfConfig(max_keypoints=256, n_octaves=3),
        match=MatchConfig(max_matches=512, ratio_thresh=0.5),
    ).parity()


def bench_config_2k():
    """Capacity tuned for 1024x2048 (4x the pixels of the 512 config —
    round 2 ran 2K with the 512 capacity and got 15 matches/pair).
    Variant chosen from a capacity sweep: k512/o4/m1024 — the 4th octave
    matters at 2K (largest-scale blobs), giving ~120 matches/pair, ~10%
    outliers and a compat median of ~2.2 deg (vs 5.15 at k256/o3)."""
    from spherical_ba.utils.config import (
        MatchConfig,
        PipelineConfig,
        SurfConfig,
    )

    return PipelineConfig(
        surf=SurfConfig(max_keypoints=512, n_octaves=4),
        match=MatchConfig(max_matches=1024, ratio_thresh=0.5),
    ).parity()


def corrected_mode(cfg):
    """The bench's corrected-solver configuration: per-match depths,
    outlier gates, joint Schur, 4-start refinement, and a 240-trial
    consensus — the large-rotation corrected tail at 80 trials (max 2.03
    deg over 8 pitch-60 pairs) collapsed to 0.79 deg at 240 trials (the
    tail is init-candidate scarcity, not the local solver)."""
    import dataclasses as _dc

    return _dc.replace(
        cfg,
        ba=_dc.replace(
            cfg.ba, reference_compat=False, joint_refine=True,
            outlier_reject=True, multi_start=4),
        ransac=_dc.replace(cfg.ransac, num_trials=240),
    )


def make_batch_gt(batch, height=BENCH_H, width=BENCH_W, seed=42):
    """(lefts, rights, eulers_rad): synthetic pure-rotation ERP pairs with
    ground-truth Euler angles, rendered in one vmapped dispatch. Scenes AND
    eulers both derive from `seed` (distinct seeds = distinct pairs)."""
    import jax
    import jax.numpy as jnp
    from spherical_ba.core import rotation
    from spherical_ba.utils import synthetic

    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    eulers = jnp.asarray(
        np.deg2rad(np.random.default_rng(seed).uniform(-5, 5, (batch, 3))),
        jnp.float32,
    )
    eye = jnp.eye(3, dtype=jnp.float32)
    Rs = jax.vmap(rotation.euler_to_matrix)(eulers)
    render = lambda k, R: synthetic.render_erp(k, R, height, width)
    lefts = jax.vmap(lambda k: render(k, eye))(keys)
    rights = jax.vmap(lambda k, R: render(k, R.T))(keys, Rs)
    return lefts, rights, eulers


_SWEEP_BASE = {}


def make_batch(batch, height=BENCH_H, width=BENCH_W):
    """Fixed-pair-set batches for the sweep: every batch size slices/tiles
    the SAME 16 base pairs, so the batch curve measures batching, not
    scene luck (the round-2 sweep redrew pairs per batch point)."""
    import jax.numpy as jnp

    key = (height, width)
    if key not in _SWEEP_BASE:
        l, r, _ = make_batch_gt(16, height, width)
        _SWEEP_BASE[key] = (np.asarray(l), np.asarray(r))
    l, r = _SWEEP_BASE[key]
    reps = -(-batch // 16)
    l = np.tile(l, (reps, 1, 1, 1))[:batch]
    r = np.tile(r, (reps, 1, 1, 1))[:batch]
    return jnp.asarray(l), jnp.asarray(r)


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def rot_err_deg_host(rot_aa, Rs_gt):
    """Geodesic rotation error, computed ENTIRELY on host in float64.

    A reduced-precision device contraction perturbs the trace by ~1e-3,
    and d(arccos)/dx ~ 1/sin(theta) amplifies that ~50x at 1 deg (it also
    clips tr > 3 to exactly 0 deg), so every accuracy metric converts the
    solver's angle-axis output on host: f64 Rodrigues, f64 trace, f64
    arccos — measurement error ~1e-6 deg.

    rot_aa: (B, 3) array-like; Rs_gt: (B, 3, 3). Returns (B,) degrees.
    """
    from spherical_ba.models import evaluation

    return evaluation.geodesic_deg_host(
        evaluation.angle_axis_to_matrix_host(rot_aa), Rs_gt
    )


class Timer:
    """Warm wall-clock timer: one compile-and-warm call, then the median
    of `n` runs, each ended by block_until_ready."""

    def __init__(self):
        import jax
        import jax.numpy as jnp

        self.jax, self.jnp = jax, jnp

    def _med(self, f, *args, n=3):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            self.jax.block_until_ready(f(*args))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def scan_time(self, body, reps, n=3, want_cost=False):
        """body(i, x) -> pytree; returns (seconds per iteration, cost dict).

        Runs `reps` iterations inside one dispatch; outputs are folded into
        a scalar carry so nothing is dead-code-eliminated. `x` is a
        RUNTIME-ZERO f32 the body must mix into its inputs (e.g.
        `im + x * (i + 1)`): with inputs loop-invariant, XLA hoists the
        input-only-dependent subgraph out of the scan and the loop times
        it once."""
        jax, jnp = self.jax, self.jnp

        def fold(t):
            return sum(
                jnp.sum(x).astype(jnp.float32) for x in jax.tree.leaves(t)
            )

        def scanned(x):
            def sbody(c, i):
                return c + fold(body(i, x)), None

            c, _ = jax.lax.scan(sbody, jnp.float32(0.0), jnp.arange(reps))
            return c

        run = jax.jit(scanned)
        zero = jnp.float32(0.0)
        cost = None
        if want_cost:
            compiled = run.lower(zero).compile()
            ca = compiled.cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            cost = {
                "flops": float(ca.get("flops", 0.0)) / reps,
                "bytes": float(ca.get("bytes accessed", 0.0)) / reps,
            }
        jax.block_until_ready(run(zero))  # compile + warm
        t = self._med(run, zero, n=n)
        return t / reps, cost


def measure_point(timer, batch, height, width, reps, cfg=None, n=3):
    """Full-pipeline throughput at one (batch, resolution) point."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from spherical_ba.models import twoview

    cfg = cfg or bench_config()
    im_l, im_r = make_batch(batch, height, width)
    jax.block_until_ready((im_l, im_r))
    step = partial(
        twoview.run_two_view_batch, cfg=cfg, frontend="band", batch_chunk=4
    )
    keys = jax.random.split(jax.random.PRNGKey(7), reps * batch).reshape(
        reps, batch, -1
    )

    def body(i, x):
        # x is runtime-zero: defeats loop-invariant hoisting (Timer docs)
        eps = x * (i.astype(jnp.float32) + 1.0)
        out = step(im_l + eps, im_r + eps, keys[i % reps])
        return (out.rotation_aa, out.translation, out.num_matches)

    per_iter, _ = timer.scan_time(body, reps, n=n)
    out = step(im_l, im_r, keys[0])
    matches = int(np.sum(np.asarray(out.num_matches))) // batch
    return {
        "batch": batch,
        "height": height,
        "width": width,
        "seconds_per_batch": per_iter,
        "ms_per_pair": per_iter / batch * 1e3,
        "pairs_per_s": batch / per_iter,
        "matches_per_pair": matches,
    }


def measure_default_auto(timer, batch, reps: int = 5):
    """Throughput of the TRUE out-of-the-box config (auto band ladder) at
    the headline batch (the shipped default's batched cost
    was never measured — pre-r5 it silently paid parity+dense under vmap).

    The batched auto path is a host-side two-pass (parity batch + dense
    re-run of failed pairs), so it cannot be timed inside a lax.scan;
    measured as the median of `reps` host-level wall-clock calls — exactly
    what a user pays."""
    import jax
    from spherical_ba.models import twoview

    cfg = dataclasses.replace(
        bench_config(),
        frontend=dataclasses.replace(
            bench_config().frontend, band_ladder="auto"
        ),
    )
    im_l, im_r = make_batch(batch, BENCH_H, BENCH_W)
    jax.block_until_ready((im_l, im_r))
    keys = jax.random.split(jax.random.PRNGKey(7), batch)

    def call():
        return twoview.run_two_view_batch(
            im_l, im_r, keys, cfg, frontend="band", batch_chunk=4
        )

    out = call()  # compile + warm
    jax.block_until_ready(out)
    n_fallback = int(np.sum(np.asarray(out.num_matches) < cfg.frontend.auto_min_matches))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        ts.append(time.perf_counter() - t0)
    per_batch = float(np.median(ts))
    return {
        "batch": batch,
        "seconds_per_batch": per_batch,
        "ms_per_pair": per_batch / batch * 1e3,
        "pairs_per_s": batch / per_batch,
        "n_dense_fallback_pairs": n_fallback,
        "method": "host wall-clock median (two-pass auto cannot scan)",
    }


def measure_stages(timer, batch, reps):
    """Scan-amortized per-stage device times at the headline batch, with
    XLA cost-analysis flops/bytes -> roofline coordinates per stage.

    Stage split mirrors the reference call stack (SURVEY.md §3.1):
    frontend = band crop + SURF detect/describe + keypoint remap + match
    (spherical_surf::do_all); `match` is re-timed standalone on the
    descriptor banks; initial_guess = 80-trial consensus 8-point;
    bcd = depth/rot/tran block-coordinate descent + guards
    (solve = initial_guess + bcd, timed as adjust_from_matches)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from spherical_ba.models import frontend as fe, twoview
    from spherical_ba.ops import integral, match, surf, warp

    cfg = bench_config()
    im_l, im_r, _ = make_batch_gt(batch)
    jax.block_until_ready((im_l, im_r))
    h, w = BENCH_H, BENCH_W
    keys = jax.random.split(jax.random.PRNGKey(11), batch)

    stages = {}

    def add(label, body, want_cost=True):
        # bodies take (i, x): x is the Timer's runtime-zero anti-hoisting
        # perturbation (see Timer.scan_time)
        per_iter, cost = timer.scan_time(body, reps, n=3, want_cost=want_cost)
        row = {"ms_per_batch": per_iter * 1e3, "ms_per_pair": per_iter / batch * 1e3}
        if cost:
            row["gflops_per_batch"] = cost["flops"] / 1e9
            row["gbytes_per_batch"] = cost["bytes"] / 1e9
            row["achieved_gflops_per_s"] = cost["flops"] / per_iter / 1e9
            row["achieved_gbytes_per_s"] = cost["bytes"] / per_iter / 1e9
            if cost["bytes"] > 0:
                row["arith_intensity_flops_per_byte"] = cost["flops"] / cost["bytes"]
        stages[label] = row
        _log(f"stage {label}: {row['ms_per_batch']:.2f} ms/batch")

    front = jax.vmap(partial(fe.band_frontend, cfg=cfg))
    # Anti-hoisting helpers (the perturbation must reach EVERY
    # input — a subgraph depending only on an unperturbed input is still
    # loop-invariant and XLA hoists it out of the timing scan). eps is a
    # runtime-zero float; epsk/epsm extend it to uint32 keys (xor 0) and
    # bool masks (xor False) so integer inputs are index-dependent too.
    eps = lambda i, x: x * (i.astype(jnp.float32) + 1.0)
    epsk = lambda i, x, k: k ^ eps(i, x).astype(jnp.uint32)
    epsm = lambda i, x, m: m ^ (eps(i, x) > 0.0)
    add("frontend", lambda i, x: front(im_l + eps(i, x), im_r + eps(i, x)))

    # descriptor banks for the standalone match stage
    pitches = jnp.deg2rad(jnp.asarray(cfg.frontend.band_pitches_deg, jnp.float32))

    def banks_of(im):
        gray = integral.rgb_to_gray(im)
        bands = jax.vmap(lambda p: warp.crop_rotated_band(gray, p))(pitches)
        kp, desc = jax.vmap(lambda b: surf.detect_and_describe(b, cfg.surf))(bands)
        return desc.reshape(-1, desc.shape[-1]), kp.valid.reshape(-1)

    d_l, v_l = jax.jit(jax.vmap(banks_of))(im_l)
    d_r, v_r = jax.jit(jax.vmap(banks_of))(im_r)
    jax.block_until_ready((d_l, d_r))
    matcher = jax.vmap(partial(match.match_descriptors, cfg=cfg.match))
    add("match", lambda i, x: matcher(
        d_l + eps(i, x), epsm(i, x, v_l), d_r + eps(i, x), epsm(i, x, v_r)))

    fr = jax.jit(front)(im_l, im_r)
    b_l, b_r = jax.vmap(partial(twoview.lift_matches, width=w, height=h))(fr)
    jax.block_until_ready((b_l, b_r))
    from spherical_ba.solver import epipolar

    guess_fn = jax.vmap(partial(epipolar.initial_guess, cfg=cfg.ransac))
    add("initial_guess", lambda i, x: guess_fn(
        b_l + eps(i, x), b_r + eps(i, x),
        epsm(i, x, fr.match_valid), epsk(i, x, keys)))

    solve_fn = jax.vmap(partial(twoview.adjust_from_matches, cfg=cfg))
    add("solve(initial_guess+bcd)",
        lambda i, x: solve_fn(
            b_l + eps(i, x), b_r + eps(i, x),
            epsm(i, x, fr.match_valid), epsk(i, x, keys))[:3])

    if "solve(initial_guess+bcd)" in stages and "initial_guess" in stages:
        stages["bcd"] = {
            "ms_per_batch": stages["solve(initial_guess+bcd)"]["ms_per_batch"]
            - stages["initial_guess"]["ms_per_batch"],
            "note": "solve minus initial_guess",
        }
    return stages


def measure_accuracy(height=BENCH_H, width=BENCH_W, seeds=ACC_SEEDS,
                     pairs_per_seed=ACC_PAIRS_PER_SEED, cfg=None,
                     modes=("compat", "corrected"), key_salt=0):
    """Match-quality + pose accuracy vs synthetic GT, compat + corrected.

    The reference's own KPI (test/feature_test.cpp:102-121): outlier% at a
    2 deg angular threshold and the 10%-trimmed mean angular error, plus
    the pose KPI (solved vs expected, spherical_bundle_adjuster.cpp:214-216)
    as a geodesic rotation error in degrees.

    Statistics: pairs_per_seed pairs x len(seeds) independent seeds
    (16 pairs total at the defaults — round 2 gated a max over 4 pairs /
    one seed, which compat-mode BCD's init-sensitive basins make
    statistically fragile; see PARITY.md "End-to-end"). Reports median,
    p90 and max; gates sit on median + max.

    key_salt varies the SOLVER PRNG stream (RANSAC subsampling) without
    touching the scenes — calibration repeats use it to measure the
    init-sensitivity spread the gates must absorb (bit-identical repeats
    measure nothing). Production runs use 0."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from spherical_ba.core import rotation
    from spherical_ba.models import evaluation, twoview

    cfg = cfg or bench_config()
    out = {}
    corrected = corrected_mode(cfg)
    for mode, c in (("compat", cfg), ("corrected", corrected)):
        if mode not in modes:
            continue
        step = jax.jit(jax.vmap(partial(twoview.run_two_view, cfg=c, frontend="band")))
        rot_errs, matches, outl, trim = [], [], [], []
        for seed in seeds:
            im_l, im_r, eulers = make_batch_gt(
                pairs_per_seed, height, width, seed=seed
            )
            jax.block_until_ready((im_l, im_r))
            Rs = jax.vmap(rotation.euler_to_matrix)(eulers)
            keys = jax.random.split(
                jax.random.PRNGKey(seed + 1 + 100003 * key_salt),
                pairs_per_seed,
            )
            res = step(im_l, im_r, keys)
            ev = jax.vmap(
                partial(evaluation.evaluate_matches, width=width, height=height, cfg=c)
            )(_as_frontend_result(res), Rs)
            # host-side f64 geodesic: the on-device bf16 trace + arccos
            # injected +-2.5 deg of measurement noise (rot_err_deg_host)
            rot_errs += list(rot_err_deg_host(res.rotation_aa, Rs))
            matches += list(np.asarray(ev.num_matches))
            outl += list(np.asarray(ev.outlier_pct))
            trim += list(np.rad2deg(np.asarray(ev.trimmed_mean_err_rad)))
        rot_errs = np.asarray(rot_errs)
        out[mode] = {
            "n_pairs": int(rot_errs.size),
            "mean_matches": float(np.mean(matches)),
            "mean_outlier_pct": float(np.mean(outl)),
            "mean_trimmed_err_deg": float(np.mean(trim)),
            "rot_err_deg": [round(float(x), 4) for x in rot_errs],
            "median_rot_err_deg": float(np.median(rot_errs)),
            "p90_rot_err_deg": float(np.percentile(rot_errs, 90)),
            "max_rot_err_deg": float(np.max(rot_errs)),
        }
        _log(f"accuracy[{mode}]: med={out[mode]['median_rot_err_deg']:.3f} "
             f"p90={out[mode]['p90_rot_err_deg']:.3f} "
             f"max={out[mode]['max_rot_err_deg']:.3f} "
             f"matches={out[mode]['mean_matches']:.1f} "
             f"outl%={out[mode]['mean_outlier_pct']:.2f}")
    return out


def measure_pitch_cells(cells=PITCH_CELLS, pairs_per_cell=4,
                        height=BENCH_H, width=BENCH_W, seed=77):
    """Corrected-mode accuracy at fixed GT pitches — the regime the
    reference's 45-deg ladder breaks in (spherical_surf.cpp:131-153,
    QUALITY.md pitch cliff). Uses the DEFAULT auto band ladder (parity +
    dense fallback), i.e. what a user gets out of the box."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from spherical_ba.core import rotation
    from spherical_ba.models import evaluation, twoview
    from spherical_ba.utils import synthetic
    from spherical_ba.utils.config import FrontendConfig

    base = dataclasses.replace(bench_config(), frontend=FrontendConfig())
    cfg = corrected_mode(base)
    step = jax.jit(jax.vmap(partial(twoview.run_two_view, cfg=cfg, frontend="band")))
    rng = np.random.default_rng(seed)
    out = {}
    for pitch in cells:
        eulers = np.stack(
            [
                rng.uniform(-3, 3, pairs_per_cell),
                pitch + rng.uniform(-1.5, 1.5, pairs_per_cell),
                rng.uniform(-3, 3, pairs_per_cell),
            ],
            axis=1,
        )
        eul = jnp.asarray(np.deg2rad(eulers), jnp.float32)
        keys = jax.random.split(jax.random.PRNGKey(seed + int(pitch)), pairs_per_cell)
        Rs = jax.vmap(rotation.euler_to_matrix)(eul)
        lefts = jax.vmap(
            lambda k: synthetic.render_erp(k, jnp.eye(3), height, width)
        )(keys)
        rights = jax.vmap(
            lambda k, R: synthetic.render_erp(k, R.T, height, width)
        )(keys, Rs)
        res = step(lefts, rights, jax.random.split(jax.random.PRNGKey(3), pairs_per_cell))
        ev = jax.vmap(
            partial(evaluation.evaluate_matches, width=width, height=height, cfg=cfg)
        )(_as_frontend_result(res), Rs)
        errs = rot_err_deg_host(res.rotation_aa, Rs)  # f64, host
        out[f"pitch_{int(pitch)}"] = {
            "mean_matches": float(np.mean(np.asarray(ev.num_matches))),
            "mean_outlier_pct": float(np.mean(np.asarray(ev.outlier_pct))),
            "rot_err_deg": [round(float(e), 4) for e in errs],
            "median_rot_err_deg": float(np.median(errs)),
            "max_rot_err_deg": float(np.max(errs)),
        }
        _log(f"pitch cell {pitch}: matches={out[f'pitch_{int(pitch)}']['mean_matches']:.1f} "
             f"outl%={out[f'pitch_{int(pitch)}']['mean_outlier_pct']:.1f} "
             f"max_err={out[f'pitch_{int(pitch)}']['max_rot_err_deg']:.2f}")
    return out


def check_gates_pitch(cells):
    breaches = []

    def gate(cond, msg):
        if not cond:
            breaches.append(msg)

    for name, c in cells.items():
        pitch = int(name.split("_")[1])
        thr = GATE_CELL_MAX_ROT_ERR[pitch]
        gate(c["mean_matches"] >= GATE_CELL_MIN_MATCHES,
             f"{name}: mean_matches {c['mean_matches']:.1f} < {GATE_CELL_MIN_MATCHES}")
        gate(c["mean_outlier_pct"] <= GATE_CELL_MAX_OUTLIER_PCT,
             f"{name}: outlier% {c['mean_outlier_pct']:.1f} > {GATE_CELL_MAX_OUTLIER_PCT}")
        gate(c["max_rot_err_deg"] <= thr,
             f"{name}: max rot err {c['max_rot_err_deg']:.2f} > {thr} deg")
    return (not breaches), breaches


def _as_frontend_result(res):
    from spherical_ba.models.frontend import FrontendResult

    return FrontendResult(
        left_xy=res.left_xy,
        right_xy=res.right_xy,
        match_valid=res.match_valid,
        match_distance=res.match_distance,
        total_keypoints=res.total_keypoints,
    )


def check_gates(acc):
    """Accuracy thresholds; returns (ok, list of breaches)."""
    breaches = []

    def gate(cond, msg):
        if not cond:
            breaches.append(msg)

    for mode in ("compat", "corrected"):
        a = acc[mode]
        gate(a["mean_matches"] >= GATE_MIN_MATCHES,
             f"{mode}: mean_matches {a['mean_matches']:.1f} < {GATE_MIN_MATCHES}")
        gate(a["mean_outlier_pct"] <= GATE_MAX_OUTLIER_PCT,
             f"{mode}: outlier% {a['mean_outlier_pct']:.2f} > {GATE_MAX_OUTLIER_PCT}")
        gate(a["mean_trimmed_err_deg"] <= GATE_MAX_TRIM_ERR_DEG,
             f"{mode}: trimmed err {a['mean_trimmed_err_deg']:.3f} deg > {GATE_MAX_TRIM_ERR_DEG}")
    gate(acc["compat"]["median_rot_err_deg"] <= GATE_MED_ROT_ERR_COMPAT,
         f"compat median rot err {acc['compat']['median_rot_err_deg']:.3f} > {GATE_MED_ROT_ERR_COMPAT} deg")
    gate(acc["compat"]["max_rot_err_deg"] <= GATE_MAX_ROT_ERR_COMPAT,
         f"compat max rot err {acc['compat']['max_rot_err_deg']:.3f} > {GATE_MAX_ROT_ERR_COMPAT} deg")
    gate(acc["corrected"]["median_rot_err_deg"] <= GATE_MED_ROT_ERR_CORRECT,
         f"corrected median rot err {acc['corrected']['median_rot_err_deg']:.3f} > {GATE_MED_ROT_ERR_CORRECT} deg")
    gate(acc["corrected"]["max_rot_err_deg"] <= GATE_MAX_ROT_ERR_CORRECT,
         f"corrected max rot err {acc['corrected']['max_rot_err_deg']:.3f} > {GATE_MAX_ROT_ERR_CORRECT} deg")
    return (not breaches), breaches


def check_gates_2k(acc2k, label="2k"):
    """2K-workload gates (corrected mode carries the tight bounds; compat
    is covered by the trim/outlier gates shared through `corrected`'s
    frontend — both modes share one frontend, see measure_accuracy)."""
    breaches = []

    def gate(cond, msg):
        if not cond:
            breaches.append(msg)

    a = acc2k.get("corrected")
    if a is None:
        return False, [f"{label}: corrected accuracy missing"]
    gate(a["mean_matches"] >= GATE_2K_MIN_MATCHES,
         f"{label}: mean_matches {a['mean_matches']:.1f} < {GATE_2K_MIN_MATCHES}")
    gate(a["mean_outlier_pct"] <= GATE_2K_MAX_OUTLIER_PCT,
         f"{label}: outlier% {a['mean_outlier_pct']:.2f} > {GATE_2K_MAX_OUTLIER_PCT}")
    gate(a["median_rot_err_deg"] <= GATE_2K_MED_ROT_ERR_CORRECT,
         f"{label} corrected median rot err {a['median_rot_err_deg']:.3f} > {GATE_2K_MED_ROT_ERR_CORRECT} deg")
    gate(a["max_rot_err_deg"] <= GATE_2K_MAX_ROT_ERR_CORRECT,
         f"{label} corrected max rot err {a['max_rot_err_deg']:.3f} > {GATE_2K_MAX_ROT_ERR_CORRECT} deg")
    # compat mode is present in the full acc2k but not the
    # 4-pair live spot-check; gate it whenever it exists
    c = acc2k.get("compat")
    if c is not None:
        gate(c["median_rot_err_deg"] <= GATE_2K_MED_ROT_ERR_COMPAT,
             f"{label} compat median rot err {c['median_rot_err_deg']:.3f} > {GATE_2K_MED_ROT_ERR_COMPAT} deg")
        gate(c["max_rot_err_deg"] <= GATE_2K_MAX_ROT_ERR_COMPAT,
             f"{label} compat max rot err {c['max_rot_err_deg']:.3f} > {GATE_2K_MAX_ROT_ERR_COMPAT} deg")
    return (not breaches), breaches


def _measure(label, fn):
    """Run one optional section; an exception is recorded, not raised."""
    try:
        return fn()
    except Exception as e:  # a section failure must not hide the others
        traceback.print_exc()
        err = str(e).split("\n")[0][:300]
        _log(f"{label} FAILED: {err[:80]}")
        return {"error": err}


def main():
    import jax

    from spherical_ba.utils import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform} ({dev.device_kind})")
    compile_cache.enable()
    quick = os.environ.get("BENCH_QUICK", "0") == "1"
    full = os.environ.get("BENCH_FULL", "0") == "1"
    t_start = time.perf_counter()
    device_kind = dev.device_kind
    _log(f"backend={jax.default_backend()} device={device_kind}")

    timer = Timer()
    detail = {
        "backend": jax.default_backend(),
        "device_kind": device_kind,
        "device_count": len(jax.devices()),
    }

    # headline: knee batch
    head = measure_point(timer, BATCH, BENCH_H, BENCH_W, reps=max(2, 64 // BATCH))
    _log(f"headline batch={BATCH}: {head['pairs_per_s']:.1f} pairs/s")
    detail["headline"] = head

    # accuracy gates (always on)
    acc = measure_accuracy()
    detail["accuracy"] = acc
    ok, breaches = check_gates(acc)
    detail["accuracy_ok"] = ok

    # Sections measured only under BENCH_FULL=1; otherwise "not measured"
    # (never a breach, never a number from elsewhere).
    sections = {}
    if full and not quick:
        sweep = []
        for b in SWEEP_BATCHES:
            if b == BATCH:
                sweep.append(head)
                continue
            sweep.append(_measure(f"sweep batch={b}", lambda b=b: measure_point(
                timer, b, BENCH_H, BENCH_W, reps=max(2, 64 // b), n=2)))
        sections["sweep"] = sweep
        # the reference's actual workload: one full-res 2K ERP pair
        sections["erp2k"] = _measure("erp2k", lambda: measure_point(
            timer, 1, 1024, 2048, reps=4, cfg=bench_config_2k(), n=2))
        sections["acc2k"] = _measure("acc2k", lambda: measure_accuracy(
            height=1024, width=2048, seeds=(43,), pairs_per_seed=8,
            cfg=bench_config_2k()))
        # dense 22.5-deg ladder (quality preset) at the headline point
        sections["ladder_dense"] = _measure("ladder_dense", lambda: measure_point(
            timer, BATCH, BENCH_H, BENCH_W, reps=max(2, 32 // BATCH),
            cfg=bench_config().quality(), n=2))
        # the TRUE default config (auto ladder, two-pass batched)
        sections["default_auto"] = _measure(
            "default_auto", lambda: measure_default_auto(timer, BATCH))
        sections["stages"] = _measure(
            "stages", lambda: measure_stages(timer, max(BATCH, 4), reps=12))
    for k in ("sweep", "erp2k", "stages", "acc2k", "ladder_dense", "default_auto"):
        detail[k] = sections.get(k, NOT_MEASURED)

    # 2K accuracy: a live corrected-mode spot-check on every non-quick run
    # (4 pairs bounds the extra compile to one pipeline signature).
    if not quick:
        detail["acc2k_live"] = _measure("acc2k_live", lambda: measure_accuracy(
            height=1024, width=2048, seeds=(43,), pairs_per_seed=4,
            cfg=bench_config_2k(), modes=("corrected",)))
        if "error" in detail["acc2k_live"]:
            ok = False
            breaches = breaches + ["2k-live: " + detail["acc2k_live"]["error"]]
        else:
            ok2l, b2l = check_gates_2k(detail["acc2k_live"], label="2k-live")
            detail["accuracy_2k_live_ok"] = ok2l
            if b2l:
                ok = False
                breaches = breaches + b2l

    # Pitch-cell gates: live each non-quick run, default auto-ladder
    # config — the regime the parity ladder's cliff lives in.
    if not quick:
        detail["pitch_cells"] = _measure("pitch cells", measure_pitch_cells)
        if "error" in detail["pitch_cells"]:
            ok = False
            breaches = breaches + ["pitch cells: " + detail["pitch_cells"]["error"]]
        else:
            okp, bp = check_gates_pitch(detail["pitch_cells"])
            detail["pitch_cells_ok"] = okp
            if bp:
                ok = False
                breaches = breaches + bp

    # Default-config (auto ladder) batched throughput: the two-pass auto
    # batch must stay within 30% of the parity headline of the same run.
    da = detail["default_auto"]
    if isinstance(da, dict) and "pairs_per_s" in da:
        ok_da = da["pairs_per_s"] >= 0.7 * head["pairs_per_s"]
        detail["default_auto_ok"] = ok_da
        if not ok_da:
            ok = False
            breaches = breaches + [
                f"default_auto: {da['pairs_per_s']:.1f} pairs/s < 0.7x "
                f"parity {head['pairs_per_s']:.1f}"
            ]

    # full-2K gates (8 pairs, both modes), when measured
    a2k = detail["acc2k"]
    if isinstance(a2k, dict) and "corrected" in a2k:
        ok2k, b2k = check_gates_2k(a2k)
        detail["accuracy_2k_ok"] = ok2k
        if b2k:
            ok = False
            breaches = breaches + b2k
    if breaches:
        detail["breaches"] = breaches

    frozen = {}
    if os.path.exists(FROZEN):
        with open(FROZEN) as f:
            frozen = json.load(f)
    baseline = frozen.get("cpu_pairs_per_s")
    vs = head["pairs_per_s"] / baseline if baseline else 0.0
    b2 = frozen.get("cpu_pairs_per_s_2k")
    erp2k = detail["erp2k"]
    if b2 and isinstance(erp2k, dict) and "pairs_per_s" in erp2k:
        erp2k["vs_baseline_2k"] = round(erp2k["pairs_per_s"] / b2, 3)
    detail["bench_wall_s"] = time.perf_counter() - t_start

    # Full detail goes to a sidecar file; the printed line stays small.
    detail_file = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BENCH_DETAIL.json"
    )
    with open(detail_file, "w") as f:
        json.dump(detail, f, indent=1)
    _log(f"wrote {detail_file}")

    def flag(key):
        return detail.get(key, NOT_MEASURED)

    summary = {
        "metric": "two_view_ba_pairs_per_s",
        "value": round(head["pairs_per_s"], 4),
        "unit": f"pairs/s (512x1024 ERP, full pipeline, batch {BATCH})",
        "device": {"platform": dev.platform, "kind": device_kind,
                   "count": len(jax.devices())},
        "vs_baseline": round(vs, 3),
        "ms_per_pair": round(head["ms_per_pair"], 3),
        "matches_per_pair": head["matches_per_pair"],
        "gates_ok": bool(ok),
        "accuracy_ok": bool(detail["accuracy_ok"]),
        "accuracy_2k_ok": flag("accuracy_2k_ok"),
        "accuracy_2k_live_ok": flag("accuracy_2k_live_ok"),
        "pitch_cells_ok": flag("pitch_cells_ok"),
        "default_auto_ok": flag("default_auto_ok"),
        "n_breaches": len(breaches),
        "detail_file": os.path.basename(detail_file),
    }
    if isinstance(erp2k, dict) and "vs_baseline_2k" in erp2k:
        summary["vs_baseline_2k"] = erp2k["vs_baseline_2k"]
        summary["ms_per_pair_2k"] = round(erp2k["ms_per_pair"], 2)
    print(json.dumps(summary))
    if not ok:
        _log("ACCURACY GATE BREACH: " + "; ".join(breaches))
        sys.exit(1)


if __name__ == "__main__":
    main()
