#!/usr/bin/env python3
"""Smoke run of the system's main paths on NVIDIA GPUs.

    python chip_smoke.py [--seed 43]        # one card: every one-card phase
    python chip_smoke.py --four-cards       # four cards: the sharded paths

One-card phases, each through the entry points a user calls, at the
repository's full widths, on synthetic inputs generated from --seed:

  two_view_2k  4 pairs at 1024x2048 (bench.bench_config_2k: k512, 4
               octaves, m1024) through twoview.run_two_view, compat and
               corrected mode; host-side f64 rotation errors held to the
               bench.py 2K gates
  batch_512    64 pairs at 512x1024 through twoview.run_two_view_batch
               (auto band ladder, bench_config capacities); held to
               GATE_MIN_MATCHES and GATE_MAX_OUTLIER_PCT
  multiview    multiview.solve_multiview at C=256, L=8192, P=4 with PCG:
               the cost must fall and the poses approach ground truth
  sequence     sequence.run_sequence over 10 keyframes at 512x1024; the
               pairwise and chained rotations must stay within the drift
               bounds of tests/test_sequence.py

--four-cards runs only the sharded paths and what they are compared with
(run_two_view_batch / solve_multiview on one card).

Every phase prints one JSON line: compile seconds, warm wall seconds
(ended by block_until_ready), memory_analysis() of its step,
peak_bytes_in_use (process peak so far), its checks and the card's name
and power limit from nvidia-smi. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU, or when any phase fails, the script exits non-zero and
prints no such line. All phases run in this one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from functools import partial

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


@dataclasses.dataclass(frozen=True)
class Scale:
    """Problem sizes of every phase; FULL is what the script runs, TINY
    keeps the same code paths small enough for a CPU test."""

    two_view: tuple   # (pairs, H, W)
    batch: tuple      # (pairs, H, W)
    multiview: tuple  # (cameras C, landmarks L, observations per landmark P)
    sequence: tuple   # (frames, H, W)
    shard_pairs: int  # pairs in the sharded two-view batch
    tiny: bool


FULL = Scale((4, 1024, 2048), (64, 512, 1024), (256, 8192, 4),
             (10, 512, 1024), 16, False)
TINY = Scale((1, 64, 128), (2, 64, 128), (8, 256, 4), (3, 64, 128), 4, True)
BATCH_CHUNK = 4


def card_info() -> list[str]:
    """nvidia-smi's name and power limit of every card, from a child
    process that does not touch JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable ({type(e).__name__})"]
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


# ---------------------------------------------------------------------------
# measurement helpers


def _compile(jitted, *args, **kwargs):
    """AOT-compile a jitted step; returns (compiled, seconds)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kwargs).compile()
    return compiled, time.perf_counter() - t0


def _memory(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes")
    return {f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)}


def _peak_bytes():
    import jax

    peaks = []
    for d in jax.local_devices():
        stats = d.memory_stats()
        if stats and "peak_bytes_in_use" in stats:
            peaks.append(int(stats["peak_bytes_in_use"]))
    return max(peaks) if peaks else None


def _wall(fn, reps):
    """Median warm wall seconds of fn(), each run ended by
    block_until_ready."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _timed_first(fn):
    """(result, seconds) of a first call (compile or cache load + run)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _small_cfg():
    """Pipeline capacities for TINY runs."""
    from spherical_ba.utils.config import MatchConfig, PipelineConfig, SurfConfig

    return PipelineConfig(
        surf=SurfConfig(max_keypoints=32, n_octaves=1),
        match=MatchConfig(max_matches=64, ratio_thresh=0.6),
    ).parity()


def _with_ladder(cfg, ladder):
    return dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, band_ladder=ladder)
    )


def _match_quality(res, Rs, width, height, cfg):
    """Mean matches, mean outlier% @ 2 deg and host-side f64 rotation
    errors of a batch of two-view results."""
    import jax
    import numpy as np

    import bench
    from spherical_ba.models import evaluation

    ev = jax.vmap(
        partial(evaluation.evaluate_matches, width=width, height=height, cfg=cfg)
    )(bench._as_frontend_result(res), Rs)
    errs = bench.rot_err_deg_host(res.rotation_aa, Rs)
    return {
        "mean_matches": float(np.mean(np.asarray(ev.num_matches))),
        "mean_outlier_pct": float(np.mean(np.asarray(ev.outlier_pct))),
        "rot_err_deg": [round(float(e), 4) for e in errs],
        "median_rot_err_deg": float(np.median(errs)),
        "max_rot_err_deg": float(np.max(errs)),
    }


def _gt_rotations(eulers):
    import jax

    from spherical_ba.core import rotation

    return jax.vmap(rotation.euler_to_matrix)(eulers)


# ---------------------------------------------------------------------------
# one-card phases


def phase_two_view_2k(seed: int, scale: Scale) -> dict:
    import jax
    import jax.numpy as jnp

    import bench
    from spherical_ba.models import twoview

    n, h, w = scale.two_view
    base = _small_cfg() if scale.tiny else bench.bench_config_2k()
    lefts, rights, eulers = bench.make_batch_gt(n, h, w, seed=seed)
    Rs = _gt_rotations(eulers)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), n)
    rec, acc = {"pairs": n, "height": h, "width": w}, {}
    for mode, cfg in (("compat", base), ("corrected", bench.corrected_mode(base))):
        step = jax.jit(partial(twoview.run_two_view, cfg=cfg, frontend="band"))
        compiled, compile_s = _compile(step, lefts[0], rights[0], keys[0])

        def run_all():
            return [compiled(lefts[i], rights[i], keys[i]) for i in range(n)]

        res = jax.block_until_ready(run_all())
        warm = _wall(run_all, reps=2)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *res)
        acc[mode] = _match_quality(stacked, Rs, w, h, cfg)
        rec[mode] = {
            "compile_s": compile_s,
            "warm_s_per_pair": warm / n,
            "memory": _memory(compiled),
            **acc[mode],
        }
    _, breaches = bench.check_gates_2k(acc)
    rec["failures"] = breaches
    return rec


def phase_batch_512(seed: int, scale: Scale) -> dict:
    import jax

    import bench
    from spherical_ba.models import twoview

    n, h, w = scale.batch
    base = _small_cfg() if scale.tiny else bench.bench_config()
    cfg = _with_ladder(base, "auto")
    lefts, rights, eulers = bench.make_batch_gt(n, h, w, seed=seed + 2)
    Rs = _gt_rotations(eulers)
    keys = jax.random.split(jax.random.PRNGKey(seed + 3), n)
    # the first pass of the auto ladder: the whole batch on the parity
    # ladder (run_two_view_batch calls this same jitted executor)
    compiled, compile_s = _compile(
        twoview._run_batch_chunked, lefts, rights, keys,
        cfg=_with_ladder(base, "parity"), frontend="band",
        batch_chunk=BATCH_CHUNK,
    )

    def run():
        return twoview.run_two_view_batch(
            lefts, rights, keys, cfg, "band", batch_chunk=BATCH_CHUNK
        )

    res, first_s = _timed_first(run)
    warm = _wall(run, reps=3)
    q = _match_quality(res, Rs, w, h, cfg)
    failures = []
    if not q["mean_matches"] >= bench.GATE_MIN_MATCHES:
        failures.append(f"mean_matches {q['mean_matches']:.1f} < {bench.GATE_MIN_MATCHES}")
    if not q["mean_outlier_pct"] <= bench.GATE_MAX_OUTLIER_PCT:
        failures.append(f"outlier% {q['mean_outlier_pct']:.2f} > {bench.GATE_MAX_OUTLIER_PCT}")
    q.pop("rot_err_deg")
    return {
        "pairs": n, "height": h, "width": w, "batch_chunk": BATCH_CHUNK,
        "compile_s": compile_s,
        "first_call_s": first_s,
        "warm_s_per_batch": warm,
        "pairs_per_s": n / warm,
        "memory": _memory(compiled),
        **q,
        "failures": failures,
    }


MV_SOLVE = dict(num_iters=8, linear_solver="pcg", cg_iters=60, cg_tol=1e-5)


def _mv_checks(costs, poses, poses_gt, label=""):
    import numpy as np

    from spherical_ba.models import evaluation

    c0, c1 = float(costs[0]), float(costs[-1])
    ang, terr = evaluation.pose_errors_host(np.asarray(poses), poses_gt)
    out = {
        f"{label}cost_first": c0,
        f"{label}cost_last": c1,
        f"{label}median_rot_err_deg": float(np.median(ang)),
        f"{label}median_tran_err": float(np.median(terr)),
    }
    failures = []
    if not c1 < 1e-4 * c0:
        failures.append(f"{label}cost {c0:.3e} -> {c1:.3e} (needs < 1e-4x)")
    if not np.median(ang) < 0.2:
        failures.append(f"{label}median rot err {np.median(ang):.3f} deg >= 0.2")
    if not np.median(terr) < 0.02:
        failures.append(f"{label}median tran err {np.median(terr):.4f} >= 0.02")
    return out, failures


def _mv_problem(seed, scale):
    from spherical_ba.utils import synthetic

    C, L, P = scale.multiview
    return synthetic.multiview_problem(C=C, L=L, P=P, pose_noise=0.03, seed=seed)


def phase_multiview(seed: int, scale: Scale) -> dict:
    import jax

    from spherical_ba.models import multiview as mv

    prob, poses_gt, _ = _mv_problem(seed, scale)
    step = jax.jit(lambda p: mv.solve_multiview(p, **MV_SOLVE))
    compiled, compile_s = _compile(step, prob)
    solved, costs = jax.block_until_ready(compiled(prob))
    warm = _wall(lambda: compiled(prob), reps=3)
    checks, failures = _mv_checks(costs, solved.poses, poses_gt)
    C, L, P = scale.multiview
    return {
        "C": C, "L": L, "P": P, **MV_SOLVE,
        "compile_s": compile_s,
        "warm_s": warm,
        "memory": _memory(compiled),
        **checks,
        "failures": failures,
    }


def phase_sequence(seed: int, scale: Scale) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from spherical_ba.core import rotation
    from spherical_ba.models import evaluation, sequence
    from spherical_ba.utils import synthetic

    n, h, w = scale.sequence
    base = _small_cfg() if scale.tiny else bench.bench_config()
    cfg = dataclasses.replace(
        base, ba=dataclasses.replace(base.ba, reference_compat=False)
    )
    rng = np.random.default_rng(seed)
    steps = rng.uniform(-3.0, 3.0, (n - 1, 3))
    eulers = np.deg2rad(np.concatenate([np.zeros((1, 3)), np.cumsum(steps, 0)]))
    eulers = jnp.asarray(eulers, jnp.float32)
    key = jax.random.PRNGKey(seed)
    Rs = _gt_rotations(eulers)
    frames = jax.vmap(lambda R: synthetic.render_erp(key, R.T, h, w))(Rs)
    compiled, compile_s = _compile(
        sequence.pairwise_odometry, frames, key, cfg=cfg, frontend="band"
    )

    def run():
        return sequence.run_sequence(frames, key, cfg, frontend="band")

    out, first_s = _timed_first(run)
    warm = _wall(run, reps=2)

    Rs = np.asarray(Rs, np.float64)
    R_est = evaluation.angle_axis_to_matrix_host(np.asarray(out.pairwise_rot))
    R_rel_gt = np.einsum("nij,nkj->nik", Rs[1:], Rs[:-1])
    pair_err = evaluation.geodesic_deg_host(R_est, R_rel_gt)
    R_last = evaluation.angle_axis_to_matrix_host(np.asarray(out.poses[-1, :3]))
    drift = float(evaluation.geodesic_deg_host(R_last, Rs[-1]))
    pg0, pg1 = float(out.pg_costs[0]), float(out.pg_costs[-1])
    failures = []
    if not np.all(pair_err < 2.0):
        failures.append(f"pairwise rotation errors {np.round(pair_err, 3).tolist()} (bound 2 deg)")
    if not drift < 4.0:
        failures.append(f"final pose rotation drift {drift:.3f} deg (bound 4)")
    if not pg1 <= pg0 + 1e-6:
        failures.append(f"pose-graph cost rose {pg0:.3e} -> {pg1:.3e}")
    return {
        "frames": n, "height": h, "width": w,
        "compile_s_odometry": compile_s,
        "first_call_s": first_s,
        "warm_s": warm,
        "memory_odometry": _memory(compiled),
        "max_pair_rot_err_deg": float(np.max(pair_err)),
        "final_drift_deg": drift,
        "pg_cost_first": pg0,
        "pg_cost_last": pg1,
        "failures": failures,
    }


# ---------------------------------------------------------------------------
# four-card phases: each sharded path beside its one-card counterpart


def _mesh4():
    from spherical_ba.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(4)


def phase_sharded_two_view(seed: int, scale: Scale) -> dict:
    import jax
    import numpy as np

    import bench
    from spherical_ba.models import evaluation, twoview
    from spherical_ba.parallel import dist_ba

    n = scale.shard_pairs
    _, h, w = scale.batch
    cfg = _small_cfg() if scale.tiny else bench.bench_config()  # parity ladder
    lefts, rights, eulers = bench.make_batch_gt(n, h, w, seed=seed + 4)
    Rs = _gt_rotations(eulers)
    keys = jax.random.split(jax.random.PRNGKey(seed + 5), n)
    mesh = _mesh4()

    def sharded():
        return dist_ba.batched_two_view_sharded(lefts, rights, keys, mesh, cfg)

    def single():
        return twoview.run_two_view_batch(
            lefts, rights, keys, cfg, "band", batch_chunk=BATCH_CHUNK
        )

    res_s, first_s = _timed_first(sharded)
    warm_s = _wall(sharded, reps=3)
    res_1, first_1 = _timed_first(single)
    warm_1 = _wall(single, reps=3)
    q_s = _match_quality(res_s, Rs, w, h, cfg)
    q_1 = _match_quality(res_1, Rs, w, h, cfg)
    delta = evaluation.geodesic_deg_host(
        evaluation.angle_axis_to_matrix_host(np.asarray(res_s.rotation_aa)),
        evaluation.angle_axis_to_matrix_host(np.asarray(res_1.rotation_aa)),
    )
    dm = np.abs(np.asarray(res_s.num_matches) - np.asarray(res_1.num_matches))
    failures = []
    for label, q in (("sharded", q_s), ("one-card", q_1)):
        if not q["median_rot_err_deg"] <= bench.GATE_MED_ROT_ERR_COMPAT:
            failures.append(f"{label} median rot err {q['median_rot_err_deg']:.3f}")
        if not q["max_rot_err_deg"] <= bench.GATE_MAX_ROT_ERR_COMPAT:
            failures.append(f"{label} max rot err {q['max_rot_err_deg']:.3f}")
    return {
        "pairs": n, "height": h, "width": w, "cards": 4,
        "sharded_first_call_s": first_s,
        "sharded_warm_s": warm_s,
        "one_card_first_call_s": first_1,
        "one_card_warm_s": warm_1,
        "speedup": warm_1 / warm_s,
        "sharded_vs_one_card_rot_delta_deg_max": float(np.max(delta)),
        "sharded_vs_one_card_rot_delta_deg_median": float(np.median(delta)),
        "match_count_delta_max": int(np.max(dm)),
        "sharded": {k: v for k, v in q_s.items() if k != "rot_err_deg"},
        "one_card": {k: v for k, v in q_1.items() if k != "rot_err_deg"},
        "failures": failures,
    }


def phase_sharded_multiview(seed: int, scale: Scale) -> dict:
    import jax
    import numpy as np

    from spherical_ba.models import multiview as mv
    from spherical_ba.parallel import dist_ba

    prob, poses_gt, _ = _mv_problem(seed, scale)
    mesh = _mesh4()
    compiled, compile_s = _compile(
        dist_ba._solve_sharded, prob, mesh=mesh, num_iters=MV_SOLVE["num_iters"],
        lam0=1e-3, axis_name="data", linear_solver="pcg",
        cg_iters=MV_SOLVE["cg_iters"], cg_tol=MV_SOLVE["cg_tol"],
    )

    def sharded():
        return dist_ba.solve_multiview_sharded(prob, mesh, **MV_SOLVE)

    def single():
        return mv.solve_multiview(prob, **MV_SOLVE)

    (solved_s, costs_s), first_s = _timed_first(sharded)
    warm_s = _wall(sharded, reps=3)
    (solved_1, costs_1), first_1 = _timed_first(single)
    warm_1 = _wall(single, reps=3)
    chk_s, fail_s = _mv_checks(costs_s, solved_s.poses, poses_gt, "sharded_")
    chk_1, fail_1 = _mv_checks(costs_1, solved_1.poses, poses_gt, "one_card_")
    delta = float(np.max(np.abs(np.asarray(solved_s.poses) - np.asarray(solved_1.poses))))
    C, L, P = scale.multiview
    return {
        "C": C, "L": L, "P": P, "cards": 4, **MV_SOLVE,
        "sharded_compile_s": compile_s,
        "sharded_memory": _memory(compiled),
        "sharded_first_call_s": first_s,
        "sharded_warm_s": warm_s,
        "one_card_first_call_s": first_1,
        "one_card_warm_s": warm_1,
        "speedup": warm_1 / warm_s,
        "max_pose_delta": delta,
        **chk_s, **chk_1,
        "failures": fail_s + fail_1,
    }


def phase_sharded_multiview_batch(seed: int, scale: Scale) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from spherical_ba.models import multiview as mv
    from spherical_ba.parallel import dist_ba, mesh as mesh_lib

    problems = [_mv_problem(seed + k, scale) for k in range(2)]
    probs = jax.tree.map(lambda *xs: jnp.stack(xs), *[p for p, _, _ in problems])
    mesh = mesh_lib.make_mesh_2d(2, 2)

    def sharded():
        return dist_ba.solve_multiview_batch_sharded(probs, mesh, **MV_SOLVE)

    def single():
        return [mv.solve_multiview(p, **MV_SOLVE) for p, _, _ in problems]

    (solved_s, costs_s), first_s = _timed_first(sharded)
    warm_s = _wall(sharded, reps=3)
    res_1, first_1 = _timed_first(single)
    warm_1 = _wall(single, reps=3)
    rec, failures, deltas = {}, [], []
    for k, (_, poses_gt, _) in enumerate(problems):
        chk, fail = _mv_checks(costs_s[k], solved_s.poses[k], poses_gt, f"p{k}_")
        rec.update(chk)
        failures += fail
        deltas.append(float(np.max(np.abs(
            np.asarray(solved_s.poses[k]) - np.asarray(res_1[k][0].poses)))))
    C, L, P = scale.multiview
    return {
        "C": C, "L": L, "P": P, "problems": 2, "mesh": "2x2", **MV_SOLVE,
        "sharded_first_call_s": first_s,
        "sharded_warm_s": warm_s,
        "one_card_first_call_s": first_1,
        "one_card_warm_s": warm_1,
        "speedup": warm_1 / warm_s,
        "max_pose_delta": max(deltas),
        **rec,
        "failures": failures,
    }


PHASES = (
    ("two_view_2k", phase_two_view_2k),
    ("batch_512", phase_batch_512),
    ("multiview", phase_multiview),
    ("sequence", phase_sequence),
)
FOUR_CARD_PHASES = (
    ("sharded_two_view", phase_sharded_two_view),
    ("sharded_multiview", phase_sharded_multiview),
    ("sharded_multiview_batch", phase_sharded_multiview_batch),
)


def run_phases(phases, seed, scale, label):
    """Run phases in order; returns the names of those that failed. One
    phase's exception is reported with its traceback and fails the run,
    after the remaining phases have run."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = fn(seed, scale)
        except Exception as e:  # report, keep going, fail at the end
            traceback.print_exc()
            rec = {"failures": [f"{type(e).__name__}: {str(e)[:500]}"]}
        rec = {"phase": name, "card": label, **rec,
               "phase_wall_s": time.perf_counter() - t0,
               "peak_bytes_in_use": _peak_bytes()}
        print(json.dumps(rec), flush=True)
        if rec["failures"]:
            failed.append(name)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    cards = card_info()
    for line in cards:
        print(f"nvidia-smi: {line}", flush=True)

    import jax

    from spherical_ba.utils import compile_cache

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    cache_dir = compile_cache.enable()
    print(f"jax {jax.__version__}; compile cache {cache_dir}", flush=True)

    phases = FOUR_CARD_PHASES if args.four_cards else PHASES
    failed = run_phases(phases, args.seed, FULL, label=cards[0])
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(f"card: {cards[0]}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
