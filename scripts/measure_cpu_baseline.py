"""One-time measurement of the host-CPU throughput for the bench
workloads; frozen into BASELINE_FROZEN.json as the reference-class CPU
figures (the reference publishes no numbers, SURVEY.md §6 — this is the
same full pipeline executed on CPU, the reference's platform).

  python scripts/measure_cpu_baseline.py        # 512x1024 headline figure
  python scripts/measure_cpu_baseline.py 2k     # add the 2K figure only

Existing frozen keys are preserved: the 512 figure frozen in round 1 is
never silently re-measured (vs_baseline must stay comparable across
rounds); `2k` adds cpu_pairs_per_s_2k next to it.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import bench

assert jax.default_backend() == "cpu", jax.default_backend()

frozen = {}
if os.path.exists(bench.FROZEN):
    with open(bench.FROZEN) as f:
        frozen = json.load(f)

timer = bench.Timer()
mode = sys.argv[1] if len(sys.argv) > 1 else "512"

if mode == "2k":
    res = bench.measure_point(
        timer, 1, 1024, 2048, reps=1, cfg=bench.bench_config_2k(), n=2
    )
    frozen["cpu_pairs_per_s_2k"] = res["pairs_per_s"]
    frozen["detail_2k"] = {**res, "backend": "cpu",
                           "workload": "two-view BA 1024x2048 ERP, full "
                                       "pipeline, 2K-tuned capacity"}
else:
    if "cpu_pairs_per_s" in frozen:
        sys.exit("512 figure already frozen; delete the key to re-measure")
    res = bench.measure_point(timer, 1, bench.BENCH_H, bench.BENCH_W, reps=2)
    frozen.update(
        cpu_pairs_per_s=res["pairs_per_s"],
        workload=f"two-view BA {bench.BENCH_H}x{bench.BENCH_W} ERP, full pipeline",
        host="2-vCPU container (bench-time host)",
        detail={**res, "backend": "cpu"},
    )

with open(bench.FROZEN, "w") as f:
    json.dump(frozen, f, indent=2)
print(json.dumps(frozen))
