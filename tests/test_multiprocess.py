"""Multi-process distributed runtime test: the coordinator path of
`parallel.mesh.init_distributed` / `jax.distributed.initialize` with a
mesh axis crossing a process boundary (the CPU stand-in for a
multi-host run).

Delegates to scripts/run_multiprocess.py, which spawns 2 child processes
(4 virtual CPU devices each), runs solve_multiview_sharded on the global
(8-device) mesh, and asserts parity with the single-process solve.
Set SBA_SKIP_MULTIPROCESS=1 to skip (e.g. resource-constrained CI).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.skipif(
    os.environ.get("SBA_SKIP_MULTIPROCESS") == "1",
    reason="SBA_SKIP_MULTIPROCESS=1",
)
def test_two_process_solve_matches_single_process():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # parent script sets its own device counts
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_multiprocess.py")],
        capture_output=True,
        text=True,
        timeout=840,
        env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "max_pose_delta" in proc.stdout
