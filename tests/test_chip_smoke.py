"""chip_smoke.py on the CPU: it must refuse to run (no GPU), and every
phase must run end to end at tiny sizes through the same code."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def _finite_numbers(rec):
    for v in rec.values():
        if isinstance(v, dict):
            _finite_numbers(v)
        elif isinstance(v, float):
            assert np.isfinite(v), rec


@pytest.mark.parametrize(
    "name", [n for n, _ in chip_smoke.PHASES + chip_smoke.FOUR_CARD_PHASES]
)
def test_phase_runs_tiny(name):
    """Each phase at TINY size (the four-card ones on 4 of the 8 virtual
    CPU devices): it returns its numbers and checks as one JSON-able
    record. The accuracy gates are set for the full sizes, so at TINY only
    the solver phases must pass theirs."""
    fn = dict(chip_smoke.PHASES + chip_smoke.FOUR_CARD_PHASES)[name]
    rec = fn(43, chip_smoke.TINY)
    json.dumps(rec)
    assert isinstance(rec["failures"], list)
    _finite_numbers(rec)
    if "multiview" in name:
        assert rec["failures"] == []
