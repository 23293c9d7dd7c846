"""Multi-process scale-out: real jax.distributed workers over gloo.

Exercises the actual cross-host code path (parallel/distributed.py) with
two OS processes x 4 virtual CPU devices each — the hardware-free stand-in
for a 2-host pod slice (SURVEY.md section 4 implication: multi-host tests
runnable on CPU).  The consensus result must be identical to a
single-process run over the same 8-device global mesh.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "examples", "multihost_bench.py")


def run_launcher(procs, devices_per_proc, port):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [
            sys.executable, BENCH,
            "--procs", str(procs),
            "--devices-per-proc", str(devices_per_proc),
            "--B", "16", "--N", "4", "--ticks", "1", "--sqp-iters", "1",
            "--port", str(port),
        ],
        capture_output=True, text=True, timeout=840, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:] + out.stdout[-500:]
    line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
    return json.loads(line)


@pytest.mark.slow
def test_two_process_consensus_matches_single_process():
    multi = run_launcher(2, 4, port=8491)
    single = run_launcher(1, 8, port=8493)

    assert multi["devices"] == 8 and single["devices"] == 8
    assert multi["procs"] == 2
    # Same global mesh, same lanes -> identical consensus winner and
    # near-identical control (f32, differing only in collective order).
    assert multi["best_idx"] == single["best_idx"]
    np.testing.assert_allclose(multi["u"], single["u"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        multi["f_est"], single["f_est"], rtol=1e-4, atol=1e-4
    )
    assert np.all(np.isfinite(multi["u"]))
