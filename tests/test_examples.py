"""Example smoke tests: each reference-workload counterpart must run
end-to-end on CPU (JAX_PLATFORMS=cpu) in a clean directory.

All 8 runnable workloads are covered: the flagship runmd and the bias
workload rundp run in their --quick configurations."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUICK_EXAMPLES = [
    ("runsig.py", []),
    ("compareforce.py", []),
    ("ensemble.py", []),
    ("runeam.py", ["--quick"]),
    ("runmd.py", ["--quick"]),
    ("runnegf.py", []),
    (os.path.join("current_induced", "runnegf.py"), []),
    (os.path.join("current_induced", "rundp.py"), ["--quick"]),
]


@pytest.mark.slow
@pytest.mark.parametrize("script,args",
                         QUICK_EXAMPLES,
                         ids=[s for s, _ in QUICK_EXAMPLES])
def test_example_runs(tmp_path, script, args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script)] + args,
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, (
        f"{script} failed (rc={r.returncode}):\n{r.stderr[-3000:]}")
    assert r.stdout.strip(), f"{script} produced no output"
