"""Smoke tests: every ``examples/*.py`` must run to exit 0 on tiny inputs.

API drift in the examples (the round-2 ``summarize()`` key confusion class
of bug) breaks this suite, not users.  Each example runs in a subprocess on
the CPU backend with a small virtual mesh; ``pod_scan.py`` runs its
single-process path (``initialize_distributed`` is a no-op locally).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples").glob("*.py"))


def _env():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    })
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env.pop(k, None)
    return env


def test_every_example_is_covered():
    names = {p.name for p in EXAMPLES}
    assert names == {
        "basic_fasta.py", "serving_session.py", "analytics_workflow.py",
        "per_chromosome.py", "pod_scan.py", "matrix_export.py",
        "region_workflow.py",
    }, "new example? add a smoke test row"


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.name)
def test_example_runs_clean(script, tmp_path):
    res = subprocess.run(
        [sys.executable, "-u", str(script)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), timeout=300, cwd=tmp_path,  # outputs land in tmp
    )
    assert res.returncode == 0, f"{script.name}:\n{res.stdout[-3000:]}"
    assert res.stdout.strip(), script.name  # every example prints something
