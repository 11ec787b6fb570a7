"""Every example of the port runs to its end on the CPU.

Each ``agilex_ntt_tpu_torch/examples/<name>.py`` carries the JAX script's
exact checks (golden models, big-int oracles, the schemes' decodes) and
exits non-zero when one fails, so rc == 0 is a check.  Each runs with
``--device cpu`` in a child process of its own with a timeout (4-11 s
each here; ``chip_smoke.py`` phase 3j runs them all on the card).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from agilex_ntt_tpu_torch.examples import NAMES

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"agilex_ntt_tpu_torch.examples.{name}",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n"
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}")
    assert proc.stdout.strip(), f"{name} printed nothing"
