"""The port stands alone: importing it and running its command-line check
loads neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import sys
import agilex_ntt_tpu_torch
from agilex_ntt_tpu_torch.__main__ import main
main(["256", "4", "--device", "cpu"])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "agilex_ntt_tpu"))
print("LEAKED", leaked)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "all checks passed (n=256" in proc.stdout
    assert "LEAKED []" in proc.stdout, proc.stdout
