"""GPU device test (``@pytest.mark.gpu``).

The rest of the suite forces the CPU backend (``tests/conftest.py``), so
this test runs ``chip_smoke.py``'s factorization check in a subprocess on
the default JAX platform: the condensed-KKT Cholesky solver at the
interior-point solver's real shapes (1536, 148, 148) in f64 and f32,
against numpy f64, with one indefinite instance that must be flagged.
It skips when JAX finds no GPU.  On a GPU machine::

    python -m pytest tests/integration/test_gpu_smoke.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

_CHECK = r"""
import chip_smoke
chip_smoke.device_report()
chip_smoke.emit("factorization", ok=True, **chip_smoke.check_factorization())
"""


@pytest.mark.gpu
def test_factorization_on_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu", XLA_FLAGS="")
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.returncode != 0 or probe.stdout.strip() != "gpu":
        pytest.skip("JAX finds no GPU")
    proc = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                          capture_output=True, text=True, timeout=900,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for check in result["checks"].values():
        assert check["indefinite_flagged"] and check["spd_flagged"] == 0
        assert check["max_relative_residual"] <= check["residual_tolerance"]
