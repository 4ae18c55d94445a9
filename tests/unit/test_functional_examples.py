"""The sympy-free example builders state the same NLPs as the symbolic
ones, and the package solves them with sympy absent."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "examples"))


@pytest.mark.parametrize("module_name",
                         ["cart_pole_swing_up", "brachistochrone"])
def test_functional_builder_matches_symbolic(module_name):
    import importlib
    module = importlib.import_module(module_name)
    its = []
    for build in (module.build_problem, module.build_functional_problem):
        problem = build()
        problem.settings.console_out_progress = False
        problem.initialise()
        its.append(problem.backend.mesh_iterations[0])
    sym_it, fun_it = its
    np.testing.assert_array_equal(fun_it.xs_guess, sym_it.xs_guess)
    np.testing.assert_array_equal(fun_it.theta_default,
                                  sym_it.theta_default)
    np.testing.assert_array_equal(fun_it.xs_lb, sym_it.xs_lb)
    np.testing.assert_array_equal(fun_it.xs_ub, sym_it.xs_ub)
    np.testing.assert_allclose(fun_it.W_c, sym_it.W_c, rtol=1e-12)
    theta = jnp.asarray(sym_it.theta_default)
    rng = np.random.default_rng(0)
    for scale in (0.0, 0.05):
        xs = jnp.asarray(sym_it.xs_guess
                         + scale * rng.standard_normal(sym_it.n_free))
        np.testing.assert_allclose(fun_it.c_scaled(xs, theta),
                                   sym_it.c_scaled(xs, theta),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(fun_it.f_scaled(xs, theta),
                                   sym_it.f_scaled(xs, theta),
                                   rtol=1e-12, atol=1e-12)


_NO_SYMPY = r"""
import sys
sys.modules["sympy"] = None
sys.path.insert(0, "examples")
import pycollo_tpu
from brachistochrone import build_functional_problem
problem = build_functional_problem()
problem.settings.console_out_progress = False
problem.settings.max_mesh_iterations = 1
problem.phases[0].mesh.number_mesh_sections = 4
solution = problem.solve()
print(solution.objective)
"""


def test_solves_without_sympy():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_SYMPY], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    objective = float(proc.stdout.strip().splitlines()[-1])
    assert abs(objective - 0.82434) < 1e-3
