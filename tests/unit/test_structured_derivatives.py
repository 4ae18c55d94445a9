"""Structured (per-node block) derivatives must equal whole-program AD.

This is the analogue of the reference's derivative
cross-checks (``pycollo/iteration.py:1161-1242`` check-values pattern):
the block-assembled constraint Jacobian and Lagrangian Hessian are
compared against ``jax.jacrev`` / ``jax.hessian`` of the monolithic scaled
NLP functions at random interior points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _check_iteration(it, seed=0):
    derivs = it._build_structured_derivatives()
    rng = np.random.default_rng(seed)
    theta = jnp.asarray(it.theta_default)
    for trial in range(3):
        xs = jnp.asarray(it.xs_guess
                         + 0.05 * rng.standard_normal(it.n_free))
        lam = jnp.asarray(rng.standard_normal(it.layout.m_total))
        J_struct = np.asarray(derivs["jac_c"](xs, theta))
        J_ad = np.asarray(jax.jacrev(it.c_scaled)(xs, theta))
        np.testing.assert_allclose(J_struct, J_ad, atol=1e-9, rtol=1e-9)

        def lag(x):
            return it.f_scaled(x, theta) + it.c_scaled(x, theta) @ lam

        H_struct = np.asarray(derivs["hess_lag"](xs, lam, theta))
        H_ad = np.asarray(jax.hessian(lag)(xs))
        np.testing.assert_allclose(H_struct, H_ad, atol=1e-8, rtol=1e-8)


def test_brachistochrone_derivatives(brachistochrone_problem):
    brachistochrone_problem.initialise()
    _check_iteration(brachistochrone_problem.backend.mesh_iterations[0])


def test_cart_pole_derivatives(cart_pole_problem):
    """Covers integral constraints + fixed times."""
    cart_pole_problem.initialise()
    _check_iteration(cart_pole_problem.backend.mesh_iterations[0])


def test_multiphase_derivatives():
    """Covers multiple phases + endpoint linkage constraints."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent.parent / "integration"))
    from test_multiphase import variable_phase_problem
    problem = variable_phase_problem(2)
    problem.initialise()
    _check_iteration(problem.backend.mesh_iterations[0])


def test_path_constraint_derivatives():
    """Covers path-constraint rows (functional frontend)."""
    import pycollo_tpu

    problem = pycollo_tpu.OptimalControlProblem(name="PathTest")
    problem.settings.console_out_progress = False
    phase = problem.new_phase(name="A")
    phase.state_variables = ("x", "v")
    phase.control_variables = ("u",)
    phase.state_equations = lambda y, u, t, s: jnp.array(
        [y[1], u[0] - 0.1 * y[1] ** 2])
    phase.path_constraints = lambda y, u, t, s: jnp.array(
        [y[0] ** 2 + y[1] ** 2])
    phase.number_path_constraints = 1
    phase.integrand_functions = lambda y, u, t, s: jnp.array([u[0] ** 2])
    phase.number_integrand_functions = 1
    problem.objective_function = lambda ep: ep.phase[0].q[0]
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [0.5, 2.0]
    phase.bounds.state_variables = [[-2, 2], [-3, 3]]
    phase.bounds.control_variables = [[-5, 5]]
    phase.bounds.integral_variables = [[0, 50]]
    phase.bounds.path_constraints = [[0, 3.5]]
    phase.bounds.initial_state_constraints = [[0, 0], [1, 1]]
    phase.guess.time = [0.0, 1.0]
    phase.guess.state_variables = [[0, 0.5], [1, 0.5]]
    phase.guess.control_variables = [[0, 0]]
    phase.guess.integral_variables = [1.0]
    problem.initialise()
    _check_iteration(problem.backend.mesh_iterations[0])
