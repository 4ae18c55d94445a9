"""Test configuration: force CPU with a virtual 8-device mesh.

Tests run on the CPU backend (fast, deterministic, full f64) with
``xla_force_host_platform_device_count=8`` so multi-device sharding tests
exercise a real 8-device mesh without accelerators — the analogue of the
reference's solver-free unit strategy (SURVEY.md section 4).  Tests that
need a GPU are marked ``gpu`` and decide inside the test whether one is
present.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: mesh-iteration programs recompile per
# shape; caching them across test runs cuts wall time drastically.
from pycollo_tpu.utils import configure_compile_cache  # noqa: E402

configure_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def brachistochrone_problem():
    """Fully-defined, uninitialised brachistochrone fixture
    (parity with ``tests/unit/conftest.py:14-56`` of the reference)."""
    import sympy as sym
    from pycollo_tpu import OptimalControlProblem

    x, y, v, u = sym.symbols("x y v u")
    problem = OptimalControlProblem(name="Brachistochrone")
    phase = problem.new_phase(name="A")
    phase.state_variables = [x, y, v]
    phase.control_variables = u
    g = sym.Symbol("g")
    phase.state_equations = [v * sym.sin(u), v * sym.cos(u),
                             g * sym.cos(u)]
    problem.auxiliary_data = {g: 9.81}
    problem.objective_function = phase.final_time_variable
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [0, 10]
    phase.bounds.state_variables = [[0, 10], [0, 10], [-50, 50]]
    phase.bounds.control_variables = [[-np.pi / 2, np.pi / 2]]
    phase.bounds.initial_state_constraints = {x: 0, y: 0, v: 0}
    phase.bounds.final_state_constraints = {x: 2, y: 2}
    phase.guess.time = np.array([0, 10])
    phase.guess.state_variables = np.array([[0, 2], [0, 2], [0, 0]])
    phase.guess.control_variables = np.array([[0, np.pi / 2]])
    return problem


@pytest.fixture
def cart_pole_problem():
    """Cart-pole swing-up fixture (Kelly 2017), the batched-MPC workload
    of BASELINE.json."""
    import sympy as sym
    from pycollo_tpu import OptimalControlProblem

    q1, q2, q1d, q2d = sym.symbols("q1 q2 q1d q2d")
    F = sym.Symbol("F")
    q1dd, q2dd = sym.symbols("q1dd q2dd")
    m1, m2, l, g = sym.symbols("m1 m2 l g")

    problem = OptimalControlProblem(name="Cart-Pole Swing-Up")
    phase = problem.new_phase(name="A")
    phase.state_variables = [q1, q2, q1d, q2d]
    phase.control_variables = F
    phase.state_equations = [q1d, q2d, q1dd, q2dd]
    phase.integrand_functions = [F ** 2]
    phase.bounds.initial_time = 0
    phase.bounds.final_time = 2.0
    phase.bounds.state_variables = {q1: [-2, 2], q2: [-10, 10],
                                    q1d: [-10, 10], q2d: [-10, 10]}
    phase.bounds.control_variables = {F: [-20, 20]}
    phase.bounds.integral_variables = [[0, 100]]
    phase.bounds.initial_state_constraints = {q1: 0, q2: 0, q1d: 0, q2d: 0}
    phase.bounds.final_state_constraints = {q1: 1.0, q2: np.pi,
                                            q1d: 0, q2d: 0}
    phase.guess.time = [0, 2.0]
    phase.guess.state_variables = [[0, 1.0], [0, np.pi], [0, 0], [0, 0]]
    phase.guess.control_variables = [[0, 0]]
    phase.guess.integral_variables = [0]
    q1dd_eqn = (l * m2 * sym.sin(q2) * q2d ** 2 + F
                + m2 * g * sym.cos(q2) * sym.sin(q2)) \
        / (m1 + m2 * (1 - sym.cos(q2) ** 2))
    q2dd_eqn = -(l * m2 * sym.cos(q2) * sym.sin(q2) * q2d ** 2
                 + F * sym.cos(q2) + (m1 + m2) * g * sym.sin(q2)) \
        / (l * m1 + l * m2 * (1 - sym.cos(q2) ** 2))
    problem.objective_function = phase.integral_variables[0]
    problem.auxiliary_data = {g: 9.81, l: 0.5, m1: 1.0, m2: 0.3,
                              q1dd: q1dd_eqn, q2dd: q2dd_eqn}
    return problem
