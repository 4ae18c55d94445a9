"""Brachistochrone problem.

Example 4.10 from Betts, J. T. (2010). Practical Methods for Optimal
Control and Estimation Using Nonlinear Programming (2nd ed.), p215-216.
Capability parity with the reference example
(``examples/brachistochrone/brachistochrone.py``) using the symbolic
frontend; expected objective (minimum final time) is 0.82434.
``build_functional_problem`` states the same NLP with plain JAX callables
and never imports sympy.
"""

import numpy as np

import pycollo_tpu

G = 9.81


def _set_bounds_and_guess(phase):
    """Bounds and guess shared by both frontends, keyed by name."""
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [0, 10]
    phase.bounds.state_variables = [[0, 10], [0, 10], [-50, 50]]
    phase.bounds.control_variables = [[-np.pi / 2, np.pi / 2]]
    phase.bounds.initial_state_constraints = {"x": 0, "y": 0, "v": 0}
    phase.bounds.final_state_constraints = {"x": 2, "y": 2}

    phase.guess.time = np.array([0, 10])
    phase.guess.state_variables = np.array([[0, 2], [0, 2], [0, 0]])
    phase.guess.control_variables = np.array([[0, np.pi / 2]])


def build_problem():
    import sympy as sym

    x, y, v, u = sym.symbols("x y v u")
    g = sym.Symbol("g")

    problem = pycollo_tpu.OptimalControlProblem(name="Brachistochrone")
    phase = problem.new_phase(name="A")
    phase.state_variables = [x, y, v]
    phase.control_variables = u
    phase.state_equations = [v * sym.sin(u), v * sym.cos(u),
                             g * sym.cos(u)]
    problem.auxiliary_data = {g: G}
    problem.objective_function = phase.final_time_variable
    _set_bounds_and_guess(phase)
    return problem


def build_functional_problem():
    """The same brachistochrone NLP through the functional (JAX) frontend."""
    import jax.numpy as jnp

    def dynamics(y, u, t, s):
        v, theta = y[2], u[0]
        return jnp.stack([v * jnp.sin(theta), v * jnp.cos(theta),
                          G * jnp.cos(theta)])

    problem = pycollo_tpu.OptimalControlProblem(name="Brachistochrone")
    phase = problem.new_phase(name="A")
    phase.state_variables = ("x", "y", "v")
    phase.control_variables = ("u",)
    phase.state_equations = dynamics
    problem.objective_function = lambda ep: ep.phase[0].tF
    _set_bounds_and_guess(phase)
    return problem


if __name__ == "__main__":
    problem = build_problem()
    problem.initialise()
    solution = problem.solve()
    print(f"Objective (tF): {solution.objective:.6f}  (expected 0.82434)")
