"""Cart-pole swing-up optimal control problem.

From Kelly, M. (2017). "An Introduction to Trajectory Optimization: How To
Do Your Own Direct Collocation", SIAM Review 59(4), 849-904.  Capability
parity with the reference example
(``examples/cart_pole_swing_up/cart_pole_swing_up_explicit.py``).
``build_functional_problem`` states the same NLP with plain JAX callables
and never imports sympy; it is the batched-replanning workload of
``bench.py`` and ``chip_smoke.py``.
"""

import numpy as np

import pycollo_tpu

G, L, M1, M2 = 9.81, 0.5, 1.0, 0.3
F_MAX = 20.0
D_MAX = 2.0


def _set_bounds_and_guess(phase, T, d):
    """Bounds and guess shared by both frontends, keyed by name."""
    phase.bounds.initial_time = 0
    phase.bounds.final_time = T
    phase.bounds.state_variables = {"q1": [-D_MAX, D_MAX],
                                    "q2": [-10, 10], "q1d": [-10, 10],
                                    "q2d": [-10, 10]}
    phase.bounds.control_variables = {"F": [-F_MAX, F_MAX]}
    phase.bounds.integral_variables = [[0, 100]]
    phase.bounds.initial_state_constraints = {"q1": 0, "q2": 0,
                                              "q1d": 0, "q2d": 0}
    phase.bounds.final_state_constraints = {"q1": d, "q2": np.pi,
                                            "q1d": 0, "q2d": 0}

    phase.guess.time = [0, T]
    phase.guess.state_variables = [[0, d], [0, np.pi], [0, 0], [0, 0]]
    phase.guess.control_variables = [[0, 0]]
    phase.guess.integral_variables = [0]


def build_problem(T: float = 2.0, d: float = 1.0):
    import sympy as sym

    q1, q2, q1d, q2d = sym.symbols("q1 q2 q1d q2d")
    q1dd, q2dd = sym.symbols("q1dd q2dd")
    F = sym.Symbol("F")
    m1, m2, l, g = sym.symbols("m1 m2 l g")

    problem = pycollo_tpu.OptimalControlProblem(name="Cart-Pole Swing-Up")
    phase = problem.new_phase(name="A")
    phase.state_variables = [q1, q2, q1d, q2d]
    phase.control_variables = F
    phase.state_equations = [q1d, q2d, q1dd, q2dd]
    phase.integrand_functions = [F ** 2]
    _set_bounds_and_guess(phase, T, d)

    q1dd_eqn = (l * m2 * sym.sin(q2) * q2d ** 2 + F
                + m2 * g * sym.cos(q2) * sym.sin(q2)) \
        / (m1 + m2 * (1 - sym.cos(q2) ** 2))
    q2dd_eqn = -(l * m2 * sym.cos(q2) * sym.sin(q2) * q2d ** 2
                 + F * sym.cos(q2) + (m1 + m2) * g * sym.sin(q2)) \
        / (l * m1 + l * m2 * (1 - sym.cos(q2) ** 2))

    problem.objective_function = phase.integral_variables[0]
    problem.auxiliary_data = {g: G, l: L, m1: M1, m2: M2,
                              q1dd: q1dd_eqn, q2dd: q2dd_eqn}
    return problem


def build_functional_problem(T: float = 2.0, d: float = 1.0):
    """The same cart-pole NLP through the functional (JAX) frontend."""
    import jax.numpy as jnp

    def dynamics(y, u, t, s):
        q2, q1d, q2d = y[1], y[2], y[3]
        F = u[0]
        sin, cos = jnp.sin(q2), jnp.cos(q2)
        q1dd = (L * M2 * sin * q2d ** 2 + F + M2 * G * cos * sin) \
            / (M1 + M2 * (1 - cos ** 2))
        q2dd = -(L * M2 * cos * sin * q2d ** 2 + F * cos
                 + (M1 + M2) * G * sin) \
            / (L * M1 + L * M2 * (1 - cos ** 2))
        return jnp.stack([q1d, q2d, q1dd, q2dd])

    problem = pycollo_tpu.OptimalControlProblem(name="Cart-Pole Swing-Up")
    phase = problem.new_phase(name="A")
    phase.state_variables = ("q1", "q2", "q1d", "q2d")
    phase.control_variables = ("F",)
    phase.state_equations = dynamics
    phase.integrand_functions = lambda y, u, t, s: u[:1] ** 2
    phase.number_integrand_functions = 1
    _set_bounds_and_guess(phase, T, d)
    problem.objective_function = lambda ep: ep.phase[0].q[0]
    return problem


if __name__ == "__main__":
    problem = build_problem()
    problem.initialise()
    solution = problem.solve()
    print(f"Objective (integral of F^2): {solution.objective:.6f}")
