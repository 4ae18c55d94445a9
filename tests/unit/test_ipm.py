"""Interior-point solver unit tests on analytic NLPs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycollo_tpu.solver.ipm import IPMOptions, build_ipm_solver

EMPTY = jnp.zeros(0)


def test_hs071():
    """Hock-Schittkowski 71 (the canonical IPOPT test problem)."""
    def f(x, theta):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def c(x, theta):
        return jnp.array([x[0] * x[1] * x[2] * x[3],
                          x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2])

    solve = build_ipm_solver(f, c, np.ones(4), 5 * np.ones(4),
                             np.array([25.0, 40.0]),
                             np.array([1e19, 40.0]),
                             IPMOptions(tol=1e-8, max_iter=100))
    res = jax.jit(solve)(jnp.array([1.0, 5.0, 5.0, 1.0]), EMPTY)
    assert bool(res.converged)
    assert int(res.iterations) < 30
    np.testing.assert_allclose(
        np.array(res.x), [1.0, 4.74299963, 3.82114998, 1.37940829],
        rtol=1e-6)
    np.testing.assert_allclose(float(res.f), 17.0140173, rtol=1e-7)


def test_equality_constrained_qp():
    """min x'x s.t. sum(x) = 1 -> x = 1/n."""
    n = 8

    def f(x, theta):
        return jnp.sum(x ** 2)

    def c(x, theta):
        return jnp.array([jnp.sum(x)])

    solve = build_ipm_solver(f, c, -10 * np.ones(n), 10 * np.ones(n),
                             np.array([1.0]), np.array([1.0]),
                             IPMOptions(tol=1e-9, max_iter=50))
    res = jax.jit(solve)(jnp.zeros(n), EMPTY)
    assert bool(res.converged)
    np.testing.assert_allclose(np.array(res.x), np.full(n, 1.0 / n),
                               atol=1e-8)


def test_bound_constrained():
    """min (x-3)^2 with x <= 2 -> x = 2, active bound."""
    def f(x, theta):
        return (x[0] - 3.0) ** 2

    def c(x, theta):
        return jnp.zeros(0)

    solve = build_ipm_solver(f, c, np.array([-5.0]), np.array([2.0]),
                             np.zeros(0), np.zeros(0),
                             IPMOptions(tol=1e-8, max_iter=50))
    res = jax.jit(solve)(jnp.array([0.0]), EMPTY)
    assert bool(res.converged)
    np.testing.assert_allclose(float(res.x[0]), 2.0, atol=1e-7)


def test_inequality_constraint_active():
    """min x1+x2 s.t. x1^2 + x2^2 <= 2, x free -> x = (-1,-1)."""
    def f(x, theta):
        return x[0] + x[1]

    def c(x, theta):
        return jnp.array([x[0] ** 2 + x[1] ** 2])

    solve = build_ipm_solver(f, c, -10 * np.ones(2), 10 * np.ones(2),
                             np.array([-1e19]), np.array([2.0]),
                             IPMOptions(tol=1e-8, max_iter=60))
    res = jax.jit(solve)(jnp.array([0.5, 0.5]), EMPTY)
    assert bool(res.converged)
    np.testing.assert_allclose(np.array(res.x), [-1.0, -1.0], atol=1e-6)


def test_theta_parameterization_and_vmap():
    """Batched solves over a perturbed constraint right-hand side."""
    def f(x, theta):
        return jnp.sum(x ** 2)

    def c(x, theta):
        return jnp.array([jnp.sum(x) - theta[0]])

    n = 4
    solve = build_ipm_solver(f, c, -10 * np.ones(n), 10 * np.ones(n),
                             np.array([0.0]), np.array([0.0]),
                             IPMOptions(tol=1e-9, max_iter=50))
    thetas = jnp.linspace(0.5, 2.0, 16)[:, None]
    x0 = jnp.zeros((16, n))
    res = jax.jit(jax.vmap(solve))(x0, thetas)
    assert bool(res.converged.all())
    np.testing.assert_allclose(np.array(res.x),
                               np.array(thetas) / n * np.ones((1, n)),
                               atol=1e-8)


def test_nonconvex_needs_regularization():
    """Concave objective in a box: solver must still converge to a
    bound-constrained stationary point via inertia correction."""
    def f(x, theta):
        return -jnp.sum((x - 0.3) ** 2)

    def c(x, theta):
        return jnp.zeros(0)

    solve = build_ipm_solver(f, c, np.zeros(3), np.ones(3),
                             np.zeros(0), np.zeros(0),
                             IPMOptions(tol=1e-8, max_iter=80))
    res = jax.jit(solve)(jnp.array([0.4, 0.45, 0.55]), EMPTY)
    assert bool(res.converged)
    # Each coordinate must end at a bound (0 or 1).
    x = np.array(res.x)
    assert np.all((x < 1e-6) | (x > 1 - 1e-6))


def test_feasibility_restoration_mechanism():
    """Wachter-Biegler counterexample (the IPOPT paper's motivating
    failure case for line-search IPMs): min x1 s.t. x1^2 - x2 - 1 = 0,
    x1 - x3 - 0.5 = 0, x2 >= 0, x3 >= 0 from (-2, 3, 1).

    The feasibility problem itself has a local infeasibility minimizer
    on this side of the theta-barrier at x1 = 0, so no gradient-based
    method can reach the feasible set from here; the correct behavior
    (IPOPT's too) is to drive the violation to a local stationary value
    instead of thrashing.  The test asserts the restoration phase
    engages and achieves the locally-minimal violation ~1.5
    (= theta at x1 = -1) rather than the line-search stall value."""
    def f(x, theta):
        return x[0]

    def c(x, theta):
        return jnp.array([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5])

    xl = np.array([-1e20, 0.0, 0.0])
    xu = np.array([1e20, 1e20, 1e20])
    x0 = jnp.asarray(np.array([-2.0, 3.0, 1.0]))
    solve = build_ipm_solver(f, c, xl, xu, np.zeros(2), np.zeros(2),
                             IPMOptions(tol=1e-8, max_iter=150,
                                        restoration=True))
    res = jax.jit(solve)(x0, EMPTY)
    th = float(jnp.sum(jnp.abs(c(res.x, EMPTY))))
    # Locally-minimal violation is 1.5 at (x1, x2, x3) = (-1, 0, 0).
    assert th < 1.75, th
    assert abs(float(res.x[0]) - (-1.0)) < 0.35, np.asarray(res.x)


def _dot_generals(jaxpr):
    """Every dot_general equation of a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for param in eqn.params.values():
            for sub in (param if isinstance(param, (list, tuple))
                        else (param,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    yield from _dot_generals(sub)


def test_mixed_path_traces_f32_matmuls_at_highest_precision():
    """A GPU may run an f32 matmul at default precision in TF32; every
    f32 matmul the mixed path traces, through both entry points, must
    ask for the highest precision."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parents[2] / "examples"))
    from cart_pole_swing_up import build_functional_problem

    problem = build_functional_problem()
    problem.settings.console_out_progress = False
    problem.phases[0].mesh.number_mesh_sections = 2
    problem.initialise()
    it = problem.backend.mesh_iterations[0]
    solver = it.build_solver(IPMOptions(
        tol=1e-6, max_iter=5, kkt_precision="mixed", dc_floor=1e-7,
        eval_dtype="f32"))
    x0 = jnp.asarray(it.xs_guess)
    theta = jnp.asarray(it.theta_default)
    cold = jax.make_jaxpr(solver)(x0, theta)
    m = it.layout.m_total
    warm = jax.make_jaxpr(solver.warm)(
        x0, theta, jnp.zeros(m), jnp.ones(it.n_free), jnp.ones(it.n_free),
        jnp.asarray(1e-3))
    for closed in (cold, warm):
        f32 = [e for e in _dot_generals(closed.jaxpr)
               if any(v.aval.dtype == jnp.float32 for v in e.invars)]
        assert f32, "the mixed path traced no f32 matmul"
        for eqn in f32:
            assert eqn.params["precision"] == (
                jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST), eqn
