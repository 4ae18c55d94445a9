"""Condensed-KKT Cholesky solver (``solver/linalg.py``) against numpy.

The interior-point solver factors the Jacobi-equilibrated condensed
matrix of every instance at six inertia levels at once, so the stacks
here have the shape of one vmapped solver call: (instances, levels, n, n)
with the benchmark's n = 148.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycollo_tpu.solver.linalg import make_spd_solver, positive_definite

SHAPE = (8, 6, 148, 148)
TOLERANCES = {"float64": 1e-10, "float32": 1e-3}


def _equilibrated(rng, shape, cond=1e4, indefinite=None):
    """Symmetric matrices with eigenvalues log-uniform in [1, cond],
    Jacobi-equilibrated; ``indefinite`` (an index into the leading
    dimensions) gets one negative eigenvalue."""
    *batch, n, _ = shape
    Q, _ = np.linalg.qr(rng.standard_normal((*batch, n, n)))
    lam = np.exp(rng.uniform(0.0, np.log(cond), (*batch, n)))
    if indefinite is not None:
        lam[indefinite + (0,)] = -1.0
    A = (Q * lam[..., None, :]) @ np.swapaxes(Q, -1, -2)
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    d = 1.0 / np.sqrt(np.abs(np.diagonal(A, axis1=-2, axis2=-1)))
    return A * d[..., :, None] * d[..., None, :]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_factor_solve_matches_numpy(dtype):
    rng = np.random.default_rng(0)
    A = _equilibrated(rng, SHAPE)
    b = rng.standard_normal(SHAPE[:-1])
    factor, diag, invert, solve = make_spd_solver()

    @jax.jit
    def run(A, b):
        L = factor(A)
        Linv = invert(L)
        return L, Linv, solve(Linv, b), positive_definite(diag(L))

    L, Linv, x, pd = run(jnp.asarray(A, dtype), jnp.asarray(b, dtype))
    L, Linv = np.asarray(L, np.float64), np.asarray(Linv, np.float64)
    x = np.asarray(x, np.float64)
    assert L.shape == Linv.shape == SHAPE and x.shape == SHAPE[:-1]
    assert np.asarray(pd).all()
    np.testing.assert_array_equal(L, np.tril(L))
    np.testing.assert_array_equal(Linv, np.tril(Linv))
    np.testing.assert_allclose(Linv @ L, np.broadcast_to(np.eye(SHAPE[-1]),
                                                         SHAPE),
                               atol=100 * np.finfo(dtype).eps)
    # Normwise backward error ||A x - b|| / (||A|| ||x|| + ||b||).
    r = np.einsum("...ij,...j->...i", A, x) - b
    norm_A = np.linalg.norm(A, ord=2, axis=(-2, -1))
    backward = np.linalg.norm(r, axis=-1) / (
        norm_A * np.linalg.norm(x, axis=-1) + np.linalg.norm(b, axis=-1))
    assert backward.max() <= TOLERANCES[dtype]
    x_ref = np.linalg.solve(A, b[..., None])[..., 0]
    forward = np.linalg.norm(x - x_ref, axis=-1) \
        / np.linalg.norm(x_ref, axis=-1)
    # Forward error is bounded by condition number x unit roundoff.
    assert forward.max() <= 1e4 * 10 * np.finfo(dtype).eps


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_indefinite_instance_flagged(dtype):
    """Inertia detection relies on a failed factorization showing up in
    the pivots: exactly the indefinite instance must be flagged."""
    rng = np.random.default_rng(1)
    bad = (3, 2)
    A = _equilibrated(rng, SHAPE, indefinite=bad)
    factor, diag, _, _ = make_spd_solver()
    pd = np.asarray(jax.jit(lambda A: positive_definite(diag(factor(A))))(
        jnp.asarray(A, dtype)))
    expected = np.ones(SHAPE[:2], bool)
    expected[bad] = False
    np.testing.assert_array_equal(pd, expected)


def test_nested_vmap_shapes():
    """The solver is called under two vmaps (instances, then levels) and
    with vector and matrix right-hand sides."""
    rng = np.random.default_rng(2)
    n = 12
    A = jnp.asarray(_equilibrated(rng, (3, 4, n, n)))
    b = jnp.asarray(rng.standard_normal((3, 4, n)))
    B = jnp.asarray(rng.standard_normal((3, 4, n, 2)))
    factor, diag, invert, solve = make_spd_solver()

    def one(A, b, B):
        L = factor(A)
        Linv = invert(L)
        return diag(L), solve(Linv, b), solve(Linv, B)

    piv, x, X = jax.jit(jax.vmap(jax.vmap(one)))(A, b, B)
    assert piv.shape == (3, 4, n)
    assert x.shape == (3, 4, n) and X.shape == (3, 4, n, 2)
    piv_s, x_s, X_s = one(A, b, B)
    np.testing.assert_allclose(x, x_s, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(X, X_s, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(piv, piv_s, rtol=1e-12)
    np.testing.assert_allclose(
        np.einsum("...ij,...j->...i", A, x), b, atol=1e-10)
