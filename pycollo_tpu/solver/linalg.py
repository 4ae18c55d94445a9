"""Batched dense Cholesky for the condensed-space KKT solves.

This is the dense-KKT workhorse of the condensed-space interior point
solver, in place of the reference's MUMPS factorization inside IPOPT
(``pycollo/backend.py:1695-1711``).  It is plain XLA: the batched
factorization goes to cuSOLVER on a GPU and to LAPACK on the CPU.

The solver factors every inertia level of every instance, selects one
level per instance, and then solves with it several times (about 4 times
per factorization on the f64 path, about 18 on the mixed path's GMRES).
So the selected factor is inverted once and every solve is two
matrix-vector products.  On an NVIDIA H100 80GB HBM3 at a 400 W power
limit, end to end on the batched cart-pole cell, this spelling gave
+19% solves/s on the f64 path and +142% on the mixed path over
``cho_solve`` substitutions (``PERF.md``, PR 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def make_spd_solver():
    """Return ``(factor, diag, invert, solve)`` for stacks of SPD matrices.

    ``factor(A)`` takes ``(..., n, n)`` and gives the lower Cholesky
    factor ``L``; ``diag(L)`` gives its ``(..., n)`` pivots;
    ``invert(L)`` gives ``L^-1``, once per factor that is solved with;
    ``solve(Linv, rhs)`` takes a right-hand side ``(..., n)`` or
    ``(..., n, k)`` and costs two matrix products.  A matrix that is not
    positive definite factors to NaN (JAX replaces the factor of a
    failed ``potrf`` with NaN on every backend), which
    :func:`positive_definite` detects from the pivots.
    """

    def factor(A):
        return jnp.linalg.cholesky(A)

    def diag(L):
        return jnp.diagonal(L, axis1=-2, axis2=-1)

    def invert(L):
        eye = jnp.broadcast_to(jnp.eye(L.shape[-1], dtype=L.dtype), L.shape)
        return jax.scipy.linalg.solve_triangular(L, eye, lower=True)

    def solve(Linv, rhs):
        vec = rhs.ndim == Linv.ndim - 1
        r = rhs[..., None] if vec else rhs
        x = jnp.swapaxes(Linv, -1, -2) @ (Linv @ r)
        return x[..., 0] if vec else x

    return factor, diag, invert, solve


def positive_definite(pivots):
    """True where every pivot of a Cholesky factor is finite and positive.

    ``pivots``: ``(..., n)`` from ``diag``.  On a Jacobi-equilibrated
    matrix a healthy pivot is O(1), so a small floor is meaningful: in
    float32 a failed pivot can round to exactly zero instead of NaN.
    """
    floor = 1e-16 if pivots.dtype == jnp.float32 else 1e-100
    return jnp.all(jnp.isfinite(pivots), axis=-1) \
        & ~jnp.any(pivots < floor, axis=-1)
