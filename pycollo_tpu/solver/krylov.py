"""Fixed-iteration right-preconditioned GMRES for the structured KKT path.

Why this exists: the block-banded arrowhead factorization
(``solver/banded.py``) is built from three nested Schur layers (banded
interior, dense border complement, Woodbury capacitance).  Near a
solution, the subtractive Schur updates cancel catastrophically in a few
border/low-rank directions and the *factored* operator drifts far from
the assembled one — measured on the batched cart-pole workload at a
near-converged iterate: the matvec ``kmul`` matches the dense condensed
matrix to 8e-15, yet plain iterative refinement with the factored solve
as the smoother diverges at ~150x per round (the iteration matrix
``I - Ktilde^-1 K`` has spectral radius ~150 in a handful of directions).
Richardson/IR cannot survive that; GMRES with the factorization as a
right preconditioner contracts those few outlier directions in as many
iterations and delivers f64-grade steps, which in turn keeps the
``1/dc``-amplified dual recovery ``dlam = Dinv (J dx + g~)`` clean.

Everything is static-shape and branch-free (fixed iteration count,
``lstsq`` on the small Hessenberg system), so it jits and vmaps like any
other kernel — the on-device equivalent of the iterative refinement
MUMPS performs inside the reference's IPOPT
(``/root/reference/pycollo/backend.py:1695-1711``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gmres_right(matvec, precond, rhs, iters: int):
    """Solve ``A x = rhs`` by right-preconditioned GMRES(iters).

    ``matvec(z) -> A @ z`` must be the EXACT operator; ``precond(r)``
    an approximate solve (applied on the right: A M^-1 y = rhs,
    x = M^-1 y).  Runs exactly ``iters`` Arnoldi steps (no early exit —
    static shapes for jit/vmap) and solves the (iters+1, iters)
    Hessenberg least-squares problem once at the end.  A breakdown
    (happy or otherwise) produces zero Krylov vectors which the final
    least-squares simply ignores.

    Returns the solution estimate ``x`` (same shape as ``rhs``).
    """
    n = rhs.shape[0]
    beta = jnp.linalg.norm(rhs)
    scale = jnp.where(beta > 0.0, beta, 1.0)
    v0 = rhs / scale

    def arnoldi(carry, k):
        V, H = carry
        v_k = V[k]
        w = matvec(precond(v_k))
        # Modified Gram-Schmidt against all previous basis vectors
        # (masked full-width: static shapes, k is a traced index).
        mask = (jnp.arange(iters + 1) <= k)[:, None]
        Vm = V * mask
        h = Vm @ w                      # (iters+1,)
        w = w - Vm.T @ h
        # one re-orthogonalization pass (cheap, fixes MGS drift)
        h2 = Vm @ w
        w = w - Vm.T @ h2
        h = h + h2
        nrm = jnp.linalg.norm(w)
        h = h.at[k + 1].set(nrm)
        v_next = jnp.where(nrm > 1e-300, w / jnp.maximum(nrm, 1e-300),
                           jnp.zeros_like(w))
        V = V.at[k + 1].set(v_next)
        H = H.at[:, k].set(h)
        return (V, H), None

    V0 = jnp.zeros((iters + 1, n), rhs.dtype).at[0].set(v0)
    H0 = jnp.zeros((iters + 1, iters), rhs.dtype)
    (V, H), _ = jax.lax.scan(arnoldi, (V0, H0), jnp.arange(iters))

    e1 = jnp.zeros(iters + 1, rhs.dtype).at[0].set(1.0)
    # Ridge-regularized normal equations instead of ``lstsq``: the
    # (iters+1, iters) Hessenberg system is tiny and benign (columns
    # come from an orthonormal Arnoldi basis); zero columns from a
    # breakdown are handled by the ridge, which then selects the
    # minimum-norm coefficient as lstsq would.  It squares the
    # Hessenberg condition number (Givens rotations would not).
    HtH = H.T @ H
    ridge = 100.0 * jnp.finfo(rhs.dtype).eps ** 2 \
        * (1.0 + jnp.trace(HtH))
    # The ridged normal-equations matrix is SPD by construction.
    L = jnp.linalg.cholesky(HtH + ridge * jnp.eye(iters,
                                                  dtype=rhs.dtype))
    y = jax.scipy.linalg.cho_solve((L, True), H.T @ e1)
    # No finiteness guard here: callers are responsible for checking
    # isfinite on the returned step (all of them do).
    return precond(V[:iters].T @ y) * scale
